"""Gradient clipping; port of ``repro/optim/clip.py``.

The global norm is the reference's: each leaf's sum of float32 squares,
then the sum of those over the leaves in ``tree.leaves`` order (the
reference's leaf order), then the square root. A leaf larger than
``adam.SLICE_ELEMS`` is summed slice by slice (``adam.leading_slices``):
its float32 square is never held whole.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adam import leading_slices
from repro_torch.tree import leaves, map_leaves

F32 = torch.float32
Tree = Any


@torch.no_grad()
def sum_squares(l: torch.Tensor) -> torch.Tensor:
    """A leaf's float32 sum of squares, slice by slice."""
    parts = [torch.sum(torch.square(l[sl].to(F32))) for sl in leading_slices(l)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


@torch.no_grad()
def norm_of(leaf_sums: list) -> torch.Tensor:
    """The global norm from the leaves' sums of squares, in leaf order."""
    return torch.sqrt(torch.sum(torch.stack(leaf_sums)))


@torch.no_grad()
def global_norm(tree: Tree) -> torch.Tensor:
    return norm_of([sum_squares(l) for l in leaves(tree)])


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(norm, 1e-12))``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


@torch.no_grad()
def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """(tree scaled by ``clip_scale`` in float32 and cast back to each
    leaf's dtype, norm)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return map_leaves(lambda _p, l: (l.to(F32) * scale).to(l.dtype), tree), norm
