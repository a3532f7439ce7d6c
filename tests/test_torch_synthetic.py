"""Port vs reference: the synthetic datasets of the paper-validation
experiments (``data/synthetic.py``). numpy only on both sides, the same
code: every array equal bit for bit, over seeds and sizes."""
import numpy as np
import pytest

from repro.data import synthetic as jsynthetic
from repro_torch.data import synthetic

CASES = [
    ("make_image_dataset", 5, dict(seed=0)),
    ("make_image_dataset", 12, dict(seed=5, size=16)),
    ("make_image_dataset", 4, dict(seed=3, size=10, n_classes=4)),
    ("make_entailment_dataset", 9, dict(seed=0)),
    ("make_entailment_dataset", 16, dict(seed=2, vocab=40, seq_len=12)),
    ("make_tabular_dataset", 32, dict(seed=0)),
    ("make_tabular_dataset", 50, dict(seed=7, dim=12, n_classes=3, depth=2)),
]


@pytest.mark.parametrize("maker,n,kw", CASES, ids=[f"{m}-{n}" for m, n, _ in CASES])
def test_makers_equal_the_reference(maker, n, kw):
    got = getattr(synthetic, maker)(n, **kw)
    want = getattr(jsynthetic, maker)(n, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
