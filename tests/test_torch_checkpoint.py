"""The port's checkpoint store (``checkpoint/store.py``): the cases of
tests/test_checkpoint.py on the port's format (zlib streams of raw leaf
bytes, a JSON manifest with the shard's SHA-256): a bit-exact round trip,
bfloat16 kept, a corrupt or manifest-less checkpoint skipped, async saves
with retention, the template's structure (an ``AdamState`` too), a save
that copies the tree before the caller updates it in place, and a failed
save leaving no partial directory behind."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.checkpoint.store import (  # noqa: E402
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.optim.adam import AdamConfig, adam_init  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@pytest.fixture
def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
              "d": torch.tensor(7, dtype=torch.int32)},
    }


def test_roundtrip_bitexact(tmp_path, tree):
    save_checkpoint(str(tmp_path), 5, tree)
    step, restored = restore_checkpoint(str(tmp_path), template=tree)
    assert step == 5
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_bfloat16_preserved(tmp_path):
    t = {"w": (torch.arange(7, dtype=torch.float32) * 0.3).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 0, t)
    _, r = restore_checkpoint(str(tmp_path), template=t)
    assert r["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["w"].view(torch.int16).numpy(),
                                  r["w"].view(torch.int16).numpy())
    manifest = json.load(open(os.path.join(str(tmp_path), "step_000000000", "MANIFEST.json")))
    assert [rec["dtype"] for rec in manifest["leaves"]] == ["bfloat16"]


def test_latest_skips_corrupt(tmp_path, tree):
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 2, tree)
    # corrupt step 2's shard: latest must fall back to step 1
    shard = os.path.join(str(tmp_path), "step_000000002", "shard_00000.ckpt")
    with open(shard, "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00\x00\x00")
    assert latest_step(str(tmp_path)) == 1
    step, _ = restore_checkpoint(str(tmp_path), template=tree)
    assert step == 1
    with pytest.raises(ValueError, match="manifest"):
        restore_checkpoint(str(tmp_path), step=2, template=tree)


def test_missing_manifest_invalid(tmp_path, tree):
    save_checkpoint(str(tmp_path), 3, tree)
    os.remove(os.path.join(str(tmp_path), "step_000000003", "MANIFEST.json"))
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path))


def test_manager_async_and_retention(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=False)
    mgr.wait()
    steps = sorted(int(n[5:]) for n in os.listdir(str(tmp_path)) if n.startswith("step_"))
    assert steps == [3, 4]
    got = mgr.restore_latest(tree)
    assert got is not None and got[0] == 4


def test_restore_template_structure(tmp_path, tree):
    state = {"params": tree, "opt": adam_init(tree["b"], AdamConfig())}
    save_checkpoint(str(tmp_path), 0, state)
    _, r = restore_checkpoint(str(tmp_path), template=state)
    assert set(r) == {"params", "opt"} and type(r["opt"]) is type(state["opt"])
    assert set(r["params"]["b"]) == {"c", "d"} and set(r["opt"].mu) == {"c", "d"}
    assert int(r["opt"].step) == 0 and r["opt"].step.dtype == torch.int32
    flat = restore_checkpoint(str(tmp_path))[1]
    assert "params/b/c" in flat and "opt/mu/c" in flat


def test_async_save_copies_before_in_place_updates(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path))
    want = tree["a"].clone()
    mgr.save(1, tree, blocking=False)
    tree["a"].add_(100.0)  # the train step updates its tensors in place
    mgr.wait()
    assert torch.equal(restore_checkpoint(str(tmp_path), template=tree)[1]["a"], want)


def test_failed_save_leaves_nothing(tmp_path, tree, monkeypatch):
    def boom(_t):
        raise OSError("disk full")

    monkeypatch.setattr(store, "_compress", boom)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert os.listdir(str(tmp_path)) == []
    assert latest_step(str(tmp_path)) is None
