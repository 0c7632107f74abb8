"""The port's checkpoint store: the reference's own checkpoint tests
(``tests/test_checkpoint.py``) on torch tensors, and checkpoints that
cross between the packages: a tree of f32, bf16 and int32 leaves written
by the reference restores in the port bit for bit, and the other way
round, under the same leaf names (``params/...``, ``opt/m/...``,
``opt/step``)."""

import json
import os
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          restore_checkpoint, save_checkpoint)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: with torch's intra-op threads one per core
    in every test worker, they wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(v=0.0):
    return {"a": torch.full((4, 4), v), "b": {"c": torch.arange(6.0),
                                              "step": torch.tensor(3)}}


def test_save_restore_roundtrip(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 7, _tree(1.5))
    out, step = restore_checkpoint(root, _tree())
    assert step == 7
    np.testing.assert_array_equal(out["a"].numpy(), np.full((4, 4), 1.5))
    np.testing.assert_array_equal(out["b"]["c"].numpy(), np.arange(6.0))
    assert int(out["b"]["step"]) == 3


def test_atomic_no_tmp_left(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree())
    assert not [d for d in os.listdir(root) if d.startswith("tmp-")]


def test_latest_step_and_retention(tmp_path):
    root = str(tmp_path)
    mgr = CheckpointManager(root, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    mgr.wait()
    assert mgr.latest_step() == 4
    kept = sorted(d for d in os.listdir(root) if d.startswith("step-"))
    assert len(kept) == 2 and kept[-1].endswith("4".zfill(9))


def test_async_writer_overlaps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1.0))
    assert isinstance(mgr._thread, threading.Thread)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 1


def test_async_save_snapshots_before_returning(tmp_path):
    """A save copies the state first: an in-place update right after it
    (AdamW's) does not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree(1.0)
    mgr.save(1, tree)
    tree["a"].add_(5.0)
    mgr.wait()
    out, _ = mgr.restore(_tree())
    np.testing.assert_array_equal(out["a"].numpy(), np.full((4, 4), 1.0))


def test_wait_reraises_the_writer_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker / "ckpt"), keep=3)
    mgr.save(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()   # the error is raised once


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), _tree())


def test_restore_missing_leaf_raises(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree())
    with pytest.raises(KeyError):
        restore_checkpoint(root, {**_tree(), "extra": torch.zeros(2)})


def test_restore_shape_mismatch_raises(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree())
    bad = {"a": torch.zeros((2, 2)), "b": {"c": torch.zeros(6),
                                           "step": torch.tensor(0)}}
    with pytest.raises(ValueError):
        restore_checkpoint(root, bad)


def test_corrupt_partial_dir_ignored(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 3, _tree())
    os.makedirs(os.path.join(root, "step-000000009"))
    assert latest_step(root) == 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2, torch.int32,
                                   torch.float16])
def test_restore_preserves_dtypes(tmp_path, dtype):
    root = str(tmp_path)
    w = (torch.arange(-8, 8, dtype=torch.float32) / 4).reshape(4, 4)
    tree = {"w": w.to(dtype), "n": torch.tensor(5, dtype=torch.int32)}
    save_checkpoint(root, 1, tree)
    out, _ = restore_checkpoint(root, tree)
    assert out["w"].dtype == dtype and out["n"].dtype == torch.int32
    assert torch.equal(out["w"].view(torch.uint8),
                       tree["w"].view(torch.uint8))


def test_restore_places_leaves_on_the_device_asked(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 1, _tree(2.0))
    out, _ = restore_checkpoint(root, _tree(), device="meta")
    assert out["a"].device.type == "meta"
    out, _ = restore_checkpoint(root, _tree())
    assert out["a"].device.type == "cpu"


# ----------------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------------

def _mixed_numpy(seed=0):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((2, 4)).astype(ml_dtypes.bfloat16)
    return {"params": {"dec_layers": {"attn": {"wq": f32}},
                       "embed": {"table": bf}},
            "opt": {"m": {"dec_layers": {"attn": {"wq": f32 * 0.5}},
                          "embed": {"table": bf.astype(np.float32)}},
                    "step": np.asarray(12, np.int32)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _torch_dtype(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.bfloat16
    return torch.from_numpy(a.copy()).dtype


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    root = str(tmp_path)
    tree = _mixed_numpy()
    j_store.save_checkpoint(root, 12, {k: _jnp(v) for k, v in tree.items()})
    like = _to_torch(_mixed_numpy(seed=1))
    out, step = restore_checkpoint(root, like)
    assert step == 12
    want, got = _flat(tree), _flat(out)
    assert sorted(want) == sorted(got)
    for name in want:
        assert got[name].dtype == _torch_dtype(want[name]), name
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    root = str(tmp_path)
    tree = _to_torch(_mixed_numpy())
    save_checkpoint(root, 5, tree)
    with open(os.path.join(root, "step-000000005", "manifest.json")) as f:
        names = [e["name"] for e in json.load(f)["leaves"]]
    # the reference's leaf names, in its order (sorted dict keys)
    assert names == ["opt/m/dec_layers/attn/wq", "opt/m/embed/table",
                     "opt/step", "params/dec_layers/attn/wq",
                     "params/embed/table"]
    out, step = j_store.restore_checkpoint(root, _jnp(_mixed_numpy(seed=1)))
    assert step == 5
    want, got = _flat(tree), _flat(out)
    for name in want:
        assert np.asarray(got[name]).dtype == np.asarray(
            _flat(_mixed_numpy())[name]).dtype, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]))
