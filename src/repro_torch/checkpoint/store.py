"""Atomic, async checkpointing over torch tensors (the JAX package's
``checkpoint/store.py``, with its on-disk layout and leaf names: a
checkpoint written by either package restores in the other).

* **atomic** — a step directory is written under ``<root>/tmp-<step>`` and
  ``os.rename``d into place only after every leaf + manifest is on disk;
  a crash mid-write never corrupts the latest checkpoint.
* **async** — ``CheckpointManager.save`` copies the tree to host memory
  (blocking only for the copy) and writes in a background thread;
  training proceeds, and may update the state in place, during
  serialization. ``wait()`` joins the writer and re-raises its error.
* **retention** — keeps the last ``keep`` checkpoints; GC never touches
  the newest.

Leaves are named by their dict path joined with ``/``
(``params/dec_layers/attn/wq``, ``opt/m/...``, ``opt/step``) and numbered
in sorted key order, as ``jax.tree_util`` flattens a dict. bfloat16 and
the float8 types, which numpy cannot store, are written as same-width
unsigned views with the logical dtype in the manifest. Arrays are stored
whole; ``restore_checkpoint`` places each leaf on the device of the
matching leaf of ``like`` (or on ``device``).

Layout::

    <root>/step-000123/
        manifest.json          # step, leaf index, shapes/dtypes, config note
        arr-00000.npy ...      # one .npy per leaf (np.save, mmap-able)
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

# logical dtype name -> (torch dtype, the unsigned view it is stored as)
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
           "float8_e5m2": (torch.float8_e5m2, torch.uint8)}


def _flatten_with_names(tree: Any, prefix: str = "") -> list:
    """[(path name, leaf)] of a nested dict / list / tuple, dict keys in
    sorted order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_names(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten_like(like: Any, leaves: dict, prefix: str = "") -> Any:
    """``like``'s structure (its key order too) with each leaf replaced
    by ``leaves[its path name]``."""
    if isinstance(like, dict):
        items = like.items()
    elif isinstance(like, (list, tuple)):
        items = enumerate(like)
    else:
        return leaves[prefix]
    out = [(k, _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix
                               else str(k))) for k, v in items]
    if isinstance(like, dict):
        return dict(out)
    return type(like)(v for _, v in out)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to write, logical dtype name) of a host tensor."""
    name = str(t.dtype).removeprefix("torch.")
    if name in _EXOTIC:
        t = t.view(_EXOTIC[name][1])
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(arr, order="C"))
    if name in _EXOTIC:
        t = t.view(_EXOTIC[name][0])
    return t


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step-{step:09d}")


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(root)
             if d.startswith("step-") and
             os.path.exists(os.path.join(root, d, "manifest.json"))]
    return max(steps) if steps else None


def _host(leaf) -> torch.Tensor:
    """A host copy of ``leaf`` that later in-place updates of the leaf do
    not reach (``.cpu()`` of a CPU tensor would be the tensor itself)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.as_tensor(np.asarray(leaf))


def save_checkpoint(root: str, step: int, tree: Any,
                    note: str = "") -> str:
    """Synchronous atomic save of a tree of tensors (or numpy arrays)."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"tmp-{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = []
    for i, (name, leaf) in enumerate(_flatten_with_names(tree)):
        t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) \
            else _host(leaf)
        arr, dtype_name = _to_numpy(t)
        fname = f"arr-{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index.append({"name": name, "file": fname,
                      "shape": list(arr.shape), "dtype": dtype_name})
    manifest = {"step": step, "note": note, "leaves": index}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = _step_dir(root, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic publish
    return final


def restore_checkpoint(root: str, like: Any, step: Optional[int] = None,
                       device=None) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf on ``device``,
    else on the device of ``like``'s leaf of the same name. Returns
    (tree, step)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    out = {}
    for name, proto in _flatten_with_names(like):
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint {d} missing leaf {name!r}")
        t = _from_numpy(np.load(os.path.join(d, entry["file"])),
                        entry["dtype"])
        want = tuple(proto.shape) if hasattr(proto, "shape") else None
        if want is not None and tuple(t.shape) != want:
            raise ValueError(
                f"leaf {name!r}: checkpoint shape {tuple(t.shape)} != {want}")
        dev = device if device is not None else getattr(proto, "device",
                                                         "cpu")
        out[name] = t.to(dev)
    return _unflatten_like(like, out), step


def _gc(root: str, keep: int) -> None:
    if keep <= 0 or not os.path.isdir(root):
        return
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(root)
                   if d.startswith("step-"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def _snapshot(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return _host(tree)


class CheckpointManager:
    """Async writer with retention. One in-flight save at a time (a newer
    save waits for the previous write to land, preserving ordering)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, note: str = "") -> None:
        self.wait()
        # snapshot to host *before* returning so training can mutate state
        host = _snapshot(tree)

        def write():
            try:
                save_checkpoint(self.root, step, host, note)
                _gc(self.root, self.keep)
            except BaseException as e:     # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, like: Any, step: Optional[int] = None,
                device=None) -> tuple[Any, int]:
        self.wait()
        return restore_checkpoint(self.root, like, step, device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.root)
