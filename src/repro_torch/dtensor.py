"""The DTensor type check that the optimiser, the checkpoint store and
the kernel dispatch share. It imports nothing of the port, so those
layers do not depend on ``repro_torch.parallel``."""

from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``. A plain
    tensor is told apart without importing DTensor."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local(x):
    """A DTensor's local shard; any other value as it is."""
    return x.to_local() if is_dtensor(x) else x
