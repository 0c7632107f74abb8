"""Hot-path programs of the port as aten-level op traces (the
counterpart of the JAX package's ``staticcheck/jaxpr_utils.py``).

The reference reasons over a jaxpr and its lowered StableHLO. The port's
hot path is eager PyTorch, or a CUDA graph captured from the same eager
code, so its "program" is the sequence of aten ops one call of a
hot-path function dispatches, recorded with a ``TorchDispatchMode``.
Each ``Node`` keeps the op's name, the dtype, shape, device and storage
of each tensor it takes and returns, which of its arguments it writes
(the schema's alias annotation) and whether it only views an input
(every output on an input's storage).

A kernel call (``kernels.api.kernel_call``: a dispatched op with a
kernel of its own, or the paged decode op's call of its tier's kernel)
is **one node**, ``kernel:<op>``, whatever runs inside it. On the card
its launch goes through ``ctypes`` and dispatches nothing; on the CPU
the ops of its plain version run inside it and are recorded with
``kernel`` set to the op, so a check can judge them (host syncs) or
leave them to the kernel they stand for (dtype planes). Torch ops that
run on the card in both cases (the paged gathers, the bf16 decode
attention, norms, the MoE combine) stay ordinary nodes.

Tracing executes the function, unlike the reference's ``jitted.trace``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import api
from repro_torch.quantize import QTENSORS

#: dtypes a cache plane or a weight is stored in
STORAGE_DTYPES = ("int8", "uint8", "bfloat16", "float16")


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    dtype: str            # "bfloat16", "int8", ...
    shape: tuple
    device: str           # "cpu", "cuda", ...: the device type
    storage: int          # data pointer of the tensor's storage

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * getattr(torch, self.dtype).itemsize


def meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(dtype=str(t.dtype).removeprefix("torch."),
                      shape=tuple(t.shape), device=t.device.type,
                      storage=t.untyped_storage().data_ptr())


def tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nest of lists, tuples, dicts and quantized
    tensors, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, QTENSORS):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)


@dataclasses.dataclass(frozen=True)
class Node:
    op: str                    # "aten.index_put_.default", "kernel:q8_matmul"
    inputs: tuple              # TensorMeta of each tensor argument
    outputs: tuple             # TensorMeta of each returned tensor
    writes: tuple = ()         # indices into ``inputs`` the op writes
    view: bool = False         # every output shares an input's storage,
                               # none written: no byte moves
    kernel: str = ""           # the kernel call this op ran inside
    kwargs: tuple = ()         # the names of the keyword arguments given

    @property
    def is_kernel(self) -> bool:
        return self.op.startswith("kernel:")


def _node(func, args, kwargs, out, kernel: str) -> Node:
    inputs, writes = [], []
    schema = func._schema
    named = dict(zip((a.name for a in schema.arguments), args))
    named.update(kwargs)
    for arg in schema.arguments:
        ts = list(tensors(named.get(arg.name)))
        if arg.alias_info is not None and arg.alias_info.is_write:
            writes.extend(range(len(inputs), len(inputs) + len(ts)))
        inputs.extend(meta(t) for t in ts)
    outputs = tuple(meta(t) for t in tensors(out))
    storages = {t.storage for t in inputs}
    view = bool(outputs) and not writes \
        and all(t.storage in storages for t in outputs)
    return Node(op=str(func), inputs=tuple(inputs), outputs=outputs,
                writes=tuple(writes), view=view, kernel=kernel,
                kwargs=tuple(sorted(kwargs)))


class Tracer(TorchDispatchMode):
    """Records every aten op dispatched while it is entered, and every
    kernel call (``kernel_hook``) as one node around the ops it ran."""

    def __init__(self):
        super().__init__()
        self.nodes: list[Node] = []
        self._kernel = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.nodes.append(_node(func, args, kwargs, out, self._kernel))
        return out

    def kernel(self, name: str, fn: Callable, args: tuple, kwargs: dict):
        if self._kernel:       # a wrapper's own call of another wrapper
            return fn(*args, **kwargs)
        self._kernel = name
        try:
            out = fn(*args, **kwargs)
        finally:
            self._kernel = ""
        self.nodes.append(Node(
            op=f"kernel:{name}",
            inputs=tuple(meta(t) for t in tensors((args, kwargs))),
            outputs=tuple(meta(t) for t in tensors(out))))
        return out


def trace_call(fn: Callable, *args, **kwargs) -> tuple[Any, list[Node]]:
    """Run ``fn(*args, **kwargs)`` without autograd and return (its
    result, the nodes it dispatched)."""
    tracer = Tracer()
    with torch.no_grad(), tracer, api.kernel_hook(tracer.kernel):
        out = fn(*args, **kwargs)
    return out, tracer.nodes
