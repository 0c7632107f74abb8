"""Hot-path programs of the port as aten-level op traces (the
counterpart of the JAX package's ``staticcheck/jaxpr_utils.py``).

The reference reasons over a jaxpr and its lowered StableHLO. The port's
hot path is eager PyTorch, or a CUDA graph captured from the same eager
code, so its "program" is the sequence of aten ops one call of a
hot-path function dispatches, recorded with a ``TorchDispatchMode``.
Each ``Node`` keeps the op's name, the dtype, shape, device and storage
of each tensor it takes and returns, which of its arguments it writes
(the schema's alias annotation) and whether it only views an input
(every output on an input's storage), and ``Node.moved_bytes`` is the
one rule for the bytes an op moves (SC-FOOT's and ``analysis.cost``'s).
A DTensor op is recorded as the ops it runs on its local tensors.

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
import functools
import sys
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
    storage: int          # identity of the tensor's storage (its
                          # StorageImpl: fake tensors have no data)

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * getattr(torch, self.dtype).itemsize


@functools.cache
def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def meta(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(dtype=_dtype_name(t.dtype), shape=tuple(t.shape),
                      device=t.device.type,
                      storage=t.untyped_storage()._cdata)


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
    site: str = ""             # "module:function" of the port that issued
                               # it (``Tracer(sites=True)``)

    @property
    def is_kernel(self) -> bool:
        return self.op.startswith("kernel:")

    @property
    def moved_bytes(self) -> int:
        """The bytes the op reads and writes in memory: those of the
        tensors it takes and returns; none for a view, a primitive, or a
        collective (whose operand bytes cross the interconnect)."""
        if self.view or self.op.startswith(("prim.", "_c10d_functional.")):
            return 0
        return sum(t.nbytes for t in self.inputs + self.outputs)


def site() -> str:
    """``module:function`` of the innermost frame of the port outside
    the tracing and the kernel dispatch: the code that issued an op."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith("repro_torch.") and not name.startswith(
                ("repro_torch.analysis", "repro_torch.kernels",
                 "repro_torch.staticcheck")):
            return f"{name.removeprefix('repro_torch.')}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


@functools.cache
def _wrappers() -> tuple:
    """Tensor subclasses whose ops are recorded on their local tensors."""
    try:
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor
    except ImportError:          # a torch built without distributed
        return ()
    return (DTensor, AsyncCollectiveTensor)


@functools.cache
def _schema(func) -> tuple:
    """(the op's name, ((argument name, written), ...)) of ``func``."""
    return str(func), tuple(
        (a.name, a.alias_info is not None and a.alias_info.is_write)
        for a in func._schema.arguments)


def _node(func, args, kwargs, out, kernel: str, where: str = "") -> Node:
    inputs, writes = [], []
    op, arguments = _schema(func)
    for i, (name, written) in enumerate(arguments):
        v = args[i] if i < len(args) else kwargs.get(name)
        ts = (v,) if isinstance(v, torch.Tensor) else list(tensors(v))
        if written:
            writes.extend(range(len(inputs), len(inputs) + len(ts)))
        inputs.extend(meta(t) for t in ts)
    outputs = tuple(meta(t) for t in tensors(out))
    storages = {t.storage for t in inputs}
    view = bool(outputs) and not writes \
        and all(t.storage in storages for t in outputs)
    return Node(op=op, inputs=tuple(inputs), outputs=outputs,
                writes=tuple(writes), view=view, kernel=kernel,
                kwargs=tuple(sorted(kwargs)), site=where)


def kernel_node(name: str, args: tuple, kwargs: dict, out,
                where: str = "") -> Node:
    """The one node of a kernel call of the op ``name``."""
    return Node(op=f"kernel:{name}",
                inputs=tuple(meta(t) for t in tensors((args, kwargs))),
                outputs=tuple(meta(t) for t in tensors(out)), site=where)


class Tracer(TorchDispatchMode):
    """Records every aten op dispatched while it is entered, and every
    kernel call (``kernel_hook``) as one node around the ops it ran.
    ``sites``: each node also names the code that issued it (``site``).
    ``record`` takes each node; a subclass may fold them instead of
    keeping them."""

    def __init__(self, sites: bool = False):
        super().__init__()
        self.nodes: list[Node] = []
        self._kernel = ""
        self._sites = sites

    def record(self, node: Node) -> None:
        self.nodes.append(node)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _wrappers()) for t in types):
            return NotImplemented      # seen again on the local tensors
        out = func(*args, **kwargs)
        self.record(_node(func, args, kwargs, out, self._kernel,
                          site() if self._sites else ""))
        return out

    def kernel(self, name: str, fn: Callable, args: tuple, kwargs: dict):
        if self._kernel:       # a wrapper's own call of another wrapper
            return fn(*args, **kwargs)
        self._kernel = name
        try:
            out = fn(*args, **kwargs)
        finally:
            self._kernel = ""
        self.record(kernel_node(name, args, kwargs, out,
                                site() if self._sites else ""))
        return out


def trace_call(fn: Callable, *args, **kwargs) -> tuple[Any, list[Node]]:
    """Run ``fn(*args, **kwargs)`` without autograd and return (its
    result, the nodes it dispatched)."""
    tracer = Tracer()
    with torch.no_grad(), tracer, api.kernel_hook(tracer.kernel):
        out = fn(*args, **kwargs)
    return out, tracer.nodes
