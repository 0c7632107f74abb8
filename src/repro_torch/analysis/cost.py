"""The cost of one traced call: FLOPs, bytes, collective bytes and a
rank's peak memory (the counterpart of the JAX package's
``analysis/hlo.py``, its while-aware cost model over HLO text).

The port has no HLO: its program is the aten ops one call dispatches,
as ``staticcheck/trace.py``'s ``Tracer`` records them; ``measure``
folds its nodes as they come. It runs the call under ``FakeTensorMode``
(nothing is allocated; the inputs must be fake tensors of that mode, or
DTensors over them) with

* ``FlopCounterMode`` for the FLOPs (its formulas: matrix products and
  attention, as XLA's cost model counts dots);
* the tracer for the bytes, each node's ``moved_bytes`` (the input and
  output bytes of each non-view op: eager ops are each materialised, so
  this is what the call moves, by the rule SC-FOOT uses), and the
  collectives: the operand bytes of each traced ``_c10d_functional``
  all-gather, reduce-scatter, all-reduce and all-to-all, by kind, with
  their counts, kept out of the memory bytes as the reference keeps
  them;
* ``torch.distributed._tools.MemTracker`` for the peak of the bytes
  alive at once, the call's tracked inputs included.

A DTensor op is seen on its local tensors: every figure is one rank's.
A kernel call (``kernels.api.kernel_call``) is one node: its FLOPs are
its registry ``KernelSpec``'s, its bytes its inputs' and outputs', and
its output comes from its plain version run under the fake mode alone,
so that neither the counters nor the memory tracker see the plain
version's own temporaries, and a call on fake ``cuda`` tensors never
reaches the kernel's launcher.

Autograd on fake ``cuda`` tensors needs a PyTorch built for CUDA;
without one, trace a train step on fake ``cpu`` tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import api
from repro_torch.staticcheck.trace import (Node, Tracer, kernel_node, site,
                                           tensors)

#: the traced collective ops by kind (the reference's HLO opcodes)
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class Cost:
    """One rank's cost of one call. ``flops``: FlopCounterMode's total,
    the kernel nodes at their specs'; ``bytes``: the ops' memory bytes;
    ``collectives`` / ``collective_counts``: operand bytes and calls by
    kind; ``peak_bytes``: MemTracker's peak, ``tracked_bytes`` the
    tracked inputs' bytes within it, ``output_bytes`` the result's;
    ``kernels``: calls by kernel op."""
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    tracked_bytes: int = 0
    output_bytes: int = 0
    seconds: float = 0.0
    instructions: dict = dataclasses.field(default_factory=dict)
    collective_sites: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))

    @staticmethod
    def _top(table: dict, n: int) -> list:
        rows = [(b, op, shape, where)
                for (op, shape, where), b in table.items()]
        return sorted(rows, key=lambda r: -r[0])[:n]

    def top_instructions(self, n: int = 30) -> list:
        """The heaviest ops by bytes, summed over the calls of one op at
        one shape from one site: [(bytes, op, shape, module)]."""
        return self._top(self.instructions, n)

    def top_collectives(self, n: int = 20) -> list:
        """The heaviest collectives by operand bytes, grouped the same
        way: [(bytes, kind, shape, module)]."""
        return self._top(self.collective_sites, n)


def _add(table: dict, key, value: float) -> None:
    table[key] = table.get(key, 0) + value


class CostTracer(Tracer):
    """A ``Tracer`` that folds each node into a ``Cost`` as it comes, and
    runs a kernel call (``kernel_hook``) as one node at its spec."""

    def __init__(self, cost: Cost, flops: FlopCounterMode, memory):
        super().__init__(sites=True)
        self.cost, self.flop_counter, self.memory = cost, flops, memory

    def record(self, node: Node) -> None:
        c = self.cost
        if node.is_kernel:
            name = node.op
        else:
            ns, name = node.op.split(".")[:2]
            if ns == "_c10d_functional":
                kind = COLLECTIVES.get(name)
                if kind is not None:
                    b = sum(t.nbytes for t in node.inputs)
                    _add(c.collectives, kind, b)
                    _add(c.collective_counts, kind, 1)
                    _add(c.collective_sites,
                         (kind, str(node.inputs[0].shape), node.site), b)
                return
        b = node.moved_bytes
        if not b:
            return
        c.bytes += b
        _add(c.bytes_by_op, name, b)
        shape = str(node.outputs[0].shape) if node.outputs else "()"
        _add(c.instructions, (name, shape, node.site), b)

    def kernel(self, name: str, fn: Callable, args: tuple, kwargs: dict):
        """The ``kernel_hook``: one node, costed by the op's spec, its
        output from the plain version under the fake mode alone."""
        from torch._guards import detect_fake_mode
        from repro_torch.kernels import registry
        op = registry.get_op(name)
        spec = op.spec(*args, **kwargs)
        fake = detect_fake_mode(list(tensors((args, kwargs))))
        with _disable_current_modes(), (fake or contextlib.nullcontext()):
            out = op.backends["torch"](*args, **kwargs)
        self.record(kernel_node(name, args, kwargs, out, site()))
        key = f"kernel:{name}"
        counts = self.flop_counter.flop_counts["Global"]
        counts[key] = counts.get(key, 0) + spec.flops
        _add(self.cost.flops_by_op, key, spec.flops)
        _add(self.cost.kernels, name, 1)
        outs = list(tensors(out))
        if outs:
            self.memory.track_external(*outs)
        return out


def _bmm_flops(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """``aten.bmm``'s FLOPs, with or without ``out_dtype`` (the formula
    of torch 2.11 takes that third argument for the output's shape)."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def measure(fn: Callable, *args, track: Any = (), **kwargs
            ) -> tuple[Any, Cost]:
    """Run ``fn(*args, **kwargs)`` on fake tensors under the counters
    and return (its result, its ``Cost``). ``track``: tensors that live
    before the call and count towards its peak (the state a step
    updates), as their local bytes."""
    from torch.distributed._tools.mem_tracker import MemTracker
    cost = Cost()
    flops = FlopCounterMode(display=False,
                            custom_mapping={torch.ops.aten.bmm: _bmm_flops})
    mem = MemTracker()
    tracked = list(tensors(track))
    if tracked:
        mem.track_external(*tracked)
    tracer = CostTracer(cost, flops, mem)
    t0 = time.monotonic()
    with flops, mem, tracer, api.kernel_hook(tracer.kernel):
        out = fn(*args, **kwargs)
    cost.seconds = time.monotonic() - t0
    for op, n in flops.get_flop_counts()["Global"].items():
        key = op if isinstance(op, str) else str(op).split(".")[-1]
        if not key.startswith("kernel:"):
            cost.flops_by_op[key] = cost.flops_by_op.get(key, 0) + n
    cost.flops = float(flops.get_total_flops())
    peak = mem.get_tracker_snapshot("peak")
    cost.peak_bytes = max((s["Total"] for s in peak.values()), default=0)
    cost.tracked_bytes = sum(local_bytes(t) for t in tracked)
    cost.output_bytes = sum(local_bytes(t) for t in tensors(out))
    return out, cost


def local_bytes(t: torch.Tensor) -> int:
    """The bytes a rank stores of ``t`` (a DTensor's local shard)."""
    from repro_torch.dtensor import local
    return local(t).nbytes
