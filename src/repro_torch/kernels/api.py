"""Kernel dispatch: the paper's ACCEL/HOST control law as a router.

``dispatch(op, *args, **kwargs)`` builds the op's ``KernelSpec``,
compares its analytic footprint (``core.footprint.kernel_footprint``)
with the context's budget — footprint <= budget is ACCEL, else HOST —
binds the decision to the first eligible backend of that side, runs it,
and records the routing in a trace and in counters keyed
``(op, decision, backend)``.

For CPU tensors both sides bind to ``"torch"``, the plain version, as
the reference binds ACCEL to XLA off the TPU. For CUDA tensors both
sides bind to ``"cuda"``, the hand-written Hopper kernel: the kernels
take every size, and the plain versions serve CPU tensors only. The
record keeps the law's decision (``"host"`` when the footprint exceeds
the budget), so nothing moves main-path work off the kernels quietly.
Forcing ``"torch"`` on CUDA tensors raises unless the context sets
``allow_plain_on_cuda`` (a comparison against the plain version). There
is no fallback: a kernel that cannot take a call raises.

The kernels define no backward, so a differentiated forward (training)
runs under ``grad_safe_context()``: every op keeps the law's decision
but binds its differentiable torch implementation (``KernelOp.grad``,
else the plain version), on CPU and CUDA tensors alike, recorded
``(op, decision, "torch")`` with the tag ``"grad_safe"``. It is the
reference's ``grad_safe_context``, which binds XLA where the kernels
would have run. A kernel is never handed a DTensor (the parallel
layer's): a DTensor operand binds the torch implementation under
``grad_safe_context`` and on the CPU, and on the card outside it raises
as any plain route there does, unless the context sets
``allow_plain_on_cuda``. The port's steps gather parameters and caches
to plain tensors before a forward, so no DTensor reaches a kernel call
on their paths.

A ``DispatchContext`` carries the budget, the packing policy, backend
overrides and the platform / tag stamped into each record; derive one
from a registered platform with ``DispatchContext.for_platform``.

A CUDA graph replays its kernels without running the Python that
dispatched them, so neither the log nor a wrapper's ``launches`` count
moves on a replay. ``recording()`` takes what one capture pass
dispatched and launched out of the log into a ``TickRecord``, and
``replay_record`` adds it back once per replay: the counts then read the
same per tick as an uncaptured tick's.

A hot-path trace (``repro_torch.staticcheck``) sees each kernel call as
one node: ``kernel_hook`` installs a hook that ``kernel_call`` runs every
call of a kernel through, a dispatched op with a kernel of its own and
the paged decode op's call of its tier's kernel alike.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Iterator, Mapping, Optional

import torch

from repro_torch.core.footprint import kernel_footprint
from repro_torch.core.workload import KernelSpec
from repro_torch.kernels.registry import BACKENDS, KernelOp, get_op, register
from repro_torch.dtensor import is_dtensor

__all__ = [
    "DispatchContext", "DispatchRecord", "dispatch", "dispatch_counters",
    "dispatch_trace", "reset_dispatch_log", "use_context",
    "current_context", "decide", "launch_counts", "TickRecord",
    "recording", "replay_record", "kernel_hook", "kernel_call",
    "grad_safe_context",
]

#: budget of a context not derived from a platform (the reference's
#: ``flags.DEFAULT_VMEM_BUDGET``)
DEFAULT_BUDGET = 4 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """Everything the control law needs to route one kernel call.

    ``vmem_budget`` is the paper's LMM-size knob. ``force_backend``
    bypasses the control law globally; ``backends`` per op
    (``{"q8_matmul": "torch"}``). ``allow_plain_on_cuda`` lets a forced
    ``"torch"`` run on CUDA tensors, for comparisons against the plain
    versions. ``platform`` and ``tag`` are stamped into every
    ``DispatchRecord``. ``grad_safe`` binds every op to its
    differentiable torch implementation (``grad_safe_context``)."""

    vmem_budget: int = DEFAULT_BUDGET
    policy: str = "optimized"
    force_backend: Optional[str] = None
    backends: Mapping[str, str] = dataclasses.field(default_factory=dict)
    allow_plain_on_cuda: bool = False
    platform: Optional[str] = None
    tag: Optional[str] = None
    grad_safe: bool = False

    @classmethod
    def for_platform(cls, platform, **overrides) -> "DispatchContext":
        """Budget and policy from a registered ``repro_torch.platforms``
        target (name or object); keyword ``overrides`` win."""
        from repro_torch.platforms import get_platform
        p = get_platform(platform)
        kw = dict(vmem_budget=p.vmem_budget, policy=p.policy,
                  platform=p.name)
        kw.update(overrides)
        return cls(**kw)


_CTX: Optional[DispatchContext] = None


def current_context() -> DispatchContext:
    """The innermost ``use_context``, else a default context."""
    return _CTX if _CTX is not None else DispatchContext()


def grad_safe_context(ctx: Optional[DispatchContext] = None
                      ) -> DispatchContext:
    """A variant of ``ctx`` (default: the current one) for a forward
    under autograd: the same budget, policy and law, every op bound to
    its differentiable torch implementation, no forced ``"cuda"``, and
    records tagged ``"grad_safe"`` unless ``ctx`` has a tag."""
    ctx = ctx or current_context()
    force = None if ctx.force_backend == "cuda" else ctx.force_backend
    backends = {k: v for k, v in ctx.backends.items() if v != "cuda"}
    return dataclasses.replace(ctx, force_backend=force, backends=backends,
                               grad_safe=True, tag=ctx.tag or "grad_safe")


@contextlib.contextmanager
def use_context(ctx: Optional[DispatchContext]):
    """Install ``ctx`` for the enclosed block (``None`` is a no-op)."""
    global _CTX
    if ctx is None:
        yield
        return
    prev = _CTX
    _CTX = ctx
    try:
        yield ctx
    finally:
        _CTX = prev


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    op: str
    decision: str        # "accel" | "host" | "forced"
    backend: str         # "cuda" | "torch"
    footprint: int
    budget: int
    spec: KernelSpec
    platform: str = ""
    tag: str = ""


_TRACE_MAX = 1024
_trace: collections.deque = collections.deque(maxlen=_TRACE_MAX)
_counters: collections.Counter = collections.Counter()


def dispatch_trace() -> list[DispatchRecord]:
    return list(_trace)


def dispatch_counters() -> collections.Counter:
    """Counter keyed ``(op, decision, backend)``."""
    return collections.Counter(_counters)


def reset_dispatch_log() -> None:
    _trace.clear()
    _counters.clear()


#: op name -> the wrapper whose ``launches`` attribute counts the launches
#: of that op's kernel (filled by ``_register_builtin_ops``)
_LAUNCHERS: dict[str, Callable] = {}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by op (each wrapper's ``launches``)."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


@dataclasses.dataclass
class TickRecord:
    """What one pass over a captured region dispatched and launched: the
    routing counters, the trace records in order, and the launches by
    op."""
    counters: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    trace: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def recording() -> Iterator[TickRecord]:
    """Record the dispatches and launches of the enclosed block into the
    ``TickRecord`` it yields and leave the log and every ``launches``
    count as they were before it: a graph capture, which runs nothing on
    the card, counts nothing."""
    global _trace, _counters
    saved_trace, saved_counters = _trace, _counters
    before = launch_counts()
    rec = TickRecord()
    _trace = collections.deque(maxlen=_TRACE_MAX)
    _counters = collections.Counter()
    try:
        yield rec
    finally:
        rec.counters, rec.trace = _counters, list(_trace)
        rec.launches = {name: n - before[name]
                        for name, n in launch_counts().items()
                        if n != before[name]}
        _trace, _counters = saved_trace, saved_counters
        for name, n in before.items():
            _LAUNCHERS[name].launches = n


def replay_record(rec: TickRecord) -> None:
    """Count one replay of a recorded region, as if it had run again."""
    _counters.update(rec.counters)
    _trace.extend(rec.trace)
    for name, n in rec.launches.items():
        _LAUNCHERS[name].launches += n


#: the installed ``kernel_hook`` (None: kernels are called directly)
_kernel_hook: Optional[Callable] = None


@contextlib.contextmanager
def kernel_hook(hook: Callable):
    """Run every kernel call of the enclosed block as ``hook(op_name, fn,
    args, kwargs)``, which must return ``fn(*args, **kwargs)``."""
    global _kernel_hook
    prev, _kernel_hook = _kernel_hook, hook
    try:
        yield
    finally:
        _kernel_hook = prev


def kernel_call(op_name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``: one call of kernel ``op_name``'s wrapper
    (its plain version on CPU tensors), through the installed hook."""
    if _kernel_hook is None:
        return fn(*args, **kwargs)
    return _kernel_hook(op_name, fn, args, kwargs)


def _first_allowed(op: KernelOp, order, on_cuda: bool) -> str:
    for b in order:
        if b in op.backends and (b != "cuda" or on_cuda):
            return b
    for b in order:
        if b in op.backends:
            return b
    return next(iter(op.backends))


def _decide(op: KernelOp, spec: KernelSpec, ctx: DispatchContext,
            on_cuda: bool, dtensor: bool = False) -> tuple[str, str, int]:
    footprint = kernel_footprint(spec, ctx.policy)
    forced = ctx.force_backend or ctx.backends.get(op.name)
    if forced:
        if forced not in BACKENDS:
            raise ValueError(f"forced backend {forced!r} for {op.name}: "
                             f"expected one of {BACKENDS}")
        decision = "forced"
        backend = forced if forced in op.backends \
            else _first_allowed(op, op.host_order, on_cuda)
    else:
        decision = "accel" if footprint <= ctx.vmem_budget else "host"
        order = op.accel_order if decision == "accel" or on_cuda \
            else op.host_order
        backend = _first_allowed(op, order, on_cuda)
    if ctx.grad_safe:
        return decision, "torch", footprint
    if dtensor:
        if on_cuda and not ctx.allow_plain_on_cuda:
            raise ValueError(f"{op.name}: a DTensor operand on the card "
                             f"reaches no kernel; gather it to a plain "
                             f"tensor, or run under grad_safe_context")
        return decision, "torch", footprint
    if on_cuda and backend != "cuda" and not ctx.allow_plain_on_cuda:
        raise ValueError(f"{op.name}: {decision} route to {backend!r} would "
                         f"run the plain version on the card; set "
                         f"allow_plain_on_cuda to compare against it")
    return decision, backend, footprint


def decide(op_name: str, spec: KernelSpec,
           ctx: Optional[DispatchContext] = None,
           on_cuda: bool = True, dtensor: bool = False) -> tuple[str, str]:
    """(decision, backend) the control law would take for ``spec``
    (with a DTensor operand if ``dtensor``)."""
    decision, backend, _ = _decide(get_op(op_name), spec,
                                   ctx or current_context(), on_cuda,
                                   dtensor)
    return decision, backend


def dispatch(op_name: str, *args, ctx: Optional[DispatchContext] = None,
             tag: Optional[str] = None, **kwargs):
    """Route one kernel call through the backend the control law
    selects and return its result. ``tag`` (never forwarded) overrides
    the spec's tag, e.g. ``"frontend"`` for the log-mel GEMMs."""
    op = get_op(op_name)
    ctx = ctx or current_context()
    spec = op.spec(*args, **kwargs)
    if tag is not None:
        spec = dataclasses.replace(spec, tag=tag)
    # a DTensor operand never reaches a kernel (its local shard is not
    # the operand the kernel's plan was made for)
    dtensor = any(is_dtensor(a) for a in args)
    decision, backend, footprint = _decide(op, spec, ctx, args[0].is_cuda,
                                           dtensor)
    if ctx.grad_safe or dtensor:
        out = (op.grad or op.backends["torch"])(*args, **kwargs)
    elif op_name in _LAUNCHERS:
        out = kernel_call(op_name, op.backends[backend], *args, **kwargs)
    else:
        out = op.backends[backend](*args, **kwargs)
    _trace.append(DispatchRecord(op_name, decision, backend, footprint,
                                 ctx.vmem_budget, spec,
                                 platform=ctx.platform or "",
                                 tag=ctx.tag or ""))
    _counters[(op_name, decision, backend)] += 1
    return out


# ----------------------------------------------------------------------------
# Built-in op registrations
# ----------------------------------------------------------------------------

def _flat_m(x) -> int:
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return m


def _decode_attn_spec(name: str, dtype: str):
    def spec(q, kq, ks, vq, vs, length, layer=None) -> KernelSpec:
        # count = 2 * lanes * heads: the QK^T and AV contractions; m =
        # the queries of a lane (1, or spec_k in the verify)
        if layer is None:       # flat (BH, Q, D) form
            n, count = kq.shape[1], 2 * q.shape[0]
        else:                   # stacked (L, B, S, Hkv, .) cache form
            n, count = kq.shape[2], 2 * q.shape[0] * q.shape[2]
        return KernelSpec(name, m=q.shape[1], n=n, k=q.shape[-1],
                          dtype=dtype, count=count, tag="attn_qk")
    return spec


def _decode_attn_backends(flat, cache):
    """Backend of a decode-attention op: the flat (BH, Q, D) form, or the
    stacked cache form when ``layer`` is given."""
    def run(q, kq, ks, vq, vs, length, layer=None):
        if layer is None:
            return flat(q, kq, ks, vq, vs, length)
        return cache(q, kq, ks, vq, vs, length, layer)
    return run


def _paged_spec(q, kc, vc, table, lens) -> KernelSpec:
    if isinstance(kc, dict):
        plane = kc["p"] if "p" in kc else kc["q"]
        dtype = "q4_0" if "p" in kc else "q8_0"
    else:
        plane, dtype = kc, "bf16"
    return KernelSpec("paged_decode_attention", m=q.shape[1],
                      n=table.shape[1] * plane.shape[1], k=q.shape[-1],
                      dtype=dtype, count=2 * q.shape[0] * q.shape[2],
                      tag="attn_qk")


def _register_builtin_ops() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain
    from repro_torch.kernels.fp16_matmul import ops as mm_ops
    from repro_torch.kernels.fp16_matmul import plain as mm_plain
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import plain as pa_plain
    from repro_torch.kernels.q4_attention import ops as q4a_ops
    from repro_torch.kernels.q4_attention import plain as q4a_plain
    from repro_torch.kernels.q4_matmul import ops as q4_ops
    from repro_torch.kernels.q4_matmul import plain as q4_plain
    from repro_torch.kernels.q8_attention import ops as qa_ops
    from repro_torch.kernels.q8_attention import plain as qa_plain
    from repro_torch.kernels.q8_matmul import ops as q8_ops
    from repro_torch.kernels.q8_matmul import plain as q8_plain
    from repro_torch.kernels.slstm_scan import ops as sl_ops
    from repro_torch.kernels.slstm_scan import plain as sl_plain

    f32 = torch.float32
    _LAUNCHERS.update({
        "fp16_matmul": mm_ops.fp16_matmul,
        "q8_matmul": q8_ops.q8_matmul,
        "flash_attention": fa_ops.flash_attention,
        "q8_decode_attention": qa_ops.q8_decode_attention,
        "q4_matmul": q4_ops.q4_matmul,
        "q4_decode_attention": q4a_ops.q4_decode_attention,
        "slstm_scan": sl_ops.slstm_scan})

    register(KernelOp(
        name="q8_matmul",
        doc="Q8_0 GEMM (weights quantized along K).",
        spec=lambda x, w, **kw: KernelSpec(
            "q8_matmul", m=_flat_m(x), n=w.q.shape[-1], k=x.shape[-1],
            dtype="q8_0", tag="proj"),
        backends={
            "cuda": lambda x, w, out_dtype=f32: q8_ops.q8_matmul(
                x, w, out_dtype=out_dtype),
            "torch": lambda x, w, out_dtype=f32: q8_plain.q8_matmul(
                x, w.q, w.scale, out_dtype=out_dtype),
        },
    ))

    # spec.k is the logical K (twice the packed rows), as the reference
    register(KernelOp(
        name="q4_matmul",
        doc="Q4_0 GEMM (nibble-packed weights quantized along K).",
        spec=lambda x, w, **kw: KernelSpec(
            "q4_matmul", m=_flat_m(x), n=w.q.shape[-1], k=x.shape[-1],
            dtype="q4_0", tag="proj"),
        backends={
            "cuda": lambda x, w, out_dtype=f32: q4_ops.q4_matmul(
                x, w, out_dtype=out_dtype),
            "torch": lambda x, w, out_dtype=f32: q4_plain.q4_matmul(
                x, w.q, w.scale, out_dtype=out_dtype),
        },
    ))

    register(KernelOp(
        name="fp16_matmul",
        doc="Dense f32/bf16/f16 GEMM.",
        spec=lambda x, w, **kw: KernelSpec(
            "fp16_matmul", m=_flat_m(x), n=w.shape[-1], k=x.shape[-1],
            dtype="f16", tag="proj"),
        backends={
            "cuda": lambda x, w, out_dtype=f32: mm_ops.fp16_matmul(
                x, w, out_dtype=out_dtype),
            "torch": lambda x, w, out_dtype=f32: mm_plain.fp16_matmul(
                x, w, out_dtype=out_dtype),
        },
        grad=lambda x, w, out_dtype=f32: mm_plain.fp16_matmul_grad(
            x, w, out_dtype=out_dtype),
    ))

    register(KernelOp(
        name="flash_attention",
        doc="GQA flash attention over (B, S, H, D).",
        # count = 2 * B * H: QK^T and AV over every batch*query-head plane
        spec=lambda q, k, v, **kw: KernelSpec(
            "flash_attention", m=q.shape[1], n=k.shape[1], k=q.shape[-1],
            dtype="f16", count=2 * q.shape[0] * q.shape[2],
            tag="attn_qk"),
        backends={"cuda": fa_ops.flash_attention,
                  "torch": fa_plain.flash_attention},
    ))

    register(KernelOp(
        name="q8_decode_attention",
        doc="Decode attention reading the Q8_0-quantized KV cache.",
        spec=_decode_attn_spec("q8_decode_attention", "q8_0"),
        backends={
            "cuda": _decode_attn_backends(
                qa_ops.q8_decode_attention,
                qa_ops.q8_decode_attention_cache),
            "torch": _decode_attn_backends(
                qa_plain.q8_decode_attention,
                qa_plain.q8_decode_attention_cache)},
    ))

    register(KernelOp(
        name="q4_decode_attention",
        doc="Decode attention reading the Q4_0 nibble-packed KV cache.",
        spec=_decode_attn_spec("q4_decode_attention", "q4_0"),
        backends={
            "cuda": _decode_attn_backends(
                q4a_ops.q4_decode_attention,
                q4a_ops.q4_decode_attention_cache),
            "torch": _decode_attn_backends(
                q4a_plain.q4_decode_attention,
                q4a_plain.q4_decode_attention_cache)},
    ))

    # paged_decode_attention: decode over a paged pool (n_pages, P, Hkv, .)
    # read through the (B, n_lp) page table, so n = n_lp * P plays the
    # role the slot pool's max_len / enc_len played; count = 2 * B * H as
    # in the slot-pool decode ops. No kernel of its own: the cuda backend
    # gathers the pages and launches the tier's decode-attention kernel
    register(KernelOp(
        name="paged_decode_attention",
        doc="Decode attention gathered over per-lane page tables.",
        spec=_paged_spec,
        backends={"cuda": pa_ops.paged_decode_attention,
                  "torch": pa_plain.paged_decode_attention},
    ))

    register(KernelOp(
        name="slstm_scan",
        doc="sLSTM recurrence over a whole sequence, state on chip.",
        # count = 4 * S: four gate recurrence products (B*H, hd) @ (hd, hd)
        # per time step, as the reference's spec
        spec=lambda wx, r_all, state0: KernelSpec(
            "slstm_scan", m=wx.shape[2] * wx.shape[3], n=wx.shape[-1],
            k=wx.shape[-1], dtype="f32", count=4 * wx.shape[0],
            tag="ssm"),
        backends={"cuda": sl_ops.slstm_scan, "torch": sl_plain.slstm_scan},
    ))


_register_builtin_ops()
