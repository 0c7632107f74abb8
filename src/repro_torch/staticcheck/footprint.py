"""SC-FOOT / SC-REG -- the kernel registry's analytic footprints,
cross-checked against what the host backend executes (the JAX package's
``staticcheck/footprint.py``, which measures XLA's HLO cost model).

For every registered op with a representative call (the reference's
calls: the same shapes and dtypes, drawn from a seed with numpy), its
``KernelSpec`` comes from the registry's own spec builder and its host
backend (``"torch"``, the plain version) runs under two counters:
``torch.utils.flop_counter.FlopCounterMode`` for the flops, and a
``trace.Tracer`` for the bytes, each node's ``moved_bytes`` (the input
and output bytes of every aten node that is not a view: eager ops are
each materialised, so this is what the plain version moves). The
measured/analytic ratios must sit inside the tolerance bands of the
port's ``staticcheck.toml``: a spec that drifts from the code it
describes (stale ``count``, wrong contraction dims) corrupts every
downstream energy / PDP figure.

SC-REG requires each op to be host-servable: a backend of its
``host_order`` chain (``"torch"``) must be registered, so the CPU can
always execute it.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.staticcheck.config import StaticcheckConfig
from repro_torch.staticcheck.report import Finding
from repro_torch.staticcheck.trace import trace_call

CHECK_FOOT = "SC-FOOT"
CHECK_REG = "SC-REG"

# Analytic stream model per spec: stationary operand (weights / cached
# plane) in the storage dtype, activations in the 2-byte compute dtype,
# f32 accumulator out -- the LMM traffic convention the energy
# accounting uses.
_ELEM_BYTES = {"f16": 2.0, "bf16": 2.0, "f32": 4.0,
               "q8_0": 1.0 + 2.0 / 32.0}


def spec_stream_bytes(spec) -> float:
    eb = _ELEM_BYTES.get(spec.dtype, 4.0)
    stationary = spec.n * spec.k * eb
    moving = spec.m * spec.k * 2.0
    out = spec.m * spec.n * 4.0
    return spec.count * (stationary + moving + out)


def representative_calls() -> dict[str, tuple[tuple, dict]]:
    """(args, kwargs) per builtin op, on the CPU: small shapes in each
    op's serving layout (GQA planes, q8 pools, paged pools, scanned
    recurrences), the reference's shapes and dtypes."""
    from repro_torch.quantize import quantize_q8_0

    rng = np.random.default_rng(0)

    def normal(shape, dtype=torch.float32, scale=1.0):
        x = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(x).to(dtype)

    x8 = normal((8, 256))
    w8 = quantize_q8_0(normal((256, 128)), axis=0)
    xf = normal((8, 128), torch.bfloat16)
    wf = normal((128, 128), torch.bfloat16)
    q = normal((2, 64, 4, 32), torch.bfloat16)
    kv = normal((2, 64, 2, 32), torch.bfloat16)
    dq = normal((8, 1, 32))
    kq = torch.from_numpy(rng.integers(-127, 127, (8, 64, 32), np.int8))
    ks = torch.full((8, 64, 1), 0.02, dtype=torch.float16)
    length = torch.full((8,), 48, dtype=torch.int32)
    wx = normal((16, 4, 2, 2, 16))
    r = normal((4, 2, 16, 16), scale=0.1)
    s0 = torch.zeros((4, 2, 2, 16))
    # paged pool planes: (n_pages, P, Hkv, D) + per-lane page tables
    # (B, n_lp) reassembling 8 logical pages of 8: the reduced serving
    # geometry (4 lanes x max_len 64 + scratch page 0)
    pq = normal((4, 1, 4, 32), torch.bfloat16)
    plane = normal((33, 8, 2, 32), torch.bfloat16)
    table = torch.from_numpy(rng.integers(1, 33, (4, 8), np.int32))
    plens = torch.full((4,), 48, dtype=torch.int32)
    return {
        "q8_matmul": ((x8, w8), {}),
        "fp16_matmul": ((xf, wf), {}),
        "flash_attention": ((q, kv, kv), {"causal": True}),
        "q8_decode_attention": ((dq, kq, ks, kq, ks, length), {}),
        "paged_decode_attention": ((pq, plane, plane, table, plens), {}),
        "slstm_scan": ((wx, r, s0), {}),
    }


def _host_backend(op) -> Optional[str]:
    for b in op.host_order:
        if b in op.backends:
            return b
    return None


def measure(fn, args: tuple, kwargs: dict) -> tuple[float, float]:
    """(flops, bytes) one call of ``fn`` executes: the flop counter's
    total, and the bytes its nodes move (``Node.moved_bytes``)."""
    counter = FlopCounterMode(display=False)
    with counter:
        _, nodes = trace_call(fn, *args, **kwargs)
    nbytes = sum(n.moved_bytes for n in nodes)
    return float(counter.get_total_flops()), float(nbytes)


def check_registry(op_names: Optional[list[str]] = None) -> list[Finding]:
    from repro_torch.kernels import registry

    out = []
    for name in (op_names or registry.list_ops()):
        op = registry.get_op(name)
        host = _host_backend(op)
        ok = host is not None
        out.append(Finding(
            check=CHECK_REG, subject=name, ok=ok,
            detail=(f"host-servable via '{host}' backend" if ok else
                    f"no host backend: host_order={op.host_order}, "
                    f"registered={sorted(op.backends)}"),
            data={"backends": sorted(op.backends),
                  "host_backend": host}))
    return out


def check_footprint(config: StaticcheckConfig,
                    op_names: Optional[list[str]] = None,
                    reps: Optional[dict] = None) -> list[Finding]:
    from repro_torch.kernels import registry

    reps = reps if reps is not None else representative_calls()
    out = []
    for name in (op_names or registry.list_ops()):
        if name not in reps:
            continue
        op = registry.get_op(name)
        backend = _host_backend(op)
        if backend is None:
            continue  # SC-REG reports this
        args, kwargs = reps[name]
        spec = op.spec(*args, **kwargs)
        flops, nbytes = measure(op.backends[backend], args, kwargs)
        a_flops = float(spec.flops)
        a_bytes = spec_stream_bytes(spec)
        rf = flops / a_flops if a_flops else math.inf
        rb = nbytes / a_bytes if a_bytes else math.inf
        f_lo, f_hi = config.ratio_band(name, "flops_ratio")
        b_lo, b_hi = config.ratio_band(name, "bytes_ratio")
        ok = f_lo <= rf <= f_hi and b_lo <= rb <= b_hi
        out.append(Finding(
            check=CHECK_FOOT, subject=name, ok=ok,
            detail=(f"[{backend}] measured/analytic flops {rf:.2f}x "
                    f"(band [{f_lo}, {f_hi}]), bytes {rb:.2f}x "
                    f"(band [{b_lo}, {b_hi}])"),
            data={"backend": backend, "flops_ratio": rf,
                  "bytes_ratio": rb,
                  "analytic": {"flops": a_flops, "bytes": a_bytes,
                               "spec": {"m": spec.m, "n": spec.n,
                                        "k": spec.k,
                                        "count": spec.count,
                                        "dtype": spec.dtype}},
                  "measured": {"flops": flops, "bytes": nbytes}}))
    return out
