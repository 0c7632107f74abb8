"""Working-set / LMM-coverage model (paper contribution C3/C4, Tables I
& IV): the port's copy of the JAX package's ``core/footprint.py``.

The paper's central co-design axis: for each dot-product kernel, how many
bytes must be resident in local memory (LMM on IMAX; the budget of the
ACCEL/HOST law in ``kernels/api.py``), under two data-handling policies:

* ``baseline``  — whisper.cpp's native layout: the kernel's A-operand is
  staged as stored, i.e. the full padded tensor plane (32-byte row
  alignment, storage dtype). This models the paper's observation that
  without packing, DMA moves padding and whole planes, so almost nothing
  fits a small LMM (Table I: 1.39 % at 32 KB for FP16).
* ``optimized`` — the paper's dense packing + inline conversion: only the
  working tile is resident, already converted to f32 (IMAX PEs compute in
  f32 after inline FP16→FP32 conversion; hence the optimized column of
  Table I is *identical* for the FP16 and Q8_0 models). Tile = N_TILE rows
  of A × K, plus the B row, plus N_TILE accumulators.

``N_TILE = 4`` models IMAX's 4-way column multithreading (Sec III-B).

Exact per-kernel byte counts inside whisper.cpp are not published; this
module reproduces the *structure* of Tables I/IV (near-zero baseline
coverage at small LMM, >90 % optimized coverage at 32 KB for tiny,
dtype-independent optimized column, 64 KB requirement for base/small).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.workload import KernelSpec
from repro_torch.quantize import bytes_per_elem, stored_bytes

N_TILE = 4  # column-wise multithreading depth (Sec III-B)

LMM_LIMITS = tuple(kb * 1024 for kb in (8, 16, 32, 64, 128, 256))


def elem_bytes(dtype: str) -> float:
    return bytes_per_elem(dtype)


def kernel_footprint(spec: KernelSpec, policy: str = "optimized",
                     n_tile: int = N_TILE) -> int:
    """Resident LMM bytes for one kernel call under a policy.

    Optimized (packed) residency: n_tile A-rows + one B-row + accumulators.
    Weight operands are inline-converted to f32 in the LMM (paper C1);
    **cache operands (attention QK/AV) stay in their f16 storage dtype** —
    this is what makes the paper's Table IV signature work out: the
    1500-frame attention kernels fit 16 KB for every model size, so
    base/small are flat from 16→32 KB and only the d_ff GEMMs (f32,
    20 bytes/K: tiny 1536 ≤ 32 KB < base 2048 ≤ 64 KB ≥ small 3072)
    produce the coverage jumps."""
    if policy == "optimized":
        elem = 2.0 if spec.tag in ("attn_qk", "attn_av") else 4.0
        return int(elem * (n_tile * spec.k + spec.k) + 4 * n_tile)
    if policy == "baseline":
        # Whole padded A plane in storage dtype + padded B row.
        a_bytes = stored_bytes((spec.n, spec.k), spec.dtype, "baseline")
        b_bytes = stored_bytes((spec.k,), "f16", "baseline")
        return a_bytes + b_bytes
    raise ValueError(f"unknown policy {policy!r}")


@dataclasses.dataclass(frozen=True)
class CoverageRow:
    limit_bytes: int
    coverage_pct: float      # % of kernel calls that fit
    flops_pct: float         # % of FLOPs covered (energy-relevant weighting)


def coverage_cdf(work: Sequence[KernelSpec], policy: str = "optimized",
                 limits: Sequence[int] = LMM_LIMITS,
                 n_tile: int = N_TILE) -> list[CoverageRow]:
    """Cumulative % of kernel calls whose footprint fits each LMM limit
    (paper Tables I & IV)."""
    total_calls = sum(s.calls for s in work)
    total_flops = sum(s.flops for s in work)
    rows = []
    for limit in limits:
        calls = sum(s.calls for s in work
                    if kernel_footprint(s, policy, n_tile) <= limit)
        flops = sum(s.flops for s in work
                    if kernel_footprint(s, policy, n_tile) <= limit)
        rows.append(CoverageRow(
            limit_bytes=limit,
            coverage_pct=100.0 * calls / max(total_calls, 1),
            flops_pct=100.0 * flops / max(total_flops, 1),
        ))
    return rows


# ----------------------------------------------------------------------------
# Block-shape selection under a local-memory budget (the paper's C4 knob)
# ----------------------------------------------------------------------------
#
# ``select_blocks`` is the reference's chooser, kept with its tile
# multiples so that it returns the reference's blocks; the figure
# scripts print it as the paper's C4 chooser. The port's CUDA kernels
# plan their own tiles (``kernels/<op>/ops.py``) and do not call it.

TILE_LANE = 128    # last-dim tile multiple
TILE_SUBLANE = 8   # second-minor tile multiple (f32)


@dataclasses.dataclass(frozen=True)
class BlockShape:
    bm: int
    bn: int
    bk: int
    vmem_bytes: int

    def fits(self, budget: int) -> bool:
        return self.vmem_bytes <= budget


def block_vmem_bytes(bm: int, bn: int, bk: int, a_dtype: str,
                     b_dtype: str = "f32") -> int:
    """Local-memory bytes for one (bm×bk)·(bk×bn) step: A tile + B tile
    + f32 acc, the input tiles double-buffered (the next block streams
    in while this one is multiplied)."""
    a = bm * bk * elem_bytes(a_dtype)
    b = bk * bn * elem_bytes(b_dtype)
    acc = bm * bn * 4
    return int(2 * (a + b) + acc)


def select_blocks(m: int, n: int, k: int, budget_bytes: int,
                  a_dtype: str = "bf16", b_dtype: str = "bf16") -> BlockShape:
    """Choose tile-aligned block shapes under a local-memory byte budget
    — the paper's LMM-size knob. Greedy: grow bk (reuse), then bn/bm
    (tile utilization), staying under budget."""
    def rdown(x: int, mult: int) -> int:
        return max(mult, (x // mult) * mult)

    m_c = rdown(min(m, 256), TILE_SUBLANE)
    n_c = rdown(min(n, 256), TILE_LANE)
    k_c = rdown(min(k, 2048), TILE_LANE if k >= TILE_LANE else 32)

    best = None
    bk = k_c
    while bk >= 32:
        bn = n_c
        while bn >= TILE_LANE or bn == n_c:
            bm = m_c
            while bm >= TILE_SUBLANE:
                vb = block_vmem_bytes(bm, bn, bk, a_dtype, b_dtype)
                if vb <= budget_bytes:
                    cand = BlockShape(bm, bn, bk, vb)
                    # prefer larger tiles, then larger K reuse
                    key = (bm * bn, bk)
                    if best is None or key > (best.bm * best.bn, best.bk):
                        best = cand
                    break
                bm //= 2
                bm = rdown(bm, TILE_SUBLANE) if bm >= TILE_SUBLANE else 0
                if bm == 0:
                    break
            if bn <= TILE_LANE:
                break
            bn = rdown(bn // 2, TILE_LANE)
        if bk <= 32:
            break
        bk = max(32, rdown(bk // 2, 32))
    if best is None:
        raise ValueError(
            f"no tile-aligned block fits budget={budget_bytes}B for "
            f"gemm ({m}x{k})@({k}x{n})")
    return best
