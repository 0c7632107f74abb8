"""Energy model: power, PDP, calibration, LMM sweeps (paper C5): the
port's copy of the JAX package's ``core/energy.py``.

Reproduces the paper's evaluation methodology, sourcing every hardware
fact through the platform registry (``repro_torch.platforms``):

* ``imax_power`` / ``interp_power`` — Table II power-vs-LMM curves
  (log-linear interpolation) read from the ``imax3-28nm`` platforms.
* ``calibrate_imax`` — closed-form fit of the 4-parameter AccelModel to
  the paper's published observables carried on the platform (FP16/Q8_0
  E2E latency 13.5 s / 11.1 s, EXEC shares 60.89 % / 74.70 %, host-only
  latency 24.4 s / 19.6 s). The paper's numbers over-determine the
  model; the residual mismatch is the reproduction check.
* ``pdp`` and ``lmm_sweep`` — Figs 4/5/6: latency & PDP vs LMM size,
  with the PDP minimum expected at 32 KB.
* ``platform_pdp_table`` — Figs 4+5 over the whole registry: every
  platform with published observables, the calibrated IMAX model, and
  a projection onto the port's card (``accel_model_for``, h100-sxm),
  where the reference projects onto its own target.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from repro_torch.core.burst import split_burst
from repro_torch.core.offload import (AccelModel, Breakdown,
                                      execution_breakdown, plan_offload,
                                      staged_bytes)
from repro_torch.core.workload import KernelSpec, total_flops
from repro_torch.platforms import Platform, get_platform, list_platforms
from repro_torch.platforms.base import interp_power_log

PlatformLike = Union[str, Platform]


def interp_power(table: dict[int, float], size_bytes: int) -> float:
    """Log-linear interpolation of a power-vs-size table (Table II):
    linear in log(size), so the geometric-mean size maps to the
    arithmetic-mean power."""
    return interp_power_log(table, size_bytes)


def imax_power(lmm_bytes: int, kernel: str = "fp16", lanes: int = 1,
               platform: PlatformLike = "imax3-28nm") -> float:
    """Table-II power at an arbitrary LMM size, interpolated on the
    platform's power curves."""
    return get_platform(platform).power.power(kernel, lmm_bytes,
                                              lanes=lanes)


def pdp(latency_s: float, power_w: float) -> float:
    """Power-Delay Product (paper Eq. 1), in joules."""
    return latency_s * power_w


def phase_pdp(breakdown, accel_power_w: float,
              host_power_w: Optional[float] = None) -> float:
    """Phase-wise energy: the accelerator draws power only while a kernel
    is resident (EXEC+LOAD+CONF); the host CPU draws power for the whole
    run (orchestration + residual + fallback). This is the accounting
    that reproduces the paper's published Fig-5 Q8_0 PDP (12.6 J), which
    nominal-power x latency (Eq 1: 11.1 x 1.32 = 14.7 J) does not — their
    §IV-A notes power was measured per phase."""
    if host_power_w is None:
        host_power_w = get_platform("cortex-a72").power.nominal_w
    return (accel_power_w * breakdown.accel_s
            + host_power_w * breakdown.total_s)


# ----------------------------------------------------------------------------
# Calibration to the paper's observables
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Calibration:
    model: AccelModel
    residuals: dict[str, float]   # relative errors vs paper observables
    platform: Optional[Platform] = None   # target carrying the model


def calibrate_imax(work_fp16: Sequence[KernelSpec],
                   work_q8: Sequence[KernelSpec],
                   budget_bytes: Optional[int] = None,
                   conf_share: float = 0.04,
                   platform: PlatformLike = "imax3-28nm/32k",
                   host: PlatformLike = "cortex-a72") -> Calibration:
    """Closed-form fit of (flops_rate, mem_bw, conf_time, host_rate) to
    ``platform``'s *FP16* observables only; the Q8_0 observables are then
    **predictions** and their residuals are the cross-validation of the
    model.

    FP16 observables used: E2E latency 13.5 s, EXEC share 60.89 %, host-
    only latency 24.4 s — all read from the platform registry entries.
    ``conf_share`` apportions the paper's unlabeled CONF/REGV/RANGE/
    REFILL sliver of Fig 7 (~4 % of accel time)."""
    plat = get_platform(platform)
    hostp = get_platform(host)
    if budget_bytes is None:
        budget_bytes = plat.vmem_budget
    t16 = plat.paper_observable("latency_s", "fp16")
    t8 = plat.paper_observable("latency_s", "q8_0")
    s16 = plat.paper_observable("exec_share", "fp16")
    s8 = plat.paper_observable("exec_share", "q8_0")
    host16 = hostp.paper_observable("latency_s", "fp16")
    host8 = hostp.paper_observable("latency_s", "q8_0")
    missing = [k for k, v in [("latency fp16", t16), ("latency q8", t8),
                              ("exec_share fp16", s16),
                              ("exec_share q8", s8),
                              ("host latency fp16", host16),
                              ("host latency q8", host8)] if v is None]
    if missing:
        raise ValueError(
            f"platform {plat.name!r}/{hostp.name!r} lacks the paper "
            f"observables needed for calibration: {missing}")

    f_total = total_flops(list(work_fp16))
    host_rate16 = f_total / host16
    host_rate8 = total_flops(list(work_q8)) / host8

    plan16 = plan_offload(work_fp16, budget_bytes)
    b16 = sum(staged_bytes(s) * s.calls for s in plan16.accel)
    calls16 = sum(s.calls for s in plan16.accel)
    f_off16 = sum(s.flops * split_burst(s.k).offload_fraction
                  for s in plan16.accel)
    f_host16 = f_total - f_off16
    host_s16 = f_host16 / host_rate16

    accel16 = max(t16 - host_s16, 1e-9)        # EXEC + LOAD + CONF
    exec_s = accel16 * s16
    conf_total = accel16 * conf_share
    load16 = accel16 - exec_s - conf_total

    model = AccelModel(
        name=f"{plat.name}(calibrated)",
        flops_rate=f_off16 / exec_s,
        mem_bw=b16 / load16,
        conf_time=conf_total / max(calls16, 1),
        host_flops_rate=(host_rate16 + host_rate8) / 2,
    )
    # fp16 residuals close by construction; q8 rows are predictions.
    bd16 = execution_breakdown(work_fp16, model, budget_bytes)
    bd8 = execution_breakdown(work_q8, model, budget_bytes)
    residuals = {
        "latency_fp16(fit)": bd16.total_s / t16 - 1.0,
        "exec_share_fp16(fit)": bd16.exec_share / s16 - 1.0,
        "latency_q8(pred)": bd8.total_s / t8 - 1.0,
        "exec_share_q8(pred)": bd8.exec_share / s8 - 1.0,
    }
    return Calibration(model=model, residuals=residuals,
                       platform=plat.with_accel_model(model))


# ----------------------------------------------------------------------------
# LMM / VMEM-budget sweep (Fig 6)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepPoint:
    budget_bytes: int
    latency_s: float
    power_w: float
    pdp_j: float
    breakdown: Breakdown


def lmm_sweep(work: Sequence[KernelSpec], model: AccelModel, kernel: str,
              budgets: Sequence[int] = tuple(k * 1024 for k in (16, 32, 64, 128)),
              lanes: int = 1,
              platform: PlatformLike = "imax3-28nm") -> list[SweepPoint]:
    """Latency/power/PDP vs local-memory budget (Fig 6). Larger budgets
    admit more kernels (less host fallback) but cost static power
    (the platform's Table-II curves); the paper's minimum is at 32 KB."""
    plat = get_platform(platform)
    out = []
    for budget in budgets:
        bd = execution_breakdown(work, model, budget)
        p = plat.power.power(kernel, budget, lanes=lanes)
        out.append(SweepPoint(budget, bd.total_s, p, pdp(bd.total_s, p), bd))
    return out


# ----------------------------------------------------------------------------
# Projection onto the port's card (a platform row beyond the paper)
# ----------------------------------------------------------------------------

#: seconds a replayed kernel launch costs on the card: 174.05 ms of device
#: time over 47,403 launches in a replayed zamba2-7b decode tick
#: (``python -m repro_torch.breakdown --arch zamba2-7b``; NVIDIA H100
#: 80GB HBM3, power limit 700.00 W), where almost every kernel is
#: launch-sized
H100_LAUNCH_S = 174.05e-3 / 47_403


def accel_model_for(platform: PlatformLike = "h100-sxm",
                    efficiency: float = 0.5,
                    conf_time: float = H100_LAUNCH_S) -> AccelModel:
    """The port's card as the 'accelerator' of the paper's model, from
    the platform's own entries: the bf16 tensor-core rate derated by
    ``efficiency`` for the small-GEMM regime, the device memory rate,
    one kernel launch per call (``conf_time``) and, as the 'host'
    path, the f32 rate of the CUDA cores."""
    plat = get_platform(platform)
    return AccelModel(
        name=plat.name,
        flops_rate=plat.peak_flops("bf16") * efficiency,
        mem_bw=plat.memory.main_bw,
        conf_time=conf_time,
        host_flops_rate=plat.peak_flops("f32"),
    )


def platform_pdp_table(work_fp16, work_q8, calib: Calibration,
                       budget_bytes: int = 32 * 1024) -> list[dict]:
    """Fig 4 + Fig 5 in one table, iterating the platform registry:
    every platform carrying published observables (paper rows) + our
    calibrated IMAX model + the projection onto the port's card
    (``h100-sxm``, ``accel_model_for``)."""
    rows = []
    for name in list_platforms():
        plat = get_platform(name)
        lat = plat.paper.get("latency_s", {})
        for kern in sorted(lat):
            power = plat.platform_power(kern)
            rows.append(dict(
                device=plat.family, platform=plat.name, kernel=kern,
                latency_s=lat[kern], power_w=power,
                pdp_j=pdp(lat[kern], power),
                pdp_paper_j=plat.paper_observable("pdp_j", kern),
                source="paper"))
    imax = get_platform("imax3-28nm")
    for kern, work in (("fp16", work_fp16), ("q8_0", work_q8)):
        bd = execution_breakdown(work, calib.model, budget_bytes)
        power = imax.power.power(kern, budget_bytes)
        rows.append(dict(device=f"{imax.family}(model)",
                         platform=imax.name, kernel=kern,
                         latency_s=bd.total_s, power_w=power,
                         pdp_j=pdp(bd.total_s, power),
                         pdp_phase_j=phase_pdp(bd, power), source="model"))
    card = get_platform("h100-sxm")
    model = card.accel_model or accel_model_for(card)
    for kern, work in (("fp16", work_fp16), ("q8_0", work_q8)):
        bd = execution_breakdown(work, model, card.vmem_budget)
        # utilization-scaled power
        util = bd.exec_s / max(bd.total_s, 1e-12)
        power = card.power.power(kern, util=util)
        rows.append(dict(device=f"{card.name}(projection)",
                         platform=card.name, kernel=kern,
                         latency_s=bd.total_s, power_w=power,
                         pdp_j=pdp(bd.total_s, power), source="model"))
    return rows
