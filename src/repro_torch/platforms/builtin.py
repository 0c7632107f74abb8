"""Builtin platform definitions — every target the port knows (the JAX
package's ``platforms/builtin.py``, and the port's own card).

Seeded on package import:

* ``imax3-28nm/{16k,32k,64k,128k,256k}`` — the paper's 28nm-ASIC CGLA at
  each Table-II LMM size (``imax3-28nm`` aliases the 32 KB PDP-optimum);
* ``imax3-fpga``    — the measured FPGA prototype (140 MHz, board power);
* ``cortex-a72``    — the paper's host CPU (no offload surface);
* ``jetson-agx-orin`` / ``rtx-4090`` — the paper's GPU comparison points;
* ``h100-sxm``      — the NVIDIA H100 SXM the port runs on.

Measured numbers come from ``repro_torch.platforms.paper`` (kept
verbatim); compute/bandwidth rates for the non-IMAX targets are nominal
datasheet figures — they only feed the roofline-style serving energy
estimates, never the paper-reproduction checks.
"""

from __future__ import annotations

from repro_torch.platforms import paper
from repro_torch.platforms.base import MemoryHierarchy, Platform, PowerModel
from repro_torch.platforms.registry import register_platform

__all__ = ["register_builtin_platforms", "IMAX_LMM_SIZES"]

IMAX_LMM_SIZES = tuple(sorted(paper.IMAX_POWER_FP16_W))   # 16k..256k bytes

# one IMAX lane: 64 PEs x 2 FLOP/cycle (mul+acc) at the clock
_IMAX_LANE_FLOPS = paper.IMAX_PES_PER_LANE * 2.0


def _paper_obs(device: str) -> dict:
    """Published Fig-4/Fig-5 observables for one device, keyed by
    kernel family."""
    obs: dict = {}
    for (dev, kern), v in paper.PAPER_LATENCY_S.items():
        if dev == device:
            obs.setdefault("latency_s", {})[kern] = v
    for (dev, kern), v in paper.PAPER_PDP_J.items():
        if dev == device:
            obs.setdefault("pdp_j", {})[kern] = v
    return obs


def _imax_asic(lmm_bytes: int) -> Platform:
    kb = lmm_bytes // 1024
    # Figs 4/5 were measured on the 32 KB PDP-optimum configuration; the
    # other LMM sizes carry only the Fig-7 EXEC shares (size-independent).
    obs = _paper_obs("imax3-28nm") if lmm_bytes == 32 * 1024 else {}
    obs["exec_share"] = dict(paper.PAPER_EXEC_SHARE)
    return Platform(
        name=f"imax3-28nm/{kb}k",
        family="imax3-28nm",
        kind="cgla",
        memory=MemoryHierarchy(
            local_bytes=lmm_bytes,
            main_bytes=4 * 1024**3,
            main_bw=19.2e9,            # DDR4-2400 channel feeding the lanes
        ),
        power=PowerModel(
            nominal_w=paper.IMAX_POWER_FP16_W[lmm_bytes],
            curves={"fp16": paper.IMAX_POWER_FP16_W,
                    "q8_0": paper.IMAX_POWER_Q8_W},
        ),
        compute={"f32": _IMAX_LANE_FLOPS * paper.IMAX_ASIC_FREQ_HZ},
        freq_hz=paper.IMAX_ASIC_FREQ_HZ,
        paper=obs,
        # the paper's PDP optimum; every other size is an explicit opt-in
        aliases=("imax3-28nm",) if lmm_bytes == 32 * 1024 else (),
        notes="paper Table II synthesis point (per-lane power)",
    )


#: NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU datasheet (dense
#: rates, no sparsity) and the Hopper tuning guide (shared memory per
#: block). These rates assume the card's full 700 W power limit.
H100_SXM = Platform(
    name="h100-sxm",
    family="h100",
    kind="gpu",
    memory=MemoryHierarchy(
        local_bytes=232_448,          # 227 KB of shared memory per block
        main_bytes=80 * 10**9,        # 80 GB HBM3
        main_bw=3.35e12,              # 3.35 TB/s
        link_bw=450e9,                # NVLink 900 GB/s, 450 GB/s each way
    ),
    power=PowerModel(nominal_w=700.0),
    compute={
        "bf16": 989e12,
        "f16": 989e12,
        "int8": 1979e12,
        "f32": 67e12,                 # CUDA cores, outside the tensor cores
    },
    aliases=("h100",),
    notes="NVIDIA H100 SXM datasheet figures; the card may run below "
          "its 700 W limit, which lowers what it reaches",
)


def register_builtin_platforms() -> None:
    for lmm in IMAX_LMM_SIZES:
        register_platform(_imax_asic(lmm))

    register_platform(Platform(
        name="imax3-fpga",
        family="imax3-fpga",
        kind="cgla",
        memory=MemoryHierarchy(local_bytes=32 * 1024,
                               main_bytes=4 * 1024**3, main_bw=19.2e9),
        power=PowerModel(nominal_w=paper.PLATFORM_POWER_W["imax3-fpga"]),
        compute={"f32": _IMAX_LANE_FLOPS * paper.IMAX_FPGA_FREQ_HZ},
        freq_hz=paper.IMAX_FPGA_FREQ_HZ,
        notes="measured prototype; board-level power (Sec IV)",
    ))

    register_platform(Platform(
        name="cortex-a72",
        family="cortex-a72",
        kind="cpu",
        memory=MemoryHierarchy(local_bytes=0,    # host: no offload surface
                               main_bytes=4 * 1024**3, main_bw=12.8e9),
        power=PowerModel(nominal_w=paper.PLATFORM_POWER_W["cortex-a72"]),
        compute={"f32": 48e9, "f16": 48e9},      # 4 cores x NEON, ~1.5 GHz
        paper=_paper_obs("cortex-a72"),
        notes="the paper's host CPU (whisper.cpp two-thread baseline)",
    ))

    register_platform(Platform(
        name="jetson-agx-orin",
        family="jetson-agx-orin",
        kind="gpu",
        memory=MemoryHierarchy(local_bytes=0,
                               main_bytes=32 * 1024**3, main_bw=204.8e9),
        power=PowerModel(nominal_w=paper.PLATFORM_POWER_W["jetson-agx-orin"]),
        compute={"f32": 5.3e12, "f16": 10.6e12, "int8": 85e12},
        paper=_paper_obs("jetson-agx-orin"),
        notes="15 W power mode (paper Sec IV)",
    ))

    register_platform(Platform(
        name="rtx-4090",
        family="rtx-4090",
        kind="gpu",
        memory=MemoryHierarchy(local_bytes=0,
                               main_bytes=24 * 1024**3, main_bw=1008e9),
        power=PowerModel(nominal_w=paper.PLATFORM_POWER_W["rtx-4090"]),
        compute={"f32": 82.6e12, "f16": 165.2e12, "int8": 660.6e12},
        paper=_paper_obs("rtx-4090"),
        notes="450 W TDP (paper Sec IV)",
    ))

    register_platform(H100_SXM)
