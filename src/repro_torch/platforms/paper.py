"""The paper's measured and nominal hardware constants (Ando et al.
2025, Tables I–IV, Figs 4/5/7), verbatim from the JAX package's
``platforms/paper.py``.

Pure data: the single source the builtin platform registry
(``repro_torch.platforms.builtin``) is seeded from. Code reaches hardware
facts through ``repro_torch.platforms.get_platform(...)`` instead of
reading these tables directly. These are the paper's figures for the
paper's devices, never measurements of the port.
"""

from __future__ import annotations

# ----------------------------------------------------------------------------
# Paper constants (Ando et al. 2025)
# ----------------------------------------------------------------------------

# Table II: IMAX ASIC (28nm) power by LMM size, per one-lane configuration.
# Keys are LMM bytes. (Sec III-C quotes 0.665/0.675 W for FP16 16/32KB; Table II
# and Sec IV-A quote 0.637/0.647 W — we follow Table II / Sec IV-A.)
IMAX_POWER_FP16_W = {
    16 * 1024: 0.637,
    32 * 1024: 0.647,
    64 * 1024: 2.16,
    128 * 1024: 5.18,
    256 * 1024: 11.2,
}
IMAX_POWER_Q8_W = {
    16 * 1024: 1.28,   # not printed for 16KB; extrapolated from the 32KB ratio
    32 * 1024: 1.32,
    64 * 1024: 4.41,
    128 * 1024: 10.6,
    256 * 1024: 22.9,
}

IMAX_ASIC_FREQ_HZ = 840e6
IMAX_FPGA_FREQ_HZ = 140e6
IMAX_PES_PER_LANE = 64

# Table III / Sec IV platform power (W).
PLATFORM_POWER_W = {
    "cortex-a72": 0.6485,
    "imax3-fpga": 180.0,
    "jetson-agx-orin": 15.0,
    "rtx-4090": 450.0,
}

# Fig 4: end-to-end latency (seconds), two-thread execution, jfk.wav (~10s).
PAPER_LATENCY_S = {
    ("cortex-a72", "fp16"): 24.4,
    ("cortex-a72", "q8_0"): 19.6,
    ("imax3-28nm", "fp16"): 13.5,
    ("imax3-28nm", "q8_0"): 11.1,
    ("jetson-agx-orin", "fp16"): 1.6,
    ("jetson-agx-orin", "q8_0"): 1.6,
    ("rtx-4090", "fp16"): 0.49,
    ("rtx-4090", "q8_0"): 0.50,
}

# Fig 5: PDP (J), two-thread execution.
PAPER_PDP_J = {
    ("imax3-28nm", "fp16"): 13.6,
    ("imax3-28nm", "q8_0"): 12.6,
    ("jetson-agx-orin", "fp16"): 24.0,
    ("jetson-agx-orin", "q8_0"): 24.0,   # paper quotes 1.90x vs 12.6 -> 23.9
    ("rtx-4090", "fp16"): 120.1,
    ("rtx-4090", "q8_0"): 123.9,         # 9.83x vs 12.6
}

# Sec V-C: dot-product operation counts per transcription run.
PAPER_DOT_COUNTS = {"tiny": 477_153, "base": 644_690, "small": 1_920_955}

# Table I (paper): cumulative kernel coverage (%) by LMM limit.
PAPER_TABLE1 = {
    # limit_bytes: (fp16_baseline, fp16_opt, q8_baseline, q8_opt)
    8 * 1024: (0.00, 64.96, 0.00, 64.96),
    16 * 1024: (1.39, 66.35, 1.39, 66.35),
    32 * 1024: (1.39, 93.80, 28.83, 93.80),
    64 * 1024: (93.81, 93.80, 93.81, 93.81),
    128 * 1024: (94.49, 100.00, 97.24, 100.00),
    256 * 1024: (100.00, 100.00, 100.00, 100.00),
}

# Table IV (paper): optimized coverage by LMM for tiny/base/small.
PAPER_TABLE4 = {
    "tiny": {16: 66.35, 32: 93.80, 64: 93.80, 128: 100.00, 256: 100.00},
    "base": {16: 66.55, 32: 66.54, 64: 94.17, 128: 97.08, 256: 99.89},
    "small": {16: 66.53, 32: 66.52, 64: 94.36, 128: 96.89, 256: 99.89},
}

# Fig 7: EXEC share of IMAX kernel time.
PAPER_EXEC_SHARE = {"fp16": 0.6089, "q8_0": 0.7470}
