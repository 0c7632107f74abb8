"""What limits a step of the ``slstm_scan`` kernel: the shipped build
timed beside measurement builds of the same source.

    python -m repro_torch.kernels.slstm_scan.probe [--steps 256]

Needs a CUDA device and ``nvcc``. Builds ``csrc/slstm_scan.cu`` once for
each ``SLSTM_PROBE`` value (all ``nvcc`` processes started together,
into a ``probe-<hash>`` directory beside the port's kernel builds):

* 0: the shipped kernel: the dot's exact f32 products summed in f64,
  each element of R widened f32 -> f64 as it is read from L2;
* 1: the same with the dot summed in f32 (no conversion);
* 2, 3: 0 and 1 with R's rows taken mod 32, so a block's 128 KB of R
  stays in L1: no step waits on L2;
* 4: no dot at all, the step's fixed cost (wx, cell update, barriers).

Each is timed with CUDA events at xlstm-350m's width (H = 4 heads of
hd = 256) on 1 lane (4 blocks) and on 4 lanes (16 blocks) over ``--steps``
steps, after a check that build 0 agrees with the port's own library on
the same inputs. It prints the card's name, power limit and SM clocks,
the microseconds a step of each build, and the issue floor of build 0's
f32 -> f64 conversions (4 * hd * hd a block a step, 16 a clock per SM
on compute capability 9.0, at the SM clock read while build 0 runs);
the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slstm_scan import ops

BUILDS = {0: "shipped: f64 sum, R from L2",
          1: "f32 sum, R from L2",
          2: "f64 sum, R from L1",
          3: "f32 sum, R from L1",
          4: "no dot: fixed cost"}
CONVERSIONS_PER_CLOCK = 16      # f32 -> f64 per SM a clock, cc 9.0


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def build_probes() -> dict[int, ctypes.CDLL]:
    """One library per probe value, built in parallel."""
    out = build.build_dir().parent / f"probe-{build.build_dir().name}"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for k in BUILDS:
        lib = out / f"libslstm_probe{k}.so"
        if not lib.exists():
            procs[k] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, f"-DSLSTM_PROBE={k}", "-o",
                 str(lib), str(build.CSRC / build.SOURCES["slstm_scan"])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for k, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for SLSTM_PROBE={k}:\n{log}")
    libs = {}
    for k in BUILDS:
        lib = ctypes.CDLL(str(out / f"libslstm_probe{k}.so"))
        lib.slstm_scan.argtypes = ops._ARGTYPES
        lib.slstm_scan.restype = ctypes.c_int
        libs[k] = lib
    return libs


def _inputs(s: int, b: int, h: int = 4, hd: int = 256, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    wx = torch.randn((s, 4, b, h, hd), device="cuda", generator=g)
    r = torch.randn((4, h, hd, hd), device="cuda", generator=g) * hd ** -0.5
    st = torch.zeros((4, b, h, hd), device="cuda")
    st[3] = -1e30
    return wx, r, st


def _launcher(lib, wx, r, st):
    s, _, b, h, hd = wx.shape
    hs = torch.empty((s, b, h, hd), device="cuda")
    out = torch.empty_like(st)
    handle = build.stream(wx.device)

    def run():
        rc = lib.slstm_scan(wx.data_ptr(), r.data_ptr(), st.data_ptr(),
                            hs.data_ptr(), out.data_ptr(), s, b, h, hd,
                            handle)
        if rc:
            raise RuntimeError(f"slstm_scan probe failed: CUDA error {rc}")
        return hs, out
    return run


def _ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the slstm_scan probe needs a CUDA device")
    card = _smi("name,power.limit")
    print(f"gpu: {card}", flush=True)
    t0 = time.monotonic()
    libs = build_probes()
    print(f"built {len(libs)} probe libraries in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    hd, s = 256, args.steps
    rows = []
    for b in (1, 4):
        wx, r, st = _inputs(s, b)
        # build 0 is the port's kernel: same bits as its own library
        want = ops.slstm_scan(wx, r, st)
        got = _launcher(libs[0], wx, r, st)()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("probe build 0 differs from the port's "
                                 "slstm_scan library")
        for k, what in BUILDS.items():
            ms = _ms(_launcher(libs[k], wx, r, st))
            rows.append({"probe": k, "build": what, "lanes": b,
                         "blocks": b * 4, "steps": s, "ms": ms,
                         "us_per_step": ms * 1e3 / s})
            print(f"SLSTM_PROBE={k} ({what}) B={b} ({b * 4} blocks) "
                  f"S={s}: {ms:.4f} ms, {ms * 1e3 / s:.3f} us a step",
                  flush=True)
    # the SM clock under load: read while 200 launches of build 0 queue
    wx, r, st = _inputs(s, 1)
    run = _launcher(libs[0], wx, r, st)
    for _ in range(200):
        run()
    clocks = _smi("clocks.sm,clocks.max.sm")
    torch.cuda.synchronize()
    sm_mhz = float(clocks.split(",")[0].split()[0])
    floor_us = 4 * hd * hd / CONVERSIONS_PER_CLOCK / sm_mhz
    print(f"sm clock now, max: {clocks}", flush=True)
    print(f"f32 -> f64 conversion floor of build 0: {4 * hd * hd} a block "
          f"a step / {CONVERSIONS_PER_CLOCK} a clock at {sm_mhz:.0f} MHz = "
          f"{floor_us:.3f} us a step", flush=True)
    print(json.dumps({"gpu": card, "sm_clocks": clocks,
                      "conversion_floor_us_per_step": floor_us,
                      "rows": rows}))


if __name__ == "__main__":
    main()
