"""What a step of the ``slstm_scan`` kernel costs: each layout and
cluster size timed, beside measurement builds that take parts out of the
cluster layout's step.

    python -m repro_torch.kernels.slstm_scan.probe [--steps 256]

Needs a CUDA device and ``nvcc``. Builds ``csrc/slstm_scan.cu`` once for
each ``SLSTM_PROBE`` value (all ``nvcc`` processes started together,
into a ``probe-<hash>`` directory beside the port's kernel builds):

* 0: the shipped kernel;
* 1: the cluster layout without the dot: the step's fixed cost (wx, the
  cell update, the hand-over of h to every rank through distributed
  shared memory and the wait for the other ranks' h);
* 2: without the dot and the cell update: the hand-over and the wait;
* 3: without the hand-over either: the step's loads of wx and stores of
  h.

It prints the card's name and power limit, each build's registers,
shared memory and spills (``-Xptxas -v``), how many clusters of 8 and of
16 CTAs the card holds at once (``cudaOccupancyMaxActiveClusters``), and
then, at xlstm-350m's width (H = 4 heads of hd = 256) on 1 lane and on 4
lanes over ``--steps`` steps and over 1 step from a non-initial state:
the one-CTA-per-(lane, head) layout, the cluster layout at 8 and 16 CTAs
with f32 and bf16 R, and builds 1-3 at 8 and 16 CTAs, each as 10
launches replayed from a CUDA graph. Every run of build 0 is first held
to the plain version: the number of outputs that differ from it bit for
bit is printed. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fp16_matmul.probe import graph_ms
from repro_torch.kernels.slstm_scan import ops, plain

BUILDS = {0: "shipped",
          1: "no dot: wx, cell update, hand-over of h",
          2: "no dot, no cell update: hand-over of h",
          3: "no dot, cell update, hand-over: wx loads, h stores"}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def build_probes() -> tuple[dict[int, ctypes.CDLL], dict[int, list[str]]]:
    """One library per probe value, built in parallel; and each build's
    ``-Xptxas -v`` lines for its kernels."""
    out = build.build_dir().parent / f"probe-{build.build_dir().name}"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for k in BUILDS:
        lib = out / f"libslstm_probe{k}.so"
        procs[k] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, f"-DSLSTM_PROBE={k}", "-o", str(lib),
             str(build.CSRC / build.SOURCES["slstm_scan"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for k, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for SLSTM_PROBE={k}:\n{log}")
        ptxas[k] = [ln.strip() for ln in log.splitlines()
                    if re.search(r"Compiling entry|Used \d+ registers|spill",
                                 ln)]
        lib = ctypes.CDLL(str(out / f"libslstm_probe{k}.so"))
        lib.slstm_scan.argtypes = ops._ARGTYPES
        lib.slstm_scan.restype = ctypes.c_int
        lib.slstm_scan_max_clusters.argtypes = [ctypes.c_int] * 2
        lib.slstm_scan_max_clusters.restype = ctypes.c_int
        libs[k] = lib
    return libs, ptxas


def _inputs(s: int, b: int, init: bool, h: int = 4, hd: int = 256,
            seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    wx = torch.randn((s, 4, b, h, hd), device="cuda", generator=g)
    r = torch.randn((4, h, hd, hd), device="cuda", generator=g) * hd ** -0.5
    if init:
        st = torch.zeros((4, b, h, hd), device="cuda")
        st[3] = -1e30
    else:    # c, n > 0, h and a finite m, as a lane's pool state
        st = torch.randn((4, b, h, hd), device="cuda", generator=g)
        st[1] = st[1].abs() + 0.5
    return wx, r, st


def _launcher(lib, wx, r, st, layout, cluster):
    s, _, b, h, hd = wx.shape
    hs = torch.empty((s, b, h, hd), device="cuda")
    out = torch.empty_like(st)

    def run():
        rc = lib.slstm_scan(wx.data_ptr(), r.data_ptr(), st.data_ptr(),
                            hs.data_ptr(), out.data_ptr(), s, b, h, hd,
                            ops.R_DTYPES[r.dtype], layout, cluster,
                            build.stream(wx.device))
        if rc:
            raise RuntimeError(f"slstm_scan probe: CUDA error {rc} (layout "
                               f"{layout}, cluster {cluster})")
        return hs, out
    return run


def _ms(fn) -> float:
    """Mean device time of a launch, 10 launches replayed from a CUDA
    graph (a 1-step launch is shorter than the host's call)."""
    return graph_ms(fn, iters=10)


def differing(got, want) -> int:
    """Outputs of (hs, state) that are not bit-equal to the plain
    version's."""
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("the slstm_scan probe needs a CUDA device")
    card = _smi("name,power.limit")
    print(f"gpu: {card}", flush=True)
    t0 = time.monotonic()
    libs, ptxas = build_probes()
    print(f"built {len(libs)} probe libraries in "
          f"{time.monotonic() - t0:.1f} s", flush=True)
    for k, lines in ptxas.items():
        for ln in lines:
            print(f"ptxas SLSTM_PROBE={k}: {ln}", flush=True)
    occupancy = {c: libs[0].slstm_scan_max_clusters(c, 4) for c in (8, 16)}
    print(f"max active clusters (f32 R, 4 lanes): {occupancy}", flush=True)

    rows = []
    for s, b, init in ((args.steps, 1, True), (args.steps, 4, True),
                       (1, 4, False)):
        wx, r, st = _inputs(s, b, init)
        want = plain.slstm_scan(wx, r, st)
        runs = [(0, "one CTA per (lane, head)", ops.ONE_CTA, 0, r)]
        runs += [(0, f"cluster {c}, {dt} R", ops.CLUSTER, c,
                  r if dt == "f32" else r.to(torch.bfloat16))
                 for c in (8, 16) if occupancy[c] > 0
                 for dt in ("f32", "bf16")]
        runs += [(k, f"cluster {c}", ops.CLUSTER, c, r)
                 for k in (1, 2, 3) for c in (8, 16)
                 if occupancy[c] > 0]
        for k, what, layout, cluster, rr in runs:
            fn = _launcher(libs[k], wx, rr, st, layout, cluster)
            diff = None
            if k == 0:
                ref = want if rr.dtype == torch.float32 else \
                    plain.slstm_scan(wx, rr, st)
                got = fn()
                torch.cuda.synchronize()
                diff = differing(got, ref)
            ms = _ms(fn)
            rows.append({"probe": k, "build": BUILDS[k], "run": what,
                         "lanes": b, "steps": s, "ms": ms,
                         "us_per_step": ms * 1e3 / s,
                         "differing_outputs": diff})
            print(f"SLSTM_PROBE={k} {what} B={b} S={s}: {ms:.4f} ms, "
                  f"{ms * 1e3 / s:.3f} us a step"
                  + ("" if diff is None else
                     f", {diff} outputs not bit-equal to plain"), flush=True)
    print(json.dumps({"gpu": card, "max_active_clusters": occupancy,
                      "ptxas": ptxas, "rows": rows}))


if __name__ == "__main__":
    main()
