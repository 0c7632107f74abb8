"""How the Q4_0 GEMV's plan was sized: every GEMV layout timed at the
speculative draft's shapes beside the library call, and what its parts
cost.

    python -m repro_torch.kernels.q4_matmul.probe [--plan-only]

Needs a CUDA device and ``nvcc``. Builds ``csrc/q4_matmul.cu`` once for
each ``Q4_PROBE`` value (all ``nvcc`` processes started together, into a
``probe-<hash>`` directory beside the port's kernel builds):

* 0: the shipped kernel;
* 1: the GEMV without its loads and its products (the sums across
  lanes, warps and ranks, the store);
* 2: the launch alone (each CTA stores zeros);
* 3: the loads of w, x and the scales without the products.

Build 0 runs in the tensor-core GEMV and in the CUDA-core GEMV with 1 or
2 column groups of 16 a warp (``cgw``), each with 4 or 8 warps a CTA and
1, 2, 3, 4, 6 or 8 CTAs a cluster splitting K (where the entry point
takes them), and in the plan's, at the
draft's shapes (1 and 4 lanes against the MLP up, the MLP down and wo of
whisper-tiny.en), and in the row tile; each result is held to the plain
version first, then timed as 20 calls captured in a CUDA graph (the
card's time without the host's). Builds 1-3 run the plan's layout and
the fastest one. ``--plan-only`` times the plan's layout and the row
tile alone. The library call is ``torch.matmul`` on the
dequantized bf16 weight. The wrapper's ``plan`` is printed beside each
shape with its time and its rank among the layouts; the last line is
one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fp16_matmul.probe import graph_ms
from repro_torch.kernels.q4_matmul import ops, plain
from repro_torch.quantize import dequantize_q4_0, quantize_q4_0

SHAPES = ((4, 384, 1536), (4, 1536, 384), (4, 384, 384), (1, 384, 1536),
          (1, 1536, 384), (1, 384, 384))
BUILDS = {0: "shipped",
          1: "no loads, no products: the sums and the store",
          2: "launch alone",
          3: "loads without products"}


def build_probes() -> tuple[dict, dict]:
    """One entry point per probe value, built in parallel; and each
    build's ``-Xptxas -v`` lines."""
    out = build.build_dir().parent / f"probe-{build.build_dir().name}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {k: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-DQ4_PROBE={k}", "-o",
         str(out / f"libq4_probe{k}.so"),
         str(build.CSRC / build.SOURCES["q4_matmul"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in BUILDS}
    fns, ptxas = {}, {}
    for k, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for Q4_PROBE={k}:\n{log}")
        ptxas[k] = [ln.strip() for ln in log.splitlines()
                    if re.search(r"Compiling entry|Used \d+ registers|spill",
                                 ln)]
        fn = ctypes.CDLL(str(out / f"libq4_probe{k}.so")).q4_matmul
        fn.argtypes = ops._ARGTYPES
        fn.restype = ctypes.c_int
        fns[k] = fn
    return fns, ptxas


def _case(fn, x, w, layout, cgw, warps, ranks, check=True) -> float:
    """graph_ms of the entry point ``fn`` in one layout, after holding it
    to the plain version (one bf16 rounding of the largest output)."""
    (m, k), n = x.shape, w.q.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    code = build.DTYPE_CODES[x.dtype]

    def run():
        rc = fn(x.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(),
                y.data_ptr(), m, n, k, code, code, layout, cgw, warps, ranks,
                build.stream(x.device))
        build.check(rc, "q4_matmul")
    run()
    if check:
        want = plain.q4_matmul(x, w.q, w.scale, torch.float32)
        err = float((y.float() - want).abs().max())
        if err > 2 ** -7 * float(want.abs().max()):
            raise AssertionError(f"({m},{k})@({k},{n}) layout {layout} "
                                 f"{cgw}/{warps}/{ranks}: error {err}")
    return graph_ms(run)


def _name(layout, cgw, warps, ranks) -> str:
    if layout == ops.ROWS:
        return "rows"
    if layout == ops.MMA:
        return f"mma {warps}/{ranks}"
    return f"gemv {cgw}/{warps}/{ranks}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan-only", action="store_true")
    plan_only = ap.parse_args().plan_only
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"gpu: {smi}")
    fns, ptxas = build_probes()
    for ln in ptxas[0]:
        print(f"ptxas Q4_PROBE=0: {ln}", flush=True)
    sms = build.sm_count(dev)
    rows = []
    for m, k, n in SHAPES:
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        w = quantize_q4_0(torch.randn(k, n, device=dev, generator=gen)
                          * k ** -0.5, axis=0)
        wd = dequantize_q4_0(w, torch.bfloat16, axis=0)
        lib = graph_ms(lambda: torch.matmul(x, wd))
        chosen = ops.plan(m, n, k, sms)
        configs = {(ops.ROWS, 0, 0, 0), chosen}
        if not plan_only:
            configs |= {(layout, cgw, warps, ranks)
                        for layout, cgw in ((ops.MMA, 0), (ops.GEMV, 1),
                                            (ops.GEMV, 2))
                        for warps in (4, 8) for ranks in (1, 2, 3, 4, 6, 8)
                        if ops.gemv_fits(k, cgw, warps, ranks)}
        times = {_name(*c): _case(fns[0], x, w, *c) for c in sorted(configs)}
        key = _name(*chosen)
        order = sorted(times, key=times.get)
        best = next(c for c in configs if _name(*c) == order[0])
        parts = {f"{key} Q4_PROBE={b}": _case(fns[b], x, w, *chosen, False)
                 for b in (1, 2, 3)}
        if best != chosen:
            parts |= {f"{order[0]} Q4_PROBE={b}": _case(fns[b], x, w, *best,
                                                         False)
                      for b in (1, 2, 3)}
        rows.append({"shape": [m, k, n], "plan": list(chosen),
                     "plan_graph_ms": times[key],
                     "plan_rank": order.index(key) + 1,
                     "library_graph_ms": lib, "graph_ms": times,
                     "parts_graph_ms": parts})
        print(f"({m},{k})@({k},{n}) plan={chosen} plan_ms="
              f"{times[key]:.4f} (rank {order.index(key) + 1} of "
              f"{len(order)}) library={lib:.4f} best: "
              + " ".join(f"{b}={times[b]:.4f}" for b in order[:6])
              + f" rows={times['rows']:.4f}", flush=True)
        print("    parts: " + " ".join(f"{p}={t:.4f}"
                                       for p, t in parts.items()),
              flush=True)
    print(json.dumps({"gpu": smi, "ptxas": ptxas, "rows": rows}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.kernels.q4_matmul.probe needs a CUDA "
                         "device")
    main()
