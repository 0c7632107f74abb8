"""How the dense GEMM's layouts were sized: each tile shape and GEMV
cluster timed at the main path's shapes beside ``torch.matmul``.

    python -m repro_torch.kernels.fp16_matmul.probe

Needs a CUDA device and ``nvcc``. Calls the kernel's C entry point with
each wgmma tile shape (``p0`` = 0, 1, 2: 128x128, 64x128, 64x64) at the
encoder's and the prefill's shapes, and with GEMV column groups of 16
bytes a warp (``p0``) times CTAs a cluster splitting K (``p1``) at the
decoder's shapes and the xLSTM head; each result is held to the plain
version first, then timed as 20 calls captured in a CUDA graph (the
card's time without the host's). The wrapper's ``plan`` is printed
beside each row; the last line is one JSON object.
"""

from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fp16_matmul import ops, plain

TILES = ((1500, 384, 1536), (1500, 1536, 384), (1500, 384, 384),
         (32, 384, 1536), (32, 1536, 384))
GEMVS = ((1, 384, 384), (1, 384, 1536), (1, 1536, 384), (4, 384, 1536),
         (4, 1536, 384), (16, 1536, 384), (4, 1024, 51200))


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls replayed from a
    CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _case(x, w, layout, p0, p1) -> float:
    """graph_ms of the kernel in one layout, after holding it to the
    plain version (one bf16 rounding, or f32 summation order)."""
    (m, k), n = x.shape, w.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    codes = build.DTYPE_CODES

    def run():
        rc = ops._kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, n,
                           k, codes[x.dtype], codes[w.dtype], codes[x.dtype],
                           layout, p0, p1, build.stream(x.device))
        build.check(rc, "fp16_matmul")
    run()
    want = plain.fp16_matmul(x, w, x.dtype).float()
    rel = 2 ** -7 if x.dtype == torch.bfloat16 else 1e-5
    err = float((y.float() - want).abs().max())
    if err > rel * float(want.abs().max()):
        raise AssertionError(f"({m},{k})@({k},{n}) layout {layout} "
                             f"{p0}/{p1}: error {err}")
    return graph_ms(run)


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"gpu: {smi}")
    sms = build.sm_count(dev)
    rows = []
    for m, k, n in TILES + GEMVS:
        xd = torch.float32 if n == 51200 else torch.bfloat16
        x = torch.randn(m, k, device=dev, generator=gen).to(xd)
        w = (torch.randn(k, n, device=dev, generator=gen)
             * k ** -0.5).to(torch.bfloat16)
        wl = w.to(xd)
        lib = graph_ms(lambda: torch.matmul(x, wl))
        chosen = ops.plan(m, n, k, xd, w.dtype, sms)
        if m > ops.GEMV_MAX_M:
            times = {f"tile {p0}": _case(x, w, ops.TILE, p0, 0)
                     for p0 in (ops.TILE_WIDE, ops.TILE_MID,
                                ops.TILE_NARROW)}
        else:
            times = {f"gemv {cgw}/{ranks}": _case(x, w, ops.GEMV, cgw, ranks)
                     for cgw in (4, 8, 16, 32) for ranks in (1, 2, 4, 8)
                     if 8 <= build.cdiv(n, cgw * 8) * ranks <= 2048}
        rows.append({"shape": [m, k, n], "plan": list(chosen),
                     "library_graph_ms": lib, "graph_ms": times})
        print(f"({m},{k})@({k},{n}) plan={chosen} library={lib:.4f} "
              + " ".join(f"{key}={t:.4f}" for key, t in times.items()),
              flush=True)
    print(json.dumps({"gpu": smi, "rows": rows}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.kernels.fp16_matmul.probe needs a "
                         "CUDA device")
    main()
