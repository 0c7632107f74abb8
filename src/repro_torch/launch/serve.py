"""Serving launcher of the port: the continuous-batching engine over
synthetic requests, on the card (the JAX package's ``launch/serve.py``).

Enc-dec archs (whisper-*) get synthetic encoder frames per request;
decoder-only archs (qwen3-4b, qwen3-moe-30b-a3b, gemma2-2b, mixtral-8x7b,
deepseek-7b, codeqwen1.5-7b, xlstm-350m) serve token requests through
the same scheduler. Weights are seeded random (``--seed``): the dense
and MoE families' are drawn on ``--device`` and stored in bf16, the
dtype every product takes them in; the others' are drawn in f32 on the
CPU.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --requests 4 --slots 4 [--reduced] [--max-len 512] [--max-new 32] \\
        [--decode-block 8] [--q8] [--cache-dtype q8_0] [--spec-k 4] \\
        [--platform h100-sxm] [--device cuda]

``--decode-block K`` fuses K decode steps per scheduler tick (one host
fetch a tick; tokens identical for any K). ``--spec-k K`` decodes
self-speculatively: K - 1 draft tokens a round from Q4_0-quantized
weights, verified in one forward (``--decode-block`` a multiple of K;
the greedy tokens of plain decode). ``--platform`` names a
registered hardware target (``repro_torch.platforms``): the dispatch
context is derived from it and the run ends with its energy report.
``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
versions of the kernels on the CPU.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--q8", action="store_true",
                    help="serve Q8_0-quantized weights (not xLSTM)")
    ap.add_argument("--cache-dtype", choices=["bf16", "q8_0", "q4_0"],
                    default="bf16",
                    help="KV-cache storage; recurrent lanes take bf16 only")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding: draft spec_k-1 "
                         "tokens with q4_0-quantized weights and verify "
                         "all spec_k in one forward a round "
                         "(decode-block must be a multiple; the greedy "
                         "tokens of plain decode)")
    ap.add_argument("--enc-len", type=int, default=64,
                    help="encoder-state pool length (enc-dec models)")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode steps fused per tick (one host fetch a "
                         "tick)")
    ap.add_argument("--platform", default=None,
                    help="registered hardware target (repro_torch."
                         "platforms, e.g. h100-sxm); drives dispatch and "
                         "enables the energy report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build
    from repro_torch.serving.engine import (AudioRequest, Request,
                                            ServeEngine)
    from repro_torch.serving.scheduler import BatchScheduler

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.q8 and cfg.xlstm:
        raise SystemExit(f"--q8: {cfg.name}'s xLSTM blocks cast their "
                         f"weights per call and take no Q8_0 weights; "
                         f"serve it without --q8")
    model = build(cfg)
    if cfg.enc_dec or cfg.xlstm:
        params = model.init_values(torch.Generator().manual_seed(args.seed),
                                   device=args.device)
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = model.init_values(gen, device=args.device,
                                   dtype=torch.bfloat16)
    if args.q8:
        params = model.quantize(params)
        print("serving Q8_0-quantized weights")
    if args.cache_dtype in ("q8_0", "q4_0"):
        print(f"serving a {args.cache_dtype.upper()}-quantized KV cache")
    if args.spec_k:
        print(f"self-speculative decoding: spec_k={args.spec_k}")
    if args.platform:
        from repro_torch.platforms import get_platform
        plat = get_platform(args.platform)   # fail fast on unknown names
        print(f"serving on platform {plat.name} "
              f"(LMM/VMEM budget {plat.vmem_budget} B)")
    engine = ServeEngine(model, params, n_slots=args.slots,
                         max_len=args.max_len, enc_len=args.enc_len,
                         cache_dtype=args.cache_dtype,
                         decode_block=args.decode_block,
                         spec_k=args.spec_k, platform=args.platform,
                         device=args.device)
    sched = BatchScheduler(engine)

    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        n = int(rng.integers(4, min(64, args.max_len - args.max_new - 1)))
        toks = rng.integers(3, cfg.vocab, size=n).tolist()
        if cfg.enc_dec:
            frames = rng.standard_normal(
                (int(rng.integers(4, args.enc_len + 1)), cfg.d_model)
            ).astype(np.float32) * 0.5
            sched.submit(AudioRequest(uid=uid, tokens=toks,
                                      max_new=args.max_new, eos_id=-1,
                                      enc_frames=frames))
        else:
            sched.submit(Request(uid=uid, tokens=toks,
                                 max_new=args.max_new, eos_id=-1))

    t0 = time.monotonic()
    sched.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.monotonic() - t0
    m = sched.metrics
    total_tokens = sum(len(st.out) for st in sched.results.values())
    print(f"{m.completed}/{args.requests} requests in {m.ticks} ticks "
          f"({dt:.1f}s on {engine.device}), {total_tokens} tokens, "
          f"occupancy {m.mean_occupancy:.2f}, mean TTFT {m.mean_ttft:.1f} "
          f"ticks, {total_tokens / dt:.1f} tok/s, decode block "
          f"{args.decode_block} ({engine._host_syncs} decode host syncs)")
    if args.platform:
        er = engine.energy_report("q8_0" if args.q8 else "fp16")
        print(f"energy[{er['platform']}]: {er['joules_per_token']:.3e} "
              f"J/token, PDP {er['pdp_j']:.3e} J "
              f"(power {er['power_w']:.3f} W, {er['bound']}-bound, "
              f"cache stream {er['cache_energy_j']:.3e} J, "
              f"accel share {er['accel_flops_share']:.0%})")
    return m


if __name__ == "__main__":
    main()
