"""Gateway launcher of the port: async SLO-aware serving under a seeded
Poisson load, on the card (the JAX package's ``launch/gateway.py``).

Spins up the asyncio ``Gateway`` over a ``ServeEngine`` and offers an
open-loop Poisson workload (mixed one-shot audio and streaming
sessions, SLO mix across interactive/standard/batch), then prints the
wall-clock serving summary: p50/p99 TTFT and end-to-end latency in
seconds, streaming chunk lag, **goodput** (completed-within-deadline
requests/s), shed counts by reason code, and — with ``--platform`` —
J/audio-s from the platform energy model.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.gateway \\
        --arch whisper-tiny-en --reduced --rate 20 --requests 32 \\
        --slots 4 [--decode-block 8] [--stream-fraction 0.25] \\
        [--queue-limit 64] [--no-shed] [--platform imax3-28nm/32k] \\
        [--seed 0] [--device cuda]

Same request set, any arrival rate or admission order → identical
tokens (``repro_torch.gateway.loadgen.sync_baseline`` is the oracle).
Weights are seeded random (``--seed``). ``--device`` defaults to
``cuda``; ``--device cpu`` runs the plain versions of the kernels on the
CPU.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean Poisson arrival rate, requests/s")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--enc-len", type=int, default=64)
    ap.add_argument("--decode-block", type=int, default=4,
                    help="decode steps fused per tick (one host sync)")
    ap.add_argument("--stream-fraction", type=float, default=0.25,
                    help="fraction of requests served as streaming "
                         "sessions")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="admission-queue bound (backpressure sheds)")
    ap.add_argument("--max-admit", type=int, default=2,
                    help="prefills per tick boundary")
    ap.add_argument("--no-shed", action="store_true",
                    help="disable the unmeetable-deadline submit shed")
    ap.add_argument("--cache-dtype", choices=["bf16", "q8_0"],
                    default="bf16")
    ap.add_argument("--platform", default=None,
                    help="registered hardware target (repro_torch."
                         "platforms; enables the J/audio-s energy report)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="print the full metrics summary as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.gateway import LoadSpec, run_load
    from repro_torch.models.model import build
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if not cfg.enc_dec:
        ap.error(f"--arch {args.arch}: the gateway load generator "
                 f"synthesizes audio workloads; pick an enc-dec "
                 f"(whisper-*) arch")
    model = build(cfg)
    params = model.init_values(torch.Generator().manual_seed(args.seed),
                               device=args.device)
    engine = ServeEngine(model, params, n_slots=args.slots,
                         max_len=args.max_len, enc_len=args.enc_len,
                         cache_dtype=args.cache_dtype,
                         decode_block=args.decode_block,
                         platform=args.platform, device=args.device)
    spec = LoadSpec(rate_rps=args.rate, n_requests=args.requests,
                    seed=args.seed, stream_fraction=args.stream_fraction,
                    max_new=args.max_new)
    print(f"offering {args.requests} requests at {args.rate:.1f} rps "
          f"(Poisson, seed {args.seed}, "
          f"{args.stream_fraction:.0%} streaming) to "
          f"{args.slots} slots x decode_block {args.decode_block} on "
          f"{engine.device}")
    results, summary, gw = run_load(
        engine, spec, queue_limit=args.queue_limit,
        max_admit_per_tick=args.max_admit,
        shed_on_submit=not args.no_shed)

    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
        return summary
    t, e = summary["ttft_s"], summary["e2e_s"]
    print(f"{summary['completed']}/{summary['requests']} completed "
          f"({summary['completed_in_deadline']} in deadline, "
          f"{summary['shed_total']} shed {summary['shed'] or '{}'}) "
          f"in {summary['wall_s']:.2f}s over {summary['ticks']} ticks")
    print(f"goodput {summary['goodput_rps']:.2f} req/s "
          f"(throughput {summary['throughput_rps']:.2f}), "
          f"{summary['tokens']} tokens, "
          f"{summary['audio_s']:.1f}s audio served")
    print(f"TTFT p50/p99 {t['p50']:.3f}/{t['p99']:.3f}s, "
          f"e2e p50/p99 {e['p50']:.3f}/{e['p99']:.3f}s, "
          f"stream lag mean {summary['stream_lag_s']['mean']:.3f}s "
          f"({summary['stream_lag_s']['chunks']} chunks)")
    print(f"one host sync per tick: "
          f"{engine._host_syncs == engine._ticks} "
          f"({engine._host_syncs} syncs / {engine._ticks} ticks)")
    if "energy" in summary:
        en = summary["energy"]
        print(f"energy[{en['platform']}]: "
              f"{en['joules_per_audio_s']:.3e} J/audio-s, "
              f"{en['joules_per_token']:.3e} J/token, "
              f"PDP {en['pdp_j']:.3e} J")
    return summary


if __name__ == "__main__":
    main()
