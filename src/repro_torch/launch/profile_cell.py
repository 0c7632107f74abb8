"""Perf-loop profiler of the port (the JAX package's
``launch/profile_cell.py``): trace one cell through ``launch.dryrun`` and
print its heaviest ops by bytes and its heaviest collectives, each with
the module of the port that issued it (one rank's figures).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
        --arch mixtral-8x7b --shape train_4k [--top 25] [--device cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from repro_torch.launch import dryrun
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(dryrun.SHAPES))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the fake tensors stand for")
    args = ap.parse_args(argv)
    rec = dryrun.dryrun_cell(args.arch, args.shape,
                             multi_pod=args.multi_pod, n_micro=args.n_micro,
                             device=args.device)
    if rec["status"] != "ok":
        print(rec)
        return 0
    cost = rec["cost"]
    print(f"\n== top {args.top} ops by bytes (per rank) ==")
    for b, op, shape, where in cost.top_instructions(args.top):
        print(f"  {b / 1e9:9.3f} GB  {op:28s} {shape:34.34s} {where[:60]}")
    print("\n== top collectives by operand bytes (per rank) ==")
    for b, op, shape, where in cost.top_collectives(15):
        print(f"  {b / 1e9:9.3f} GB  {op:28s} {shape:34.34s} {where[:60]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
