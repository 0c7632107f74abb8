"""``python -m repro_torch.staticcheck`` -- run the port's hot-path
invariant checks.

Exit status is 0 iff every finding passes (or carries a reviewed
waiver); on failure the offending check IDs are named on stderr.
``--json`` writes the machine-readable report. The engines run on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.staticcheck.config import StaticcheckConfig
from repro_torch.staticcheck.run import ALL_CHECKS, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck",
        description="Static hot-path invariant checker of the port.")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="emit the JSON report to PATH ('-' = stdout)")
    ap.add_argument("--only", default=None, metavar="IDS",
                    help="comma-separated check IDs "
                         f"(default: all of {','.join(ALL_CHECKS)})")
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="staticcheck.toml path (default: the port's)")
    ap.add_argument("--verbose", action="store_true",
                    help="list passing findings too")
    ap.add_argument("--list", action="store_true",
                    help="list check IDs and exit")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the engines run (default: cuda)")
    args = ap.parse_args(argv)

    if args.list:
        for c in ALL_CHECKS:
            print(c)
        return 0

    only = set(args.only.split(",")) if args.only else None
    if only and not only <= set(ALL_CHECKS):
        ap.error(f"unknown check IDs: {sorted(only - set(ALL_CHECKS))} "
                 f"(known: {', '.join(ALL_CHECKS)})")
    config = StaticcheckConfig.load(args.config)
    report = run_all(config=config, only=only, device=args.device)

    if args.json == "-":
        print(report.to_json())
    else:
        print(report.human(verbose=args.verbose))
        if args.json:
            with open(args.json, "w") as fh:
                fh.write(report.to_json())
            print(f"wrote {args.json}")
    if not report.ok:
        print(f"FAILED CHECKS: {', '.join(report.failed_checks())}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
