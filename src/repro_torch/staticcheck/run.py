"""Orchestration: build the hot-path harness, run every check, apply the
waivers, return one ``Report`` (the JAX package's ``staticcheck/run.py``).

Check inventory (the reference's IDs; the waivers and the JSON report
key on them):

==========  ==============================================================
SC-DON      every buffer a hot-path program is handed is updated in place
            (its storage kept, no pool-sized copy)
SC-SYNC     no host sync inside a hot-path program (on the card, no
            synchronising CUDA call either)
SC-AST      source scan: host-sync calls outside the sync inventory
SC-DTYPE    no plane-sized f32 upcast of a storage-dtype plane; recurrent
            carry dtype-stable across the tick
SC-RECOMP   one CUDA graph per tick size, no recapture on an admission;
            the served weights built once
SC-FOOT     registry analytic flops/bytes match what the host backend runs
SC-REG      every kernel op is host-servable (a ``torch`` backend)
==========  ==============================================================
"""

from __future__ import annotations

from typing import Optional

from repro_torch.platforms import resolve_device
from repro_torch.staticcheck.config import StaticcheckConfig, repo_root
from repro_torch.staticcheck.donation import check_donation
from repro_torch.staticcheck.dtypeplanes import check_dtype_planes, \
    check_recurrent_state
from repro_torch.staticcheck.footprint import check_footprint, check_registry
from repro_torch.staticcheck.harness import DECODE_BLOCK
from repro_torch.staticcheck.recompile import check_recompile
from repro_torch.staticcheck.report import Finding, Report
from repro_torch.staticcheck.syncpoints import check_ast_syncs, \
    check_program_sync

ALL_CHECKS = ("SC-DON", "SC-SYNC", "SC-AST", "SC-DTYPE", "SC-RECOMP",
              "SC-FOOT", "SC-REG")
# checks that need traced hot-path programs / a live engine
_PROGRAM_CHECKS = {"SC-DON", "SC-SYNC", "SC-DTYPE"}


def apply_waivers(findings: list[Finding], config: StaticcheckConfig,
                  device: Optional[str] = None) -> list[Finding]:
    """Waive each failed finding a waiver of ``config`` covers on the
    run's ``device`` type (None: any waiver)."""
    for f in findings:
        if f.ok:
            continue
        w = config.waiver_for(f.check, f.subject, device)
        if w is not None:
            f.waived = True
            f.waiver_reason = w.reason
            if w.device:
                f.data["waiver_device"] = w.device
    return findings


def _selected(only: Optional[set]) -> set:
    selected = set(only) if only else set(ALL_CHECKS)
    unknown = selected - set(ALL_CHECKS)
    if unknown:
        raise ValueError(f"unknown check IDs: {sorted(unknown)} "
                         f"(known: {list(ALL_CHECKS)})")
    return selected


def check_engines(engines: list, paged_engines: list = (),
                  family_engines: list = (), only: Optional[set] = None,
                  frontend: bool = True) -> list[Finding]:
    """The program checks and SC-RECOMP of the given engines (no lane
    active in any), unwaived. The engines are traced once; SC-RECOMP
    then admits into them."""
    from repro_torch.staticcheck.harness import hot_programs, \
        paged_hot_programs

    selected = _selected(only)
    findings: list[Finding] = []
    if selected & _PROGRAM_CHECKS:
        programs = []
        for i, eng in enumerate(engines):
            # one frontend trace is enough: it has no cache planes
            programs.extend(hot_programs(eng, frontend=frontend and i == 0))
        for eng in family_engines:
            programs.extend(hot_programs(eng, frontend=False))
        for eng in paged_engines:
            programs.extend(paged_hot_programs(eng))
        if "SC-DON" in selected:
            findings.extend(check_donation(programs))
        if "SC-SYNC" in selected:
            findings.extend(check_program_sync(programs))
        if "SC-DTYPE" in selected:
            findings.extend(check_dtype_planes(programs))
            findings.extend(check_recurrent_state(family_engines))
    if "SC-RECOMP" in selected:
        for eng in [*engines, *family_engines, *paged_engines]:
            findings.extend(check_recompile(eng))
    return findings


def run_all(config: Optional[StaticcheckConfig] = None,
            only: Optional[set] = None,
            cache_dtypes: tuple = ("q8_0", "q4_0", "bf16"),
            root: Optional[str] = None, device=None) -> Report:
    """Run the selected checks (default: all) and return the Report. The
    engines run on ``device`` (default ``cuda``; the CPU only when asked),
    the source scan and the registry checks on the host; waivers apply
    by that device. ``only`` is a set of check IDs; unknown IDs raise."""
    config = config or StaticcheckConfig.load()
    selected = _selected(only)
    root = root or repo_root()
    findings: list[Finding] = []
    # the source scan and the registry checks run on the host
    dev_type = "cpu"
    if selected & (_PROGRAM_CHECKS | {"SC-RECOMP"}):
        from repro_torch.staticcheck.harness import build_engine, \
            build_family_engines
        device = resolve_device(device)
        dev_type = device.type
        engines = [build_engine(cd, device=device) for cd in cache_dtypes]
        # the self-speculative draft-verify tick: its program carries the
        # q4 draft weights, so the checks see the draft's products and
        # the accept-mask rollback
        engines.append(build_engine("q4_0", device=device,
                                    spec_k=DECODE_BLOCK))
        paged_engines = [build_engine(cd, device=device, paged=True)
                         for cd in cache_dtypes]
        # model-zoo coverage: every served family at bf16, plus one q8_0
        # twin (the MoE arch), so the quantized tier is exercised on a
        # non-whisper family
        family_engines = build_family_engines(("bf16",), device)
        family_engines.append(build_engine("q8_0", "qwen3-moe-30b-a3b",
                                           device))
        findings.extend(check_engines(engines, paged_engines,
                                      family_engines, selected))
    if "SC-AST" in selected:
        findings.extend(check_ast_syncs(root))
    if "SC-FOOT" in selected:
        findings.extend(check_footprint(config))
    if "SC-REG" in selected:
        findings.extend(check_registry())
    apply_waivers(findings, config, dev_type)
    return Report(findings)


def bench_record(device=None) -> dict:
    """The invariant slice a benchmark record carries: the program
    checks, the source scan and the registry, plus the per-function
    verdict map."""
    rep = run_all(only={"SC-DON", "SC-SYNC", "SC-AST", "SC-DTYPE",
                        "SC-REG"}, device=device)
    d = rep.to_dict()
    return {"ok": d["ok"], "checks": d["checks"],
            "failed_checks": d["failed_checks"],
            "functions": d["functions"]}

