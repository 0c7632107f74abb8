"""repro_torch.staticcheck on the CPU: the clean tree passes every
invariant, every waiver of the port's toml is exercised, and each seeded
violation class (a pool rebuilt as a copy, a host read inside a tick, a
host-sync call in a scanned source, an f32 plane leak, a backend-less
op, a stale footprint spec, served weights rebuilt at admission) is
caught under its check ID. The port's per-program verdicts equal the
reference's (``repro.staticcheck``'s own harness, traced here) for every
program both trace, and SC-REG / SC-FOOT cover the same ops."""

import ast
import inspect
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.workload import KernelSpec
from repro_torch.kernels import registry
from repro_torch.kernels.api import dispatch
from repro_torch.kernels.registry import KernelOp
from repro_torch.quantize import quantize_q8_0
from repro_torch.staticcheck import StaticcheckConfig, run_all
from repro_torch.staticcheck.__main__ import main
from repro_torch.staticcheck.config import Waiver, _pattern_match
from repro_torch.staticcheck.donation import check_donation
from repro_torch.staticcheck.dtypeplanes import check_dtype_planes
from repro_torch.staticcheck.footprint import (check_footprint,
                                               check_registry,
                                               representative_calls)
from repro_torch.staticcheck.harness import build_engine, program_from_fn
from repro_torch.staticcheck.recompile import check_recompile
from repro_torch.staticcheck.report import Report
from repro_torch.staticcheck.run import ALL_CHECKS, apply_waivers
from repro_torch.staticcheck.syncpoints import (check_program_sync,
                                                scan_source)
from repro_torch.staticcheck.trace import trace_call

PLANE_DIMS = (4, 64, 16, 32)   # harness pool: n_slots, max_len, enc_len, dh
BF16_WAIVER = "*decode_block[*bf16]:bfloat16(*"


# ------------------------------------------------------------- clean tree

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The checks run thousands of small ops: with torch's intra-op
    threads one per core in every test worker, they wait on each other's
    spinning threads (7.5 s alone on one thread, minutes beside five
    other workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def clean_report() -> Report:
    return run_all(device="cpu")


def test_clean_tree_passes(clean_report):
    assert clean_report.ok, clean_report.human()
    assert clean_report.failed_checks() == []
    assert sorted(clean_report.by_check()) == sorted(ALL_CHECKS)


def test_verdicts_match_dynamic_decode_tests(clean_report):
    """The verdicts assert what ``tests/test_torch_graph.py`` and the
    card's captured-tick tests observe at run time: buffers kept in
    place, sync-free programs, intact dtype planes for the prefill, the
    tick and the cross-cache extension of both pool layouts."""
    funcs = clean_report.function_verdicts()
    for dt in ("q8_0", "bf16"):
        for fn in ("prefill", "decode_block", "extend_cross_cache",
                   "paged_prefill", "paged_decode_block",
                   "paged_extend_cross"):
            v = funcs[f"{fn}[{dt}]"]
            assert v == {"donation": True, "sync_free": True,
                         "dtype_planes": True}, (fn, dt, v)
    assert funcs["frontend_gemm"]["sync_free"] is True
    recomp = [f for f in clean_report.findings if f.check == "SC-RECOMP"]
    assert len(recomp) == 24 and all(f.ok for f in recomp)


def test_waivers_are_exercised(clean_report):
    """Every waiver of the port's toml waives at least one finding of the
    CPU run (a dead waiver is a stale exception that must be pruned), and
    every per-op footprint band is needed: its op's ratio lies outside
    the default band and inside its own."""
    cfg = StaticcheckConfig.load()
    assert cfg.waivers and cfg.op_ratios
    for w in cfg.waivers:
        assert any(f.waived and w.matches(f.check, f.subject, "cpu")
                   for f in clean_report.findings), f"dead waiver: {w}"
    foot = {f.subject: f for f in clean_report.findings
            if f.check == "SC-FOOT"}
    for op, bands in cfg.op_ratios.items():
        for kind, (lo, hi) in bands.items():
            r = foot[op].data[kind]
            d_lo, d_hi = (cfg.flops_ratio if kind == "flops_ratio"
                          else cfg.bytes_ratio)
            assert lo <= r <= hi and not d_lo <= r <= d_hi, (op, kind, r)


def test_bf16_ticks_upcast_on_the_cpu_only(clean_report):
    """The one device waiver: every bf16 tick widens its K/V planes on
    the CPU (no CPU kernel for ``aten::bmm.dtype``), and nothing else
    does."""
    waived = [f for f in clean_report.findings
              if f.data.get("waiver_device") == "cpu"]
    assert {f.subject.split(":")[0] for f in waived} == {
        "decode_block[bf16]", "paged_decode_block[bf16]",
        "decode_block[qwen3-4b|bf16]",
        "decode_block[qwen3-moe-30b-a3b|bf16]",
        "decode_block[zamba2-7b|bf16]"}
    assert all(f.check == "SC-DTYPE" and "aten::bmm.dtype" in
               f.waiver_reason for f in waived)
    # the same findings fail a run whose device has bmm.dtype
    cfg = StaticcheckConfig.load()
    assert all(cfg.waiver_for(f.check, f.subject, "cuda") is None
               for f in waived)


# ------------------------------------------------------ the reference

@pytest.fixture(scope="module")
def reference_report() -> Report:
    """The reference's program verdicts from its own harness, for the
    engines the port traces (not its ``run_all``, whose SC-RECOMP fails
    on the CPU: ROADMAP queue 3, item 5)."""
    from repro.staticcheck import StaticcheckConfig as RefConfig
    from repro.staticcheck import harness as rh
    from repro.staticcheck.donation import check_donation as r_don
    from repro.staticcheck.dtypeplanes import (
        check_dtype_planes as r_dtype, check_recurrent_state as r_rec)
    from repro.staticcheck.run import apply_waivers as r_waive
    from repro.staticcheck.syncpoints import check_program_sync as r_sync

    cds = ("q8_0", "q4_0", "bf16")
    engines = [rh.build_engine(cd) for cd in cds]
    engines.append(rh.build_spec_engine("q4_0"))
    family = rh.build_family_engines(("bf16",))
    family.append(rh.build_engine("q8_0", arch="qwen3-moe-30b-a3b"))
    programs = []
    for i, eng in enumerate(engines):
        programs.extend(rh.hot_programs(eng, frontend=(i == 0)))
    for eng in family:
        programs.extend(rh.hot_programs(eng, frontend=False))
    for cd in cds:
        programs.extend(rh.paged_hot_programs(rh.build_paged_engine(cd)))
    findings = r_don(programs) + r_sync(programs) + r_dtype(programs) \
        + r_rec(family)
    return Report(r_waive(findings, RefConfig.load()))


def test_verdicts_equal_the_reference(clean_report, reference_report):
    ours = clean_report.function_verdicts()
    ref = reference_report.function_verdicts()
    assert set(ours) == set(ref)
    for name in ref:
        assert ours[name] == ref[name], (name, ours[name], ref[name])
    # where the port's verdict rests on its CPU-only waiver
    cpu = {f.subject.split(":")[0] for f in clean_report.findings
           if f.waived and f.data.get("waiver_device") == "cpu"}
    assert cpu and all(ref[name]["dtype_planes"] for name in cpu)
    assert all(f.passed for f in reference_report.findings)


def _returned_keys(fn) -> set:
    """The keys of the dict literal ``fn`` returns (read from its source:
    the reference's representative calls are jax arrays)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    (ret,) = [n.value for n in ast.walk(tree)
              if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret.keys}


def test_registry_checks_cover_the_reference_ops():
    from repro.kernels import registry as ref_registry
    from repro.staticcheck.footprint import \
        representative_calls as ref_calls

    assert registry.list_ops() == ref_registry.list_ops()
    assert set(representative_calls()) == _returned_keys(ref_calls) \
        == _returned_keys(representative_calls)
    assert [f.subject for f in check_registry()] == ref_registry.list_ops()


# ------------------------------------------------- seeded violations

def _pool():
    return {"k": torch.zeros((4, 64, 2, 32), dtype=torch.bfloat16),
            "v": torch.zeros((4, 64, 2, 32), dtype=torch.bfloat16)}


def _rebind(pool, x):
    for key in pool:
        pool[key] = pool[key] + x


def _copy_back(pool, x):
    for key in pool:
        pool[key].copy_(pool[key] + x)


def _in_place(pool, x):
    for key in pool:
        pool[key].add_(x)


@pytest.mark.parametrize("fn,kept,copies", [(_rebind, 0, True),
                                            (_copy_back, 2, True),
                                            (_in_place, 2, False)])
def test_seeded_pool_copy_fails_sc_don(fn, kept, copies):
    """A pool rebuilt as a copy fails, rebound or copied back; the same
    update in place passes."""
    pool = _pool()
    prog = program_from_fn("prefill", fn, pool, torch.tensor(1.0),
                           handed=lambda: dict(pool))
    (f,) = check_donation([prog])
    assert f.check == "SC-DON" and f.ok is (kept == 2 and not copies)
    assert f.data["in_place"] == kept and f.data["donated"] == 2
    assert bool(f.data["pool_copies"]) is copies


def test_seeded_item_in_tick_fails_sc_sync():
    def tick(x):
        n = int(x.sum().item())    # a host read inside the tick
        return x * n

    bad = program_from_fn("bad_tick", tick, torch.ones(4))
    good = program_from_fn("good_tick", lambda x: x * x.sum(), torch.ones(4))
    bad_f, good_f = check_program_sync([bad, good])
    assert bad_f.check == "SC-SYNC" and not bad_f.ok
    assert "aten._local_scalar_dense" in bad_f.detail
    assert good_f.ok


def test_seeded_host_reads_fail_sc_ast():
    src = textwrap.dedent("""
        import torch

        class Engine:
            def tick(self, x):
                t = x.cpu()
                torch.cuda.synchronize()
                return float(t) + x.item()
    """)
    findings = scan_source("fake.py", src, "src/repro_torch/serving/fake.py")
    bad = {(f.data["call"], f.ok) for f in findings}
    assert bad == {(".cpu", False), ("torch.cuda.synchronize", False),
                   ("float", False), (".item", False)}


def test_inventoried_sync_site_passes_sc_ast():
    src = textwrap.dedent("""
        class ServeEngine:
            def step_fetch(self, pending):
                return pending.cpu().numpy()
    """)
    findings = scan_source("engine.py", src,
                           "src/repro_torch/serving/engine.py")
    assert len(findings) == 2
    assert all(f.ok and "inventory" in f.detail for f in findings)


def test_seeded_f32_plane_leak_fails_sc_dtype():
    plane = torch.zeros((16, 64, 32), dtype=torch.int8)   # a q8 pool plane
    bad = program_from_fn("bad_q8_read",
                          lambda p: p.to(torch.float32).sum(), plane,
                          plane_dims=PLANE_DIMS, cache_dtypes=("int8",))
    (f,) = check_dtype_planes([bad])
    assert f.check == "SC-DTYPE" and not f.ok
    assert f.subject == "bad_q8_read:int8(16, 64, 32)"


def test_small_activation_upcast_passes_sc_dtype():
    x = torch.zeros((4, 32), dtype=torch.bfloat16)   # per-token activation
    good = program_from_fn("activation", lambda a: a.to(torch.float32) * 2,
                           x, plane_dims=PLANE_DIMS,
                           cache_dtypes=("bfloat16",))
    (f,) = check_dtype_planes([good])
    assert f.ok


def test_plane_read_into_a_smaller_f32_result_passes_sc_dtype():
    """An op that takes the plane as stored into a smaller f32 result
    (a product or a reduction with an f32 output) does not materialise
    it."""
    plane = torch.ones((16, 64, 32), dtype=torch.bfloat16)
    good = program_from_fn("reduce", lambda p: p.sum(-1, dtype=torch.float32),
                           plane, plane_dims=PLANE_DIMS,
                           cache_dtypes=("bfloat16",))
    (f,) = check_dtype_planes([good])
    assert f.ok


def test_seeded_backendless_op_fails_sc_reg():
    op = KernelOp(
        name="test_cuda_only",
        spec=lambda x: KernelSpec("test_cuda_only", m=1, n=1, k=1,
                                  dtype="f32"),
        backends={"cuda": lambda x: x})
    registry.register(op)
    try:
        (f,) = check_registry(["test_cuda_only"])
        assert f.check == "SC-REG" and not f.ok
        assert "no host backend" in f.detail
    finally:
        registry._REGISTRY.pop("test_cuda_only")


def test_seeded_stale_count_fails_sc_foot():
    # the spec claims 500x the flops the backend executes
    op = KernelOp(
        name="test_bloated_gemm",
        spec=lambda x, w: KernelSpec(
            "test_bloated_gemm", m=x.shape[0], n=w.shape[1],
            k=x.shape[1], dtype="f32", count=500),
        backends={"torch": lambda x, w: x @ w})
    registry.register(op)
    try:
        x = torch.ones((8, 64))
        w = torch.ones((64, 32))
        (f,) = check_footprint(StaticcheckConfig(),
                               op_names=["test_bloated_gemm"],
                               reps={"test_bloated_gemm": ((x, w), {})})
        assert f.check == "SC-FOOT" and not f.ok
        assert f.data["flops_ratio"] < 0.01
    finally:
        registry._REGISTRY.pop("test_bloated_gemm")


def test_seeded_weights_rebuilt_at_admission_fail_sc_recomp():
    eng = build_engine("q8_0", device="cpu")
    good = check_recompile(eng)
    assert [f.subject for f in good] == ["decode_block[q8_0]",
                                         "prefill[q8_0]"]
    assert all(f.ok for f in good), [f.detail for f in good]
    eng = build_engine("q8_0", device="cpu")
    prefill = eng._prefill_device

    def rebuilding(*a):
        eng._served = eng.model.prepare_serving(eng.params)
        return prefill(*a)

    eng._prefill_device = rebuilding
    bad = check_recompile(eng)
    assert not any(f.ok for f in bad)
    assert "REBUILT" in bad[0].detail and bad[1].data["weight_allocs"]


def test_waiver_turns_exactly_that_violation_into_a_pass():
    pool, other = _pool(), _pool()
    progs = [program_from_fn(name, _rebind, p, torch.tensor(1.0),
                             handed=lambda p=p: dict(p))
             for name, p in (("waived_prog", pool), ("other_prog", other))]
    findings = check_donation(progs)
    assert not any(f.ok for f in findings)
    cfg = StaticcheckConfig(waivers=[
        Waiver("SC-DON", "waived_prog", "seeded-violation test")])
    rep = Report(apply_waivers(findings, cfg))
    assert rep.findings[0].waived and rep.findings[0].passed
    assert rep.findings[0].waiver_reason == "seeded-violation test"
    assert not rep.findings[1].passed and not rep.ok


def test_device_waiver_holds_on_its_device_only():
    pool = _pool()
    prog = program_from_fn("cpu_prog", _rebind, pool, torch.tensor(1.0),
                           handed=lambda: dict(pool))
    cfg = StaticcheckConfig(waivers=[
        Waiver("SC-DON", "cpu_prog", "seeded", device="cpu")])
    assert Report(apply_waivers(check_donation([prog]), cfg, "cpu")).ok
    assert not Report(apply_waivers(check_donation([prog]), cfg,
                                    "cuda")).ok


def test_pattern_match_is_literal_with_star():
    assert _pattern_match("prefill[q8_0]:bfloat16*",
                          "prefill[q8_0]:bfloat16(2, 1, 64, 2, 32)")
    assert _pattern_match(BF16_WAIVER,
                          "paged_decode_block[bf16]:bfloat16(4, 64, 4, 32)")
    assert not _pattern_match(BF16_WAIVER,
                              "decode_block[q8_0]:bfloat16(4, 64, 4, 32)")
    assert not _pattern_match("prefill[q8_0]:*", "prefill[x]:foo")
    assert not _pattern_match("a.b", "axb")


def test_a_kernel_call_is_one_node():
    """A dispatched op with a kernel of its own is one ``kernel:`` node;
    its plain version's ops on the CPU are recorded inside it."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = quantize_q8_0(torch.from_numpy(
        rng.standard_normal((64, 32)).astype(np.float32)), axis=0)
    out, nodes = trace_call(dispatch, "q8_matmul", x, w)
    top = [n for n in nodes if not n.kernel]
    assert [n.op for n in top] == ["kernel:q8_matmul"]
    assert top[0].outputs[0].shape == (4, 32)
    assert all(n.kernel == "q8_matmul" for n in nodes if n is not top[0])
    assert len(nodes) > 1 and out.shape == (4, 32)


# ------------------------------------------------------------------ CLI

def test_cli_fast_checks_json_roundtrip():
    out = subprocess.run([sys.executable, "-m", "repro_torch.staticcheck",
                          "--only", "SC-AST,SC-REG", "--json", "-"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["ok"] is True and doc["failed_checks"] == []
    assert doc["checks"] == {"SC-AST": True, "SC-REG": True}
    assert len(doc["findings"]) == 15 + len(registry.list_ops())


def test_cli_lists_the_ids_and_rejects_an_unknown_one(capsys):
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(ALL_CHECKS)
    with pytest.raises(SystemExit) as e:
        main(["--only", "SC-DON,SC-NOPE"])
    assert e.value.code != 0 and "SC-NOPE" in capsys.readouterr().err
