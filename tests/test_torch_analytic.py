"""The port's analytic model (``repro_torch.core``) and platform registry
(``repro_torch.platforms``) against the JAX package's ``repro.core`` and
``repro.platforms`` on the same inputs: integers exactly, floats to 1e-12
relative.

The second half reruns the assertions of the reference's
``tests/test_energy.py``, ``tests/test_burst_footprint.py`` and
``tests/test_platforms.py`` on the port. Left out, because the port does
not carry what they test:

- ``test_platforms.py::test_for_platform_allow_pallas_gated_by_env``
  (``allow_pallas`` and the ``REPRO_ALLOW_PALLAS`` knob);
- ``test_platforms.py::test_from_env_platform`` (the ``REPRO_PLATFORM``
  and ``REPRO_VMEM_BUDGET`` knobs);
- the ``tpu-v5e`` halves of ``test_power_model_curves_and_flat``,
  ``test_peak_flops_fallback_chain``, ``test_builtin_platforms_registered``
  and ``test_energy_report_finite_on_required_platforms``: the port does
  not register ``tpu-v5e``; its own card, ``h100-sxm``, stands in.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core import burst as j_burst
from repro.core import energy as j_energy
from repro.core import footprint as j_fp
from repro.core import offload as j_off
from repro.core import workload as j_wl
from repro.platforms import get_platform as j_get_platform
from repro.platforms import list_platforms as j_list_platforms
from repro_torch.core import burst, energy, footprint, offload, workload
from repro_torch.platforms import (MemoryHierarchy, Platform, PowerModel,
                                   get_platform, list_platforms,
                                   register_platform)
from repro_torch.platforms import paper
from repro_torch.platforms.registry import _ALIASES, _REGISTRY

REL = 1e-12
DIMS = ("WHISPER_TINY", "WHISPER_BASE", "WHISPER_SMALL")


def _same(got, want, path="value"):
    """Integers (and strings, bools) exactly; floats to REL relative;
    dataclasses field by field; dicts, lists and tuples element-wise."""
    if dataclasses.is_dataclass(got):
        assert dataclasses.is_dataclass(want), path
        gf = {f.name: getattr(got, f.name) for f in dataclasses.fields(got)}
        wf = {f.name: getattr(want, f.name)
              for f in dataclasses.fields(want)}
        assert set(gf) == set(wf), (path, set(gf) ^ set(wf))
        for k in gf:
            _same(gf[k], wf[k], f"{path}.{k}")
    elif isinstance(got, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in got:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(got, float) or isinstance(want, float):
        assert got == pytest.approx(want, rel=REL, abs=0.0) \
            or got == want, (path, got, want)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _work(dims: str, dtype: str = "f16"):
    return (workload.whisper_workload(getattr(workload, dims), dtype=dtype),
            j_wl.whisper_workload(getattr(j_wl, dims), dtype=dtype))


def _calib():
    w16 = workload.whisper_workload(workload.WHISPER_TINY, dtype="f16")
    w8 = workload.whisper_workload(workload.WHISPER_TINY, dtype="q8_0")
    return w16, w8, energy.calibrate_imax(w16, w8)


# ------------------------------------------------ the reference, equal


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("dtype", ["f16", "q8_0"])
def test_whisper_workload_equals_the_reference(dims, dtype):
    got, want = _work(dims, dtype)
    _same(got, want, "work")
    _same(getattr(workload, dims), getattr(j_wl, dims), dims)
    for fn in ("total_flops", "total_dot_products", "total_calls",
               "k_length_histogram"):
        _same(getattr(workload, fn)(got), getattr(j_wl, fn)(want), fn)
    _same(list(workload.iter_unique_gemms(got)),
          list(j_wl.iter_unique_gemms(want)), "unique")
    assert [s.calls for s in got] == [s.calls for s in want]
    assert [s.dot_products for s in got] == [s.dot_products for s in want]


@pytest.mark.parametrize("kw", [
    dict(name="qwen3-4b", n_layers=36, d_model=2560, n_heads=32,
         n_kv_heads=8, d_ff=9728, vocab=151936, seq=512, steps=32),
    dict(name="qwen3-moe", n_layers=48, d_model=2048, n_heads=32,
         n_kv_heads=4, d_ff=768, vocab=151936, seq=256, mode="prefill",
         dtype="q8_0", n_experts=128, top_k=8),
    dict(name="xlstm", n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
         d_ff=0, vocab=50304, seq=64)],
    ids=["dense-decode", "moe-prefill-q8", "no-ffn"])
def test_lm_workload_equals_the_reference(kw):
    _same(workload.lm_workload(**kw), j_wl.lm_workload(**kw), "lm")


def test_burst_functions_equal_the_reference():
    assert burst.DEFAULT_BURST == j_burst.DEFAULT_BURST
    for k in (0, 1, 15, 16, 17, 64, 100, 1536, 1500):
        for b in (4, 8, 16, 32, 64):
            _same(burst.split_burst(k, b), j_burst.split_burst(k, b), "split")
            _same(burst.split_burst(k, b).offload_fraction,
                  j_burst.split_burst(k, b).offload_fraction, "frac")
    for dims in DIMS:
        got, want = _work(dims)
        hist = workload.k_length_histogram(got)
        for b in (4, 8, 16, 32, 64, 128):
            _same(burst.offload_rate(hist, b), j_burst.offload_rate(hist, b),
                  f"rate[{dims},{b}]")
            _same(burst.burst_cost(hist, b, t_mac_accel=1.0, t_mac_host=2.76,
                                   t_burst_overhead=0.065),
                  j_burst.burst_cost(hist, b, t_mac_accel=1.0,
                                     t_mac_host=2.76, t_burst_overhead=0.065),
                  f"cost[{dims},{b}]")
        _same(burst.optimal_burst(hist), j_burst.optimal_burst(hist), dims)
    seq = [100, 65, 65, 200, 7]
    _same(burst.offload_rate(seq, 16), j_burst.offload_rate(seq, 16), "seq")


@pytest.mark.parametrize("dims", DIMS)
def test_coverage_tables_equal_the_reference(dims):
    """Tables I and IV: ``coverage_cdf`` under both policies at
    ``LMM_LIMITS``, for the FP16 and Q8_0 models."""
    assert footprint.LMM_LIMITS == j_fp.LMM_LIMITS
    assert footprint.N_TILE == j_fp.N_TILE
    for dtype in ("f16", "q8_0"):
        got, want = _work(dims, dtype)
        for policy in ("baseline", "optimized"):
            assert [footprint.kernel_footprint(s, policy) for s in got] \
                == [j_fp.kernel_footprint(s, policy) for s in want]
            _same(footprint.coverage_cdf(got, policy),
                  j_fp.coverage_cdf(want, policy), f"{dtype}/{policy}")
    for dt in ("f16", "bf16", "f32", "q8_0", "q4_0"):
        assert footprint.elem_bytes(dt) == j_fp.elem_bytes(dt)


def test_select_blocks_equals_the_reference():
    for m in (8, 100, 256, 1024):
        for n in (128, 384, 4096):
            for k in (32, 384, 1536, 8192):
                for budget in (64 * 1024, 256 * 1024, 4 * 1024 * 1024):
                    for dt in ("bf16", "q8_0"):
                        try:
                            want = j_fp.select_blocks(m, n, k, budget, dt)
                        except ValueError:
                            with pytest.raises(ValueError):
                                footprint.select_blocks(m, n, k, budget, dt)
                            continue
                        _same(footprint.select_blocks(m, n, k, budget, dt),
                              want, f"blocks[{m},{n},{k},{budget},{dt}]")
    assert footprint.block_vmem_bytes(64, 128, 256, "q8_0") \
        == j_fp.block_vmem_bytes(64, 128, 256, "q8_0")


def test_offload_planning_equals_the_reference():
    w16, w8, calib = _calib()
    jw16, jw8 = _work("WHISPER_TINY")[1], _work("WHISPER_TINY", "q8_0")[1]
    jcal = j_energy.calibrate_imax(jw16, jw8)
    jmodel = j_off.AccelModel(**dataclasses.asdict(calib.model))
    for work, jwork in ((w16, jw16), (w8, jw8)):
        for budget in (0, 16 * 1024, 32 * 1024, 64 * 1024, 10**9):
            for policy in ("baseline", "optimized"):
                got = offload.plan_offload(work, budget, policy)
                want = j_off.plan_offload(jwork, budget, policy)
                _same(got, want, "plan")
                _same((got.coverage_calls, got.coverage_flops),
                      (want.coverage_calls, want.coverage_flops), "cov")
            bd = offload.execution_breakdown(work, calib.model, budget)
            jbd = j_off.execution_breakdown(jwork, jmodel, budget)
            _same(bd, jbd, "breakdown")
            _same((bd.accel_s, bd.total_s, bd.exec_share),
                  (jbd.accel_s, jbd.total_s, jbd.exec_share), "derived")
        assert [offload.staged_bytes(s) for s in work] \
            == [j_off.staged_bytes(s) for s in jwork]
        assert [offload.offload_decision(s, 32 * 1024) for s in work] \
            == [j_off.offload_decision(s, 32 * 1024) for s in jwork]
    _same(calib.model, jcal.model, "calibrated model")
    _same(calib.residuals, jcal.residuals, "residuals")


def test_energy_functions_equal_the_reference():
    w16, w8, calib = _calib()
    jw16, jw8 = _work("WHISPER_TINY")[1], _work("WHISPER_TINY", "q8_0")[1]
    jcal = j_energy.calibrate_imax(jw16, jw8)
    t = {16384: 1.0, 32768: 2.0}
    for size in (8000, 16384, 23170, 24576, 32768, 50000):
        _same(energy.interp_power(t, size), j_energy.interp_power(t, size),
              "interp")
    for kb in (8, 16, 24, 32, 48, 64, 100, 128, 256, 512):
        for kern in ("fp16", "q8_0"):
            for lanes in (1, 2):
                _same(energy.imax_power(kb * 1024, kern, lanes),
                      j_energy.imax_power(kb * 1024, kern, lanes), "power")
    _same(energy.pdp(11.1, 1.32), j_energy.pdp(11.1, 1.32), "pdp")
    bd = offload.execution_breakdown(w8, calib.model, 32 * 1024)
    jbd = j_off.execution_breakdown(jw8, jcal.model, 32 * 1024)
    _same(energy.phase_pdp(bd, 1.32), j_energy.phase_pdp(jbd, 1.32), "phase")
    _same(energy.phase_pdp(bd, 1.32, 2.0), j_energy.phase_pdp(jbd, 1.32, 2.0),
          "phase host")
    for work, jwork, kern in ((w16, jw16, "fp16"), (w8, jw8, "q8_0")):
        for lanes in (1, 2):
            _same(energy.lmm_sweep(work, calib.model, kern, lanes=lanes),
                  j_energy.lmm_sweep(jwork, jcal.model, kern, lanes=lanes),
                  "sweep")
    # the calibration against another LMM size and the 64 KB platform
    _same(energy.calibrate_imax(w16, w8, budget_bytes=64 * 1024).residuals,
          j_energy.calibrate_imax(jw16, jw8, budget_bytes=64 * 1024).residuals,
          "calib 64k")


def test_platform_pdp_table_equals_the_reference_but_the_projection():
    """The paper rows and the IMAX model rows equal the reference's; the
    projection row is on ``h100-sxm`` (``accel_model_for``), the port's
    card, where the reference's is on its ``tpu-v5e``: a deliberate
    difference, checked apart."""
    w16, w8, calib = _calib()
    jw16, jw8 = _work("WHISPER_TINY")[1], _work("WHISPER_TINY", "q8_0")[1]
    rows = energy.platform_pdp_table(w16, w8, calib)
    jrows = j_energy.platform_pdp_table(
        jw16, jw8, j_energy.calibrate_imax(jw16, jw8))
    proj = [r for r in rows if r["device"].endswith("(projection)")]
    jproj = [r for r in jrows if r["device"].endswith("(projection)")]
    keep = [r for r in jrows if r not in jproj]
    _same([r for r in rows if r not in proj], keep, "rows")
    assert {r["platform"] for r in jproj} == {"tpu-v5e"}
    assert [r["platform"] for r in proj] == ["h100-sxm", "h100-sxm"]
    assert [r["kernel"] for r in proj] == ["fp16", "q8_0"]
    card = get_platform("h100-sxm")
    model = energy.accel_model_for()
    assert model.flops_rate == card.peak_flops("bf16") * 0.5
    assert model.mem_bw == card.memory.main_bw
    assert model.host_flops_rate == card.peak_flops("f32")
    assert model.conf_time == pytest.approx(3.6717e-6, rel=1e-4)
    for r, work in zip(proj, (w16, w8)):
        bd = offload.execution_breakdown(work, model, card.vmem_budget)
        util = bd.exec_s / bd.total_s
        assert r["latency_s"] == bd.total_s
        assert r["power_w"] == card.power.power(r["kernel"], util=util)
        assert r["pdp_j"] == energy.pdp(bd.total_s, r["power_w"])


def test_every_reference_platform_but_tpu_v5e_is_the_ports():
    """Same fields (``allow_pallas`` is not carried), same aliases, same
    families; ``tpu-v5e`` is not registered and ``h100-sxm`` is added."""
    want = set(j_list_platforms()) - {"tpu-v5e"}
    assert set(list_platforms()) == want | {"h100-sxm"}
    for name in sorted(want):
        got, ref = get_platform(name), j_get_platform(name)
        gf = dataclasses.asdict(got)
        rf = dataclasses.asdict(ref)
        assert rf.pop("allow_pallas") in (True, False)
        _same(gf, rf, name)
        for dt in ("f32", "bf16", "f16", "int8", "q8_0"):
            try:
                want_rate = ref.peak_flops(dt)
            except KeyError:
                with pytest.raises(KeyError):
                    got.peak_flops(dt)
                continue
            _same(got.peak_flops(dt), want_rate, f"{name}.peak_flops({dt})")
        for kern in ("fp16", "q8_0"):
            for lanes, util in ((1, 1.0), (2, 0.25)):
                _same(got.platform_power(kern, lanes, util),
                      ref.platform_power(kern, lanes, util),
                      f"{name}.platform_power({kern})")
            for key in ("latency_s", "pdp_j", "exec_share"):
                _same(got.paper_observable(key, kern),
                      ref.paper_observable(key, kern), f"{name}.{key}")
    from repro.platforms import platform_families as j_families
    from repro.platforms import platforms_in_family as j_in_family
    from repro_torch.platforms import platform_families, platforms_in_family
    assert platform_families() == sorted(set(j_families()) - {"tpu-v5e"}
                                         | {"h100"})
    for fam in j_families():
        if fam != "tpu-v5e":
            assert [p.name for p in platforms_in_family(fam)] \
                == [p.name for p in j_in_family(fam)]
    assert get_platform("imax3-28nm").name == "imax3-28nm/32k"
    with pytest.raises(KeyError):
        get_platform("tpu-v5e")
    from repro.platforms import paper as j_paper
    for k in ("IMAX_POWER_FP16_W", "IMAX_POWER_Q8_W", "IMAX_ASIC_FREQ_HZ",
              "IMAX_FPGA_FREQ_HZ", "IMAX_PES_PER_LANE", "PLATFORM_POWER_W",
              "PAPER_LATENCY_S", "PAPER_PDP_J", "PAPER_DOT_COUNTS",
              "PAPER_TABLE1", "PAPER_TABLE4", "PAPER_EXEC_SHARE"):
        _same(getattr(paper, k), getattr(j_paper, k), k)
    assert not any("TPU" in k for k in vars(paper))


def test_headline_ratios_and_model_latency():
    """``benchmarks/fig4_fig5_platforms.py``'s checks: IMAX Q8_0 PDP
    12.6 J is 1.90x better than Orin's and 9.83x than the RTX 4090's
    (within 2 %), and the model's Q8_0 latency is within 15 % of the
    paper's 11.1 s."""
    w16, w8, calib = _calib()
    rows = energy.platform_pdp_table(w16, w8, calib)
    by = {(r["device"], r["kernel"]): r for r in rows}
    imax = by[("imax3-28nm", "q8_0")]["pdp_paper_j"]
    assert by[("jetson-agx-orin", "q8_0")]["pdp_paper_j"] / imax \
        == pytest.approx(1.90, rel=0.02)
    assert by[("rtx-4090", "q8_0")]["pdp_paper_j"] / imax \
        == pytest.approx(9.83, rel=0.02)
    assert by[("imax3-28nm(model)", "q8_0")]["latency_s"] \
        == pytest.approx(11.1, rel=0.15)


# ------------------------------- tests/test_energy.py, rerun on the port


def test_calibration_fits_fp16_observables():
    _, _, calib = _calib()
    assert abs(calib.residuals["latency_fp16(fit)"]) < 0.02
    assert abs(calib.residuals["exec_share_fp16(fit)"]) < 0.02


def test_calibration_predicts_q8_within_tolerance():
    _, _, calib = _calib()
    assert abs(calib.residuals["latency_q8(pred)"]) < 0.35
    assert abs(calib.residuals["exec_share_q8(pred)"]) < 0.35


def test_pdp_minimum_at_32kb():
    w16, w8, calib = _calib()
    for work, kern in ((w16, "fp16"), (w8, "q8_0")):
        pts = energy.lmm_sweep(work, calib.model, kern)
        best = min(pts, key=lambda p: p.pdp_j)
        assert best.budget_bytes == 32 * 1024, \
            [(p.budget_bytes, p.pdp_j) for p in pts]


def test_lmm_16kb_latency_degrades():
    w16, _, calib = _calib()
    pts = {p.budget_bytes: p
           for p in energy.lmm_sweep(w16, calib.model, "fp16")}
    assert pts[16 * 1024].latency_s > pts[32 * 1024].latency_s


def test_power_interpolation_matches_table2():
    assert energy.imax_power(32 * 1024, "fp16") == pytest.approx(0.647)
    assert energy.imax_power(32 * 1024, "q8_0") == pytest.approx(1.32)
    assert energy.imax_power(32 * 1024, "fp16", lanes=2) \
        == pytest.approx(1.294)
    ps = [energy.imax_power(k * 1024, "fp16") for k in (16, 32, 64, 128, 256)]
    assert all(a <= b for a, b in zip(ps, ps[1:]))


def test_pdp_eq1():
    assert energy.pdp(11.1, 1.32) == pytest.approx(14.652)


def test_platform_table_reproduces_paper_ratios():
    w16, w8, calib = _calib()
    rows = energy.platform_pdp_table(w16, w8, calib)
    by = {(r["device"], r["kernel"]): r for r in rows}
    pub = paper.PAPER_PDP_J
    assert pub[("jetson-agx-orin", "q8_0")] / pub[("imax3-28nm", "q8_0")] \
        == pytest.approx(1.90, rel=0.02)
    assert pub[("rtx-4090", "q8_0")] / pub[("imax3-28nm", "q8_0")] \
        == pytest.approx(9.83, rel=0.02)
    eq1_nominal = (paper.PAPER_LATENCY_S[("imax3-28nm", "q8_0")]
                   * paper.IMAX_POWER_Q8_W[32 * 1024])
    assert by[("imax3-28nm(model)", "q8_0")]["pdp_j"] == \
        pytest.approx(eq1_nominal, rel=0.15)


def test_exec_share_shows_compute_bound():
    w16, w8, calib = _calib()
    bd16 = offload.execution_breakdown(w16, calib.model, 32 * 1024)
    bd8 = offload.execution_breakdown(w8, calib.model, 32 * 1024)
    assert bd16.exec_share > 0.55
    assert bd8.exec_share > bd16.exec_share


def test_interp_power_bounds():
    t = {16384: 1.0, 32768: 2.0}
    assert energy.interp_power(t, 8000) == 1.0
    assert energy.interp_power(t, 50000) == 2.0
    assert energy.interp_power(t, round(16384 * 2 ** 0.5)) == pytest.approx(
        1.5, abs=1e-4)
    assert energy.interp_power(t, 24576) == pytest.approx(1.585, abs=1e-3)


def test_interp_power_32k_64k_midpoint():
    lo = paper.IMAX_POWER_FP16_W[32 * 1024]
    hi = paper.IMAX_POWER_FP16_W[64 * 1024]
    geo = round(32 * 1024 * 2 ** 0.5)
    assert energy.imax_power(geo, "fp16") == pytest.approx((lo + hi) / 2,
                                                           rel=1e-4)
    t = 0.5849625007211562      # log2(1.5)
    assert energy.imax_power(48 * 1024, "fp16") == pytest.approx(
        lo + t * (hi - lo), rel=1e-6)
    assert energy.imax_power(48 * 1024, "fp16") > lo + 0.5 * (hi - lo)


# ----------------------- tests/test_burst_footprint.py, rerun on the port


def test_split_exact():
    s = burst.split_burst(100, 16)
    assert (s.k_main, s.k_residual) == (96, 4)
    assert s.k_main % 16 == 0
    assert s.k_main + s.k_residual == 100


@settings(max_examples=100, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([4, 8, 16, 32, 64]))
def test_property_split(k, b):
    s = burst.split_burst(k, b)
    assert s.k_main % b == 0
    assert 0 <= s.k_residual < b
    assert s.k_main + s.k_residual == k


def test_offload_rate_whisper_residual_small():
    hist = workload.k_length_histogram(
        workload.whisper_workload(workload.WHISPER_TINY))
    assert burst.offload_rate(hist, 16) > 0.90


def test_optimal_burst_is_16():
    hist = workload.k_length_histogram(
        workload.whisper_workload(workload.WHISPER_TINY))
    assert burst.optimal_burst(hist).burst == 16


def test_burst_tradeoff_monotonicity():
    hist = {100: 10, 200: 5, 65: 20}
    rates = [burst.offload_rate(hist, b) for b in (4, 8, 16, 32, 64)]
    assert all(a >= b for a, b in zip(rates, rates[1:]))


def test_footprint_policies_ordering():
    for spec in workload.whisper_workload(workload.WHISPER_TINY):
        if spec.n >= 4 * 5:
            assert footprint.kernel_footprint(spec, "optimized") <= \
                footprint.kernel_footprint(spec, "baseline") + 64, spec


def test_coverage_monotone_in_limit():
    work = workload.whisper_workload(workload.WHISPER_TINY)
    for policy in ("baseline", "optimized"):
        pcts = [r.coverage_pct for r in footprint.coverage_cdf(work, policy)]
        assert all(a <= b + 1e-9 for a, b in zip(pcts, pcts[1:]))
    assert footprint.coverage_cdf(work, "optimized")[-1].coverage_pct == \
        pytest.approx(100.0)


def test_table1_structure():
    work = workload.whisper_workload(workload.WHISPER_TINY)
    base = {r.limit_bytes: r.coverage_pct
            for r in footprint.coverage_cdf(work, "baseline")}
    opt = {r.limit_bytes: r.coverage_pct
           for r in footprint.coverage_cdf(work, "optimized")}
    assert base[32 * 1024] < 35.0
    assert opt[32 * 1024] > 90.0
    assert opt[8 * 1024] > 50.0


def test_table4_structure_base_small_need_64k():
    for dims in (workload.WHISPER_BASE, workload.WHISPER_SMALL):
        opt = {r.limit_bytes: r.coverage_pct
               for r in footprint.coverage_cdf(
                   workload.whisper_workload(dims), "optimized")}
        assert opt[32 * 1024] - opt[16 * 1024] < 2.0, dims.name
        assert opt[64 * 1024] - opt[32 * 1024] > 3.0, dims.name
        assert opt[64 * 1024] > 94.0, dims.name
    tiny = {r.limit_bytes: r.coverage_pct
            for r in footprint.coverage_cdf(
                workload.whisper_workload(workload.WHISPER_TINY),
                "optimized")}
    assert tiny[32 * 1024] - tiny[16 * 1024] > 3.0


def test_dot_product_counts_scale_like_paper():
    tiny, base, small = (
        workload.total_dot_products(workload.whisper_workload(d))
        for d in (workload.WHISPER_TINY, workload.WHISPER_BASE,
                  workload.WHISPER_SMALL))
    assert tiny < base < small
    assert 2.5 < small / tiny < 6.0


def test_select_blocks_fits_and_aligned():
    for budget in (256 * 1024, 1024 * 1024, 4 * 1024 * 1024):
        b = footprint.select_blocks(512, 4096, 4096, budget)
        assert b.vmem_bytes <= budget
        assert b.bn % 128 == 0 and b.bm % 8 == 0 and b.bk % 32 == 0


def test_select_blocks_monotone_in_budget():
    sizes = []
    for budget in (128 * 1024, 512 * 1024, 2 * 1024 * 1024, 8 * 1024 * 1024):
        b = footprint.select_blocks(1024, 8192, 8192, budget)
        sizes.append(b.bm * b.bn * b.bk)
    assert all(a <= b for a, b in zip(sizes, sizes[1:]))


def test_select_blocks_raises_when_impossible():
    with pytest.raises(ValueError):
        footprint.select_blocks(8, 128, 32, 128)


@settings(max_examples=30, deadline=None)
@given(st.sampled_from([128, 256, 512, 2048]),
       st.sampled_from([256, 4096, 16384]),
       st.sampled_from([512, 4096]),
       st.sampled_from([262144, 1048576, 8388608]))
def test_property_select_blocks(m, n, k, budget):
    b = footprint.select_blocks(m, n, k, budget)
    assert b.vmem_bytes <= budget
    assert footprint.block_vmem_bytes(b.bm, b.bn, b.bk, "bf16", "bf16") \
        <= budget


# ---------------------------- tests/test_platforms.py, rerun on the port


def test_builtin_platforms_registered():
    names = list_platforms()
    for expected in ("imax3-28nm/16k", "imax3-28nm/32k", "imax3-28nm/64k",
                     "imax3-28nm/128k", "imax3-28nm/256k", "imax3-fpga",
                     "h100-sxm", "cortex-a72", "jetson-agx-orin",
                     "rtx-4090"):
        assert expected in names, names


def test_registry_round_trip():
    p = Platform(name="test-chip/1", family="test-chip", kind="gpu",
                 memory=MemoryHierarchy(local_bytes=1234, main_bw=1e9),
                 power=PowerModel(nominal_w=5.0),
                 compute={"bf16": 1e12},
                 aliases=("test-chip",))
    try:
        assert register_platform(p) is p
        assert get_platform("test-chip/1") is p
        assert get_platform("test-chip") is p
        assert get_platform(p) is p
        assert "test-chip/1" in list_platforms("test-chip")
        with pytest.raises(ValueError, match="already registered"):
            register_platform(dataclasses.replace(p, aliases=()))
        register_platform(dataclasses.replace(p, kind="cpu"),
                          overwrite=True)
        assert get_platform("test-chip/1").kind == "cpu"
    finally:
        _REGISTRY.pop("test-chip/1", None)
        _ALIASES.pop("test-chip", None)


def test_unknown_platform_errors_with_known_names():
    with pytest.raises(KeyError, match="imax3-28nm/32k"):
        get_platform("no-such-chip")


def test_alias_resolves_to_pdp_optimum():
    assert get_platform("imax3-28nm").name == "imax3-28nm/32k"
    assert get_platform("imax3-28nm").vmem_budget == 32 * 1024


def test_power_model_curves_and_flat():
    imax = get_platform("imax3-28nm/32k")
    assert imax.platform_power("fp16") == pytest.approx(0.647)
    assert imax.platform_power("q8_0") == pytest.approx(1.32)
    assert imax.platform_power("q8_0", lanes=2) == pytest.approx(2.64)
    assert imax.power.power("fp16", 48 * 1024) == pytest.approx(
        energy.imax_power(48 * 1024, "fp16"))
    card = get_platform("h100-sxm")
    assert card.power.power(util=0.0) == pytest.approx(0.0)
    assert card.power.power(util=1.0) == pytest.approx(700.0)


def test_peak_flops_fallback_chain():
    card = get_platform("h100-sxm")
    assert card.peak_flops("bf16") == pytest.approx(989e12)
    assert card.peak_flops("q8_0") == pytest.approx(1979e12)   # -> int8
    a72 = get_platform("cortex-a72")
    assert a72.peak_flops("q8_0") == a72.peak_flops("f16")


def test_for_platform_derives_budget_policy_platform():
    from repro_torch.kernels.api import DispatchContext
    ctx = DispatchContext.for_platform("imax3-28nm/64k")
    assert ctx.vmem_budget == 64 * 1024
    assert ctx.policy == "optimized"
    assert ctx.platform == "imax3-28nm/64k"
    assert DispatchContext.for_platform("imax3-28nm").platform \
        == "imax3-28nm/32k"


def test_host_platform_routes_everything_host():
    from repro_torch.kernels.api import DispatchContext
    assert DispatchContext.for_platform("cortex-a72").vmem_budget == 0


def test_dispatch_record_carries_platform_identity():
    import torch
    from repro_torch.kernels.api import (DispatchContext, dispatch,
                                         dispatch_trace, reset_dispatch_log,
                                         use_context)
    from repro_torch.quantize import quantize_q8_0
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 64), generator=g)
    wq = quantize_q8_0(torch.randn((64, 32), generator=g), axis=0)
    reset_dispatch_log()
    try:
        with use_context(DispatchContext.for_platform("imax3-28nm/32k")):
            dispatch("q8_matmul", x, wq)
        with use_context(DispatchContext(vmem_budget=1024)):
            dispatch("q8_matmul", x, wq)
        recs = dispatch_trace()
        assert [r.platform for r in recs] == ["imax3-28nm/32k", ""]
        assert recs[0].budget == 32 * 1024
    finally:
        reset_dispatch_log()


@pytest.fixture(scope="module")
def whisper():
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build
    cfg = reduced(get_config("whisper-tiny-en"))
    model = build(cfg)
    return model, model.init_values(torch.Generator().manual_seed(0),
                                    device="cpu")


def _serve_whisper(whisper, cache_dtype, platform, n_new=3):
    from repro_torch.serving.engine import AudioRequest, ServeEngine
    model, params = whisper
    eng = ServeEngine(model, params, n_slots=2, max_len=64, enc_len=16,
                      cache_dtype=cache_dtype, platform=platform,
                      device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((8, model.cfg.d_model)).astype(
        np.float32) * 0.5
    eng.admit(AudioRequest(uid=0, tokens=[5, 6, 7], max_new=n_new,
                           eos_id=-2, enc_frames=frames))
    while eng.n_active:
        eng.step()
    return eng


def test_energy_report_finite_on_required_platforms(whisper):
    from repro_torch.kernels.api import reset_dispatch_log
    reset_dispatch_log()
    for plat in ("imax3-28nm/32k", "h100-sxm"):
        for cdt in ("bf16", "q8_0"):
            rep = _serve_whisper(whisper, cdt, plat).energy_report()
            assert rep["platform"] == plat
            assert rep["tokens"] > 0 and rep["ticks"] > 0
            for key in ("joules_per_token", "pdp_j", "cache_energy_j",
                        "power_w", "latency_s"):
                assert np.isfinite(rep[key]) and rep[key] > 0, (plat, cdt,
                                                                key, rep)
            assert 0.0 <= rep["accel_flops_share"] <= 1.0
            assert rep["trace_records"] > 0
    reset_dispatch_log()


def test_energy_report_q8_cache_cheaper(whisper):
    from repro_torch.kernels.api import reset_dispatch_log
    reset_dispatch_log()
    eb = _serve_whisper(whisper, "bf16", "imax3-28nm/32k").energy_report()
    eq = _serve_whisper(whisper, "q8_0", "imax3-28nm/32k").energy_report()
    reset_dispatch_log()
    assert eq["ticks"] == eb["ticks"]
    assert eq["cache_energy_j"] <= eb["cache_energy_j"]
    assert eq["cache_energy_j"] / eb["cache_energy_j"] == \
        pytest.approx(0.53125, rel=1e-3)
    assert eq["joules_per_token"] <= eb["joules_per_token"]


def test_energy_reports_do_not_cross_contaminate(whisper):
    from repro_torch.kernels.api import dispatch_trace, reset_dispatch_log
    reset_dispatch_log()
    try:
        e1 = _serve_whisper(whisper, "bf16", "imax3-28nm/32k")
        r1 = e1.energy_report()
        e2 = _serve_whisper(whisper, "q8_0", "imax3-28nm/32k")
        r2 = e2.energy_report()
        assert e1.dispatch_ctx.tag != e2.dispatch_ctx.tag
        pooled = len([r for r in dispatch_trace()
                      if r.platform == "imax3-28nm/32k"])
        assert r1["trace_records"] > 0 and r2["trace_records"] > 0
        assert pooled == r1["trace_records"] + r2["trace_records"]
    finally:
        reset_dispatch_log()


def test_calibrate_missing_observables_raises():
    w16 = workload.whisper_workload(workload.WHISPER_TINY, dtype="f16")
    w8 = workload.whisper_workload(workload.WHISPER_TINY, dtype="q8_0")
    base = get_platform("imax3-28nm/32k")
    fp16_only = dataclasses.replace(base, paper={
        "latency_s": {"fp16": 13.5},
        "exec_share": {"fp16": 0.6089},
    })
    with pytest.raises(ValueError, match="q8"):
        energy.calibrate_imax(w16, w8, platform=fp16_only)


def test_energy_report_requires_platform(whisper):
    from repro_torch.serving.engine import ServeEngine
    model, params = whisper
    eng = ServeEngine(model, params, n_slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="platform"):
        eng.energy_report()


def test_transcribe_cli_prices_the_papers_platform(capsys):
    """``repro_torch.launch.transcribe --platform imax3-28nm`` (the
    reference's verify surface 0) ends with its energy line."""
    from repro_torch.launch import transcribe
    r = transcribe.main(["--platform", "imax3-28nm", "--device", "cpu",
                         "--cache-dtype", "q8_0", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "energy[imax3-28nm/32k]:" in out and "J/audio-s" in out
    assert r.energy["platform"] == "imax3-28nm/32k"
