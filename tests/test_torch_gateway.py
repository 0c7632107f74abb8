"""The port's gateway (``repro_torch.gateway``) against the JAX package's.

The first half is the reference's ``tests/test_gateway.py`` (its 10
tests) on the port, over one module-scoped micro-whisper engine built
as the reference's rig is (``tests/test_gateway.py:30-46``) from the
reference's parameters bridged into the port. The second half holds the
port to the reference: the load generator's descriptors bit for bit,
``run_load``'s tokens against the reference's ``sync_baseline`` on the
same weights (near-ties allowed, as in ``tests/test_torch_serving.py``),
``energy_report`` against the reference engine's on the paper's
platforms, and the ``launch.gateway`` CLI. Tests drive asyncio with
``asyncio.run`` inside plain functions.
"""

import asyncio
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.gateway import LoadSpec as JLoadSpec
from repro.gateway import poisson_arrivals as j_poisson_arrivals
from repro.gateway import sync_baseline as j_sync_baseline
from repro.gateway import synth_load as j_synth_load
from repro.models.model import build as j_build
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.gateway import (INTERACTIVE, STANDARD, AdmissionQueue,
                                 Gateway, LoadSpec, SLOClass,
                                 poisson_arrivals, run_load, sync_baseline,
                                 synth_load)
from repro_torch.models.model import build
from repro_torch.serving.engine import (AudioRequest, RejectCode, Request,
                                        ServeEngine)
from repro_torch.serving.scheduler import BatchScheduler, SchedulerStuckError

MAX_LEN = 64
ENC_LEN = 16
MICRO = dict(d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256,
             enc_layers=1, n_layers=1)
TIE_MARGIN = 0.15   # tests/test_serving.py's bf16 margin
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    jcfg = dataclasses.replace(j_reduced(j_get_config("whisper-tiny-en")),
                               **MICRO)
    jm = j_build(jcfg)
    return jcfg, jm, jm.init_values(jax.random.key(0))


@pytest.fixture(scope="module")
def rig(ref):
    _, _, jp = ref
    cfg = dataclasses.replace(reduced(get_config("whisper-tiny-en")),
                              **MICRO)
    model = build(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    engine = ServeEngine(model, params, n_slots=4, max_len=MAX_LEN,
                         enc_len=ENC_LEN, decode_block=4, device="cpu")
    # the micro model's ops are too small to share out: with a thread
    # per core in every test worker, they wait on each other's spinning
    # threads, and the SLO deadlines measure that wait
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cfg, engine
    torch.set_num_threads(threads)


def _frames(s, d_model=64, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((s, d_model)).astype(np.float32) * 0.02


# ------------------------------------------- tests/test_gateway.py, ported


def test_gateway_parity_32_concurrent(rig):
    """>= 32 concurrent mixed one-shot/streaming requests through the
    async gateway are token-identical to the synchronous FCFS
    BatchScheduler, with exactly one host sync per tick."""
    cfg, engine = rig
    spec = LoadSpec(rate_rps=500.0, n_requests=32, seed=0,
                    stream_fraction=0.3)
    descs = synth_load(cfg, spec)
    baseline = sync_baseline(engine, descs)
    assert engine.n_active == 0
    results, summary, _ = run_load(engine, spec, shed_on_submit=False)
    assert all(r.ok for r in results), \
        [(r.uid, r.code, r.error) for r in results if not r.ok]
    for d, r in zip(descs, results):
        assert list(r.tokens) == baseline[d.idx], f"desc {d.idx}"
    assert summary["completed"] == 32 and summary["shed_total"] == 0
    assert engine._host_syncs == engine._ticks
    assert engine.n_active == 0 and len(engine.free) == engine.n_slots


def test_cancel_mid_stream_frees_slot_and_reanchors(rig):
    cfg, engine = rig
    fr = _frames(8)
    st_ref = engine.admit(AudioRequest(uid=900, tokens=[1, 5], max_new=6,
                                       eos_id=-1, enc_frames=fr))
    while engine.n_active:
        engine.step()
    ref = list(st_ref.out)

    async def go():
        async with Gateway(engine, shed_on_submit=False) as gw:
            sess = await gw.open_session(tokens=[1], max_new=30,
                                         slo=INTERACTIVE)
            await sess.feed(_frames(4, seed=1))
            for _ in range(50):       # let the lane actually decode
                await asyncio.sleep(0.01)
                if sess.partials:
                    break
            assert sess.partials, "stream never anchored"
            r = await sess.cancel()
            assert not r.ok and r.code is RejectCode.CANCELLED
            r2 = await gw.submit_audio(frames=fr, tokens=[1, 5],
                                       max_new=6, slo=STANDARD)
            assert r2.ok and list(r2.tokens) == ref
        assert engine.n_active == 0
        assert len(engine.free) == engine.n_slots

    asyncio.run(go())


def test_client_timeout_mid_flight_frees_slot(rig):
    cfg, engine = rig

    async def go():
        async with Gateway(engine, shed_on_submit=False) as gw:
            r = await gw.submit_audio(frames=_frames(8), tokens=[1],
                                      max_new=40, slo=STANDARD,
                                      timeout_s=1e-3)
            assert not r.ok and r.code is RejectCode.TIMEOUT
        assert engine.n_active == 0
        assert len(engine.free) == engine.n_slots

    asyncio.run(go())


def test_deadline_miss_sheds_before_prefill(rig):
    cfg, engine = rig
    tight = SLOClass("tight", priority=0, deadline_s=1e-6)

    async def go():
        async with Gateway(engine, shed_on_submit=False) as gw:
            r = await gw.submit_audio(frames=_frames(8), tokens=[1],
                                      max_new=4, slo=tight)
            assert not r.ok and r.code is RejectCode.DEADLINE_MISSED
            assert r.record.admit_t is None      # never prefilled
        assert engine.n_active == 0

    asyncio.run(go())


def test_queue_full_backpressure_sheds(rig):
    cfg, engine = rig

    async def go():
        gw = Gateway(engine, queue_limit=2, max_admit_per_tick=0,
                     shed_on_submit=False)
        await gw.start()
        try:
            t1 = asyncio.create_task(gw.submit_audio(
                frames=_frames(4), tokens=[1], max_new=2, slo=STANDARD,
                timeout_s=0.5))
            t2 = asyncio.create_task(gw.submit_audio(
                frames=_frames(4), tokens=[1], max_new=2, slo=STANDARD,
                timeout_s=0.5))
            await asyncio.sleep(0.05)            # both queued
            assert gw.n_queued == 2
            r3 = await gw.submit_audio(frames=_frames(4), tokens=[1],
                                       max_new=2, slo=STANDARD)
            assert not r3.ok and r3.code is RejectCode.QUEUE_FULL
            r1, r2 = await t1, await t2          # time out queued
            assert {r1.code, r2.code} == {RejectCode.TIMEOUT}
        finally:
            await gw.close(drain=False)

    asyncio.run(go())


def test_bad_chunk_sheds_session(rig):
    cfg, engine = rig

    async def go():
        async with Gateway(engine, shed_on_submit=False) as gw:
            sess = await gw.open_session(tokens=[1], max_new=4)
            await sess.feed(_frames(4))
            await sess.feed(np.zeros((3, 5), np.float32))   # wrong d_model
            r = await sess.finalize()
            assert not r.ok and r.code is RejectCode.BAD_ENC_SHAPE
            s2 = await gw.open_session(tokens=[1], max_new=4)
            await s2.feed(_frames(ENC_LEN))
            await s2.feed(_frames(4))
            r2 = await s2.finalize()
            assert not r2.ok and r2.code is RejectCode.ENC_OVERFLOW
        assert engine.n_active == 0

    asyncio.run(go())


def test_poisson_loadgen_deterministic(rig):
    cfg, _ = rig
    a = poisson_arrivals(50.0, 64, seed=3)
    b = poisson_arrivals(50.0, 64, seed=3)
    c = poisson_arrivals(50.0, 64, seed=4)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.all(np.diff(a) > 0) and a.shape == (64,)
    spec = LoadSpec(rate_rps=100.0, n_requests=12, seed=5)
    d1, d2 = synth_load(cfg, spec), synth_load(cfg, spec)
    for x, y in zip(d1, d2):
        assert x.arrival_s == y.arrival_s and x.tokens == y.tokens
        assert x.kind == y.kind and x.slo is y.slo
        assert all(np.array_equal(p, q)
                   for p, q in zip(x.chunks, y.chunks))


def test_admission_queue_edf_within_priority():
    @dataclasses.dataclass
    class T:
        slo: SLOClass
        deadline_t: float
        cancelled: bool = False

    hi = SLOClass("hi", 0, 1.0)
    lo = SLOClass("lo", 1, 1.0)
    q = AdmissionQueue(limit=4)
    late_hi = T(hi, 9.0)
    early_lo = T(lo, 1.0)
    early_hi = T(hi, 2.0)
    assert q.push(late_hi) and q.push(early_lo) and q.push(early_hi)
    cancelled = T(hi, 0.5, cancelled=True)
    assert q.push(cancelled)
    assert not q.push(T(lo, 3.0))          # full -> backpressure
    q.cancelled_dropped()
    assert q.pop() is early_hi
    assert q.pop() is late_hi
    assert q.pop() is early_lo
    assert q.pop() is None and len(q) == 0


def test_validate_reject_codes(rig):
    cfg, engine = rig
    r = engine.validate(Request(uid=0, tokens=[1] * MAX_LEN, max_new=4,
                                eos_id=-1))
    assert r is not None and r.code is RejectCode.TOO_LONG
    r = engine.validate(Request(uid=1, tokens=[1], max_new=4, eos_id=-1))
    assert r is not None and r.code is RejectCode.MISSING_ENC_INPUT
    r = engine.validate(AudioRequest(uid=2, tokens=[1], max_new=4,
                                     eos_id=-1,
                                     enc_frames=_frames(ENC_LEN + 1)))
    assert r is not None and r.code is RejectCode.ENC_OVERFLOW
    assert engine.validate(AudioRequest(uid=3, tokens=[1], max_new=4,
                                        eos_id=-1,
                                        enc_frames=_frames(4))) is None
    sched = BatchScheduler(engine)
    st = sched.submit(Request(uid=950, tokens=[1], max_new=4, eos_id=-1))
    assert st.done and st.error_code is RejectCode.MISSING_ENC_INPUT


def test_run_until_drained_raises_when_stuck(rig):
    cfg, engine = rig
    sched = BatchScheduler(engine)
    sched.submit(AudioRequest(uid=960, tokens=[1], max_new=6, eos_id=-1,
                              enc_frames=_frames(4)))
    with pytest.raises(SchedulerStuckError, match="not drained"):
        sched.run_until_drained(max_ticks=0)
    assert sched.run_until_drained(max_ticks=0, strict=False) is False
    assert sched.run_until_drained() is True
    assert sched.drained


# ------------------------------------------------ against the reference


def test_reject_codes_equal_the_reference():
    from repro.serving.engine import RejectCode as JRejectCode
    assert {c.name: c.value for c in RejectCode} \
        == {c.name: c.value for c in JRejectCode}


@pytest.mark.parametrize("spec", [
    dict(rate_rps=20.0, n_requests=16, seed=0),
    dict(rate_rps=500.0, n_requests=12, seed=5, stream_fraction=0.5,
         max_new=4, oneshot_frames=(8, 16), stream_chunks=(1, 2, 3)),
    dict(rate_rps=3.5, n_requests=9, seed=11, stream_fraction=0.0)],
    ids=["default", "streams", "oneshot"])
def test_synth_load_equals_the_reference(ref, rig, spec):
    jcfg = ref[0]
    cfg, _ = rig
    assert np.array_equal(
        poisson_arrivals(spec["rate_rps"], spec["n_requests"], spec["seed"]),
        j_poisson_arrivals(spec["rate_rps"], spec["n_requests"],
                           spec["seed"]))
    got, want = synth_load(cfg, LoadSpec(**spec)), \
        j_synth_load(jcfg, JLoadSpec(**spec))
    assert len(got) == len(want) == spec["n_requests"]
    for g, w in zip(got, want):
        assert (g.idx, g.kind, g.arrival_s, g.tokens, g.max_new, g.eos_id,
                g.audio_s, g.slo.name, g.slo.priority, g.slo.deadline_s) \
            == (w.idx, w.kind, w.arrival_s, w.tokens, w.max_new, w.eos_id,
                w.audio_s, w.slo.name, w.slo.priority, w.slo.deadline_s)
        assert len(g.chunks) == len(w.chunks)
        for p, q in zip(g.chunks, w.chunks):
            assert p.dtype == q.dtype and np.array_equal(p, q)


def _reference_prefix_gap(ref, desc, want, got, i) -> float:
    """How far below the reference's argmax the port's pick ``got[i]``
    sits on the reference's full forward of the shared prefix (the
    stream's states are its chunks encoded one by one, block-diagonal,
    as the engines encode them)."""
    _, jm, jp = ref
    enc = jnp.concatenate([jm.encode(jp, jnp.asarray(c)[None])
                           for c in desc.chunks], axis=1)
    seq = list(desc.tokens) + list(want[:i])
    logits, _ = jm.forward(jp, {"tokens": jnp.asarray([seq]),
                                "enc_states": enc}, mode="train")
    lg = np.asarray(logits[0, -1], np.float32)
    return float(lg[want[i]] - lg[got[i]])


def test_run_load_tokens_equal_the_reference_baseline(ref, rig):
    """The port's gateway over the bridged weights gives the reference's
    ``sync_baseline`` tokens for 8 requests (one-shot and streamed), up
    to a near-tie of the reference's own logits."""
    jcfg, jm, jp = ref
    cfg, engine = rig
    spec = LoadSpec(rate_rps=200.0, n_requests=8, seed=3,
                    stream_fraction=0.4)
    jengine = JServeEngine(jm, jp, n_slots=4, max_len=MAX_LEN,
                           enc_len=ENC_LEN, decode_block=4)
    want = j_sync_baseline(jengine, j_synth_load(
        jcfg, JLoadSpec(**dataclasses.asdict(spec))))
    descs = synth_load(cfg, spec)
    assert {d.kind for d in descs} == {"oneshot", "stream"}
    results, summary, _ = run_load(engine, spec, shed_on_submit=False)
    assert summary["completed"] == 8
    for d, r in zip(descs, results):
        got, w = list(r.tokens), want[d.idx]
        assert r.ok and len(got) == len(w) == spec.max_new
        i = next((i for i, (a, b) in enumerate(zip(got, w)) if a != b),
                 None)
        if i is not None:
            gap = _reference_prefix_gap(ref, d, w, got, i)
            assert gap < TIE_MARGIN, (d.idx, i, got, w, gap)


@pytest.mark.parametrize("platform,weights,cache", [
    ("imax3-28nm/32k", "fp16", "bf16"), ("imax3-28nm/32k", "q8_0", "q8_0"),
    ("jetson-agx-orin", "fp16", "q8_0")])
def test_energy_report_equals_the_reference(ref, rig, platform, weights,
                                            cache):
    """On the paper's platforms both engines count the same steps, tokens
    and bytes for the same requests, so every modelled number equals the
    reference's to 1e-12 (the ACCEL/HOST share is left out: it reads
    each package's own dispatch trace)."""
    from repro.core.quantize import quantize_tree as j_quantize_tree
    jcfg, jm, jp = ref
    cfg, engine = rig
    jparams = j_quantize_tree(jp) if weights == "q8_0" else jp
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    kw = dict(n_slots=4, max_len=MAX_LEN, enc_len=ENC_LEN, decode_block=4,
              cache_dtype=cache, platform=platform)
    spec = LoadSpec(rate_rps=100.0, n_requests=4, seed=1,
                    stream_fraction=0.0)
    jeng = JServeEngine(jm, jparams, **kw)
    teng = ServeEngine(engine.model, tparams, device="cpu", **kw)
    j_sync_baseline(jeng, j_synth_load(jcfg, JLoadSpec(
        **dataclasses.asdict(spec))))
    sync_baseline(teng, synth_load(cfg, spec))
    got, want = teng.energy_report(weights), jeng.energy_report(weights)
    for key in ("trace_records", "accel_flops_share"):
        got.pop(key), want.pop(key)
    assert set(got) == set(want)
    for key in ("ticks", "decode_steps", "tokens", "host_syncs",
                "weight_bytes", "cache_bytes_per_step"):
        assert got[key] == want[key], key
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0.0), key
        else:
            assert g == w, key


def test_gateway_cli_prints_its_energy_line():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gateway", "--arch",
         "whisper-tiny-en", "--reduced", "--device", "cpu", "--platform",
         "imax3-28nm/32k", "--requests", "6", "--max-new", "4"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "6/6 completed" in out.stdout, out.stdout
    assert "one host sync per tick: True" in out.stdout
    line = [l for l in out.stdout.splitlines()
            if l.startswith("energy[imax3-28nm/32k]:")]
    assert line and "J/audio-s" in line[0], out.stdout
