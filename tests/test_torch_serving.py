"""The port's serving engine, scheduler and ``transcribe`` against the JAX
package's, on the reduced whisper-tiny-en with bridged parameters.

Greedy tokens must match, except that at the first divergence the
port's pick must be a near-tie of the reference's own logits (the idiom
of ``tests/test_serving.py``): both run bf16 activations, rounded at
different places, and Q8_0 caches on top of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.audio.features import audio_frames as j_audio_frames
from repro.audio.stream import chunk_list as j_chunk_list
from repro.configs import get_config, reduced
from repro.core.quantize import quantize_tree as j_quantize_tree
from repro.kernels.api import DispatchContext as JDispatchContext
from repro.models.model import build as j_build
from repro.serving.engine import AudioRequest as JAudioRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.scheduler import BatchScheduler as JBatchScheduler
from repro_torch.audio.stream import synth_waveform
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.model import build
from repro_torch.serving.engine import (AudioRequest, RejectCode,
                                        ServeEngine)
from repro_torch.quantize import Q4Tensor, quantize_tree
from repro_torch.serving.scheduler import BatchScheduler

TIE_MARGIN = 0.15   # tests/test_serving.py's bf16 margin
VOCAB = 512


@pytest.fixture(scope="module")
def setup():
    jm = j_build(reduced(get_config("whisper-tiny-en")))
    tm = build(t_reduced(t_get_config("whisper-tiny-en")))
    jp = jm.init_values(jax.random.key(1))
    return jm, tm, jp


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _assert_greedy_matches(jm, jp, prompt, enc, got, want):
    """``got`` (port) equals ``want`` (JAX) up to the first divergence,
    where the port's pick must be within TIE_MARGIN of the reference
    argmax on the reference's full forward of the shared prefix."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        seq = list(prompt) + list(want[:i])
        logits, _ = jm.forward(jp, {"tokens": jnp.asarray([seq]),
                                    "enc_states": enc}, mode="train")
        lg = np.asarray(logits[0, -1, :VOCAB], np.float32)
        gap = float(lg[w] - lg[g])
        assert gap < TIE_MARGIN, (i, g, w, gap)
        return


def _requests(rng):
    lens, prompts = (40, 24, 31), ([1, 5, 9], [1], [1, 7])
    return [(uid, p, rng.standard_normal((n, 128)).astype(np.float32))
            for uid, (n, p) in enumerate(zip(lens, prompts))]


@pytest.mark.parametrize("weights,cache", [("bf16", "bf16"),
                                           ("q8_0", "q8_0")])
def test_engine_tokens_match_jax_engine(setup, weights, cache):
    jm, tm, jp = setup
    jparams = j_quantize_tree(jp) if weights == "q8_0" else jp
    tparams = _bridge(jparams)
    reqs = _requests(np.random.default_rng(4))
    kw = dict(n_slots=2, max_len=32, enc_len=40, cache_dtype=cache,
              decode_block=2)
    jsched = JBatchScheduler(JServeEngine(jm, jparams, **kw))
    tsched = BatchScheduler(ServeEngine(tm, tparams, device="cpu", **kw))
    for uid, p, fr in reqs:
        jsched.submit(JAudioRequest(uid=uid, tokens=p, max_new=6, eos_id=-1,
                                    enc_frames=fr))
        tsched.submit(AudioRequest(uid=uid, tokens=p, max_new=6, eos_id=-1,
                                   enc_frames=fr))
    jsched.run_until_drained()
    tsched.run_until_drained()
    for uid, p, fr in reqs:
        got, want = tsched.results[uid].out, jsched.results[uid].out
        assert len(got) == 6
        enc = jm.encode(jparams, jnp.asarray(fr)[None])
        _assert_greedy_matches(jm, jparams, p, enc, got, want)
    assert tsched.engine.lanestate.drained
    assert tsched.metrics.completed == 3


def test_fused_tick_equals_single_steps_with_one_fetch(setup):
    _, tm, jp = setup
    tparams = _bridge(jp)
    fr = np.random.default_rng(9).standard_normal((24, 128)) \
        .astype(np.float32)
    outs = {}
    for block in (4, 1):
        eng = ServeEngine(tm, tparams, n_slots=2, max_len=32, enc_len=24,
                          decode_block=block, device="cpu",
                          cache_dtype="q8_0")
        st = eng.admit(AudioRequest(uid=0, tokens=[1, 3], max_new=9,
                                    eos_id=-1, enc_frames=fr))
        for _ in range(4 // block):
            eng.step()
        assert eng._host_syncs == 4 // block
        assert eng._decode_steps == 4
        outs[block] = list(st.out)
    assert outs[4] == outs[1] and len(outs[4]) == 5


def test_engine_keeps_the_logits_it_chose_from(setup):
    _, tm, jp = setup
    fr = np.random.default_rng(4).standard_normal((24, 128)) \
        .astype(np.float32)
    eng = ServeEngine(tm, _bridge(jp), n_slots=2, max_len=32, enc_len=24,
                      decode_block=4, device="cpu", keep_logits=True)
    st = eng.admit(AudioRequest(uid=0, tokens=[1, 3], max_new=5,
                                eos_id=-1, enc_frames=fr))
    eng.step()
    # one (vocab,) row per token of the request, the admission's first
    assert [tuple(r.shape) for r in st.logits] == [(2048,)] * 5
    assert [int(r.argmax()) for r in st.logits] == st.out
    # a speculative engine keeps the verify rows of the emitted tokens
    eng = ServeEngine(tm, _bridge(jp), n_slots=2, max_len=32, enc_len=24,
                      decode_block=4, spec_k=4, device="cpu",
                      keep_logits=True)
    st = eng.admit(AudioRequest(uid=0, tokens=[1, 3], max_new=7,
                                eos_id=-1, enc_frames=fr))
    while eng.n_active:
        eng.step()
    assert len(st.logits) == len(st.out) == 7
    assert [int(r.argmax()) for r in st.logits] == st.out


def test_transcribe_matches_jax(setup):
    jm, tm, jp = setup
    x = synth_waveform(0.5)
    want = repro.transcribe(x, model=jm, params=jp, max_new=8)
    got = repro_torch.transcribe(x, model=tm, params=_bridge(jp),
                                 max_new=8, device="cpu")
    assert got.n_frames == want.n_frames == 25
    enc = want.engine.encode_chunks(
        j_chunk_list(np.asarray(j_audio_frames(x, 128)), 16))
    _assert_greedy_matches(jm, jp, [1], enc, got.tokens, want.tokens)
    assert got.host_syncs == got.ticks


def test_energy_report_has_the_reference_keys(setup):
    jm, tm, jp = setup
    fr = np.zeros((8, 128), np.float32)
    jeng = JServeEngine(jm, jp, n_slots=1, max_len=16, enc_len=8,
                        platform="tpu-v5e")
    teng = ServeEngine(tm, _bridge(jp), n_slots=1, max_len=16, enc_len=8,
                       platform="h100-sxm", device="cpu")
    for eng, req in ((jeng, JAudioRequest), (teng, AudioRequest)):
        eng.admit(req(uid=0, tokens=[1], max_new=3, eos_id=-1,
                      enc_frames=fr))
        while eng.n_active:
            eng.step()
    want, got = jeng.energy_report(), teng.energy_report()
    assert set(got) == set(want)
    assert got["platform"] == "h100-sxm" and got["tokens"] == 3
    assert got["host_syncs"] == got["ticks"] == 2
    assert got["accel_flops_share"] == 1.0


def test_engine_validates_and_refuses_unported_features(setup):
    _, tm, jp = setup
    tparams = _bridge(jp)
    eng = ServeEngine(tm, tparams, n_slots=1, max_len=16, enc_len=8,
                      device="cpu")
    bad = [(AudioRequest(uid=0, tokens=[1] * 10, max_new=8,
                         enc_frames=np.zeros((4, 128))), RejectCode.TOO_LONG),
           (AudioRequest(uid=1, tokens=[1], max_new=4,
                         enc_frames=np.zeros((9, 128))),
            RejectCode.ENC_OVERFLOW),
           (AudioRequest(uid=2, tokens=[1], max_new=4,
                         enc_frames=np.zeros((4, 64))),
            RejectCode.BAD_ENC_SHAPE)]
    for req, code in bad:
        assert eng.validate(req).code == code
    # paged KV is ported: a paged engine constructs, with the reference's
    # refusals (a decoder-only model; lengths off the page size)
    eng = ServeEngine(tm, tparams, device="cpu", paged=True, max_len=64,
                      enc_len=16, page_size=8)
    assert eng.pages.self_table.device().shape == (8, 8)
    assert eng.page_headroom() == 1.0
    with pytest.raises(ValueError, match="page_size"):
        ServeEngine(tm, tparams, device="cpu", paged=True, max_len=60)
    # the q4_0 tier and speculative decoding are ported: they construct
    eng = ServeEngine(tm, tparams, device="cpu", cache_dtype="q4_0",
                      decode_block=4, spec_k=4)
    assert eng.cache["layers"]["self"]["kp"].dtype == torch.uint8
    assert eng.cache_report()["traffic_ratio_vs_bf16"] == 0.28125
    assert isinstance(eng.draft_params["dec_layers"]["mlp"]["up"],
                      Q4Tensor)
    # streaming transcription is ported: it returns the one-shot tokens
    x = synth_waveform(0.2)
    assert repro_torch.transcribe(x, stream=True, device="cpu").tokens \
        == repro_torch.transcribe(x, device="cpu").tokens
    with pytest.raises(ValueError):
        ServeEngine(tm, tparams, device="meta")
    # the xLSTM family is ported: a reduced xlstm-350m engine constructs;
    # so do the dense and MoE families; zamba2-7b's config is known, its
    # model refused
    xm = build(t_reduced(t_get_config("xlstm-350m")))
    eng = ServeEngine(xm, xm.init_values(torch.Generator().manual_seed(0),
                                         device="cpu"),
                      n_slots=2, max_len=32, device="cpu")
    assert eng.spec.recurrent == ("mstate", "sstate")
    assert eng.cache_report()["state_bytes_total"] > 0
    with pytest.raises(ValueError, match="enc-dec"):
        ServeEngine(xm, eng.params, n_slots=2, max_len=32, device="cpu",
                    paged=True)
    for name in ("qwen3-moe-30b-a3b", "gemma2-2b"):
        m = build(t_reduced(t_get_config(name)))
        eng = ServeEngine(m, m.init_values(torch.Generator().manual_seed(0),
                                           device="cpu"),
                          n_slots=2, max_len=32, device="cpu")
        assert eng.spec.self_kv and eng.cache_report()["kv_bytes_total"] > 0
    with pytest.raises(NotImplementedError,
                       match="item 14 \\(mamba and the zamba2 hybrid\\)"):
        build(t_reduced(t_get_config("zamba2-7b"))).state_spec()
    with pytest.raises(KeyError, match="unknown arch"):
        t_get_config("whisper-large")


# ------------------------------------------------ speculative decoding
# The port's counterparts of the reference's tests/test_spec_decode.py:
# test_spec_tick_parity, test_spec_parity_eos_mid_draft,
# test_spec_knob_validation and test_spec_validate_headroom, plus the
# energy report's spec fields by the reference's formula (its own
# test_spec_energy_report_fields does not run on jax's CPU runtime here).

SPEC_PROMPTS = [[5, 6, 7, 8], [9, 10, 11], [3, 4, 5, 6, 7]]


def _spec_frames(lens=(8, 12, 8)):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((n, 128)).astype(np.float32) * 0.5
            for n in lens]


def _spec_serve(tm, tparams, frames, max_new=8, eos=-2, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("enc_len", 16)
    eng = ServeEngine(tm, tparams, device="cpu", **kw)
    sts = [eng.admit(AudioRequest(uid=i, tokens=list(p), max_new=max_new,
                                  eos_id=eos, enc_frames=f))
           for i, (p, f) in enumerate(zip(SPEC_PROMPTS, frames))]
    ticks = 0
    while eng.n_active:
        eng.step()
        ticks += 1
    return eng, sts, ticks


@pytest.mark.parametrize("cache_dtype", ["bf16", "q8_0", "q4_0"])
def test_spec_tick_parity(setup, cache_dtype):
    """The speculative tick is token-identical to the plain fused tick on
    every cache tier, with one host sync a tick and the round
    accounting of the reference."""
    _, tm, jp = setup
    tparams, frames = _bridge(jp), _spec_frames()
    _, plain, _ = _spec_serve(tm, tparams, frames, cache_dtype=cache_dtype,
                              decode_block=4)
    eng, spec, ticks = _spec_serve(tm, tparams, frames,
                                   cache_dtype=cache_dtype, decode_block=4,
                                   spec_k=4)
    assert [st.out for st in spec] == [st.out for st in plain]
    assert eng._host_syncs == ticks == eng._ticks
    assert eng._spec_rounds == eng._ticks
    assert eng._draft_steps == 3 * eng._spec_rounds
    assert eng._verify_steps == eng._spec_rounds
    assert 0.0 <= eng.acceptance_rate <= 1.0
    assert eng.lanestate.drained


def test_spec_parity_eos_mid_draft(setup):
    """A lane whose greedy stream hits EOS inside a draft window stops
    exactly there."""
    _, tm, jp = setup
    tparams, frames = _bridge(jp), _spec_frames()
    _, probe, _ = _spec_serve(tm, tparams, frames, decode_block=1)
    eos = probe[0].out[2]   # round position 2 of a spec_k = 4 round
    _, plain, _ = _spec_serve(tm, tparams, frames, eos=eos, decode_block=4)
    _, spec, _ = _spec_serve(tm, tparams, frames, eos=eos, decode_block=4,
                             spec_k=4)
    assert [st.out for st in spec] == [st.out for st in plain]
    assert spec[0].out[-1] == eos
    assert all(st.done for st in spec)


def test_spec_tokens_match_jax_spec_engine(setup):
    """The port's speculative engine (q4_0 cache, Q4_0 draft) against the
    reference's on the same weights and requests: greedy tokens equal up
    to a near-tie, and the same acceptance when they are equal. The
    reference runs ``q4_matmul`` on its ``ref`` oracle: its host path
    ``q4_matmul_xla`` is a bf16 x bf16 -> f32 dot that jax's CPU runtime
    refuses."""
    jm, tm, jp = setup
    frames = _spec_frames()
    kw = dict(n_slots=4, max_len=64, enc_len=16, cache_dtype="q4_0",
              decode_block=4, spec_k=4)
    jeng = JServeEngine(jm, jp, dispatch_ctx=dataclasses.replace(
        JDispatchContext.from_env(), backends={"q4_matmul": "ref"}), **kw)
    jsts = [jeng.admit(JAudioRequest(uid=i, tokens=list(p), max_new=8,
                                     eos_id=-2, enc_frames=f))
            for i, (p, f) in enumerate(zip(SPEC_PROMPTS, frames))]
    jticks = 0
    while jeng.n_active:
        jeng.step()
        jticks += 1
    teng, tsts, tticks = _spec_serve(tm, _bridge(jp), frames, **kw)
    for p, f, st, jst in zip(SPEC_PROMPTS, frames, tsts, jsts):
        enc = jm.encode(jp, jnp.asarray(f)[None])
        _assert_greedy_matches(jm, jp, p, enc, st.out, jst.out)
    if [st.out for st in tsts] == [st.out for st in jsts]:
        assert teng.acceptance_rate == jeng.acceptance_rate
        assert tticks == jticks
    assert teng._host_syncs == tticks


def test_spec_knob_validation(setup):
    _, tm, jp = setup
    tparams = _bridge(jp)
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(tm, tparams, device="cpu", spec_k=1)
    with pytest.raises(ValueError, match="multiple"):
        ServeEngine(tm, tparams, device="cpu", decode_block=3, spec_k=2)
    with pytest.raises(ValueError, match="draft_dtype"):
        ServeEngine(tm, tparams, device="cpu", decode_block=2, spec_k=2,
                    draft_dtype="int3")
    eng, _, _ = _spec_serve(tm, tparams, _spec_frames(), max_new=30,
                            decode_block=4, spec_k=4)
    eng.admit(AudioRequest(uid=9, tokens=[1], max_new=8, eos_id=-2,
                           enc_frames=_spec_frames()[0]))
    with pytest.raises(ValueError, match="multiple"):
        eng.step_begin(k=6)
    # quantized served params need explicit draft weights
    with pytest.raises(ValueError, match="draft_params"):
        ServeEngine(tm, quantize_tree(tparams), device="cpu",
                    decode_block=2, spec_k=2)
    q8 = quantize_tree(tparams)
    eng = ServeEngine(tm, q8, device="cpu", decode_block=2, spec_k=2,
                      draft_params=quantize_tree(tparams, tier="q4_0"))
    assert eng.draft_params is not q8


def test_spec_validate_headroom(setup):
    """Speculative lanes keep spec_k - 1 extra KV positions: a request
    that fits a plain engine exactly is TOO_LONG for the speculative
    one."""
    _, tm, jp = setup
    tparams = _bridge(jp)
    plain = ServeEngine(tm, tparams, device="cpu", max_len=64, enc_len=16)
    spec = ServeEngine(tm, tparams, device="cpu", max_len=64, enc_len=16,
                       decode_block=4, spec_k=4)
    fr = np.zeros((8, 128), np.float32)
    req = AudioRequest(uid=0, tokens=list(range(2, 33)), max_new=32,
                       eos_id=-2, enc_frames=fr)
    assert plain.validate(req) is None         # 31 + 32 < 64
    rej = spec.validate(req)
    assert rej is not None and rej.code == RejectCode.TOO_LONG
    assert "speculative headroom" in rej.message
    req2 = AudioRequest(uid=1, tokens=list(range(2, 30)), max_new=32,
                        eos_id=-2, enc_frames=fr)
    assert spec.validate(req2) is None         # 28 + 32 + 3 < 64


def test_spec_energy_report_fields(setup):
    """The spec block of ``energy_report`` and its roofline, by the
    reference's formula (``serving/engine.py`` energy_report): every
    draft step streams the draft weights and the cache, every verify the
    full weights and the cache once for all spec_k positions."""
    _, tm, jp = setup
    tparams = _bridge(jp)
    eng, _, _ = _spec_serve(tm, tparams, _spec_frames(), decode_block=4,
                            spec_k=4, cache_dtype="q4_0",
                            platform="h100-sxm")
    er = eng.energy_report()
    spec = er["speculative"]
    assert spec["spec_k"] == 4 and spec["draft_dtype"] == "q4_0"
    assert spec["draft_steps"] == 3 * spec["rounds"] == 3 * er["ticks"]
    assert spec["verify_steps"] == spec["rounds"]
    assert spec["acceptance_rate"] == eng.acceptance_rate
    assert 0 < spec["draft_weight_bytes"] < er["weight_bytes"]
    n_elems, w_bytes = eng._param_stats()
    d_elems, d_bytes = eng._param_stats(eng.draft_params)
    assert spec["draft_weight_bytes"] == d_bytes
    cbs = er["cache_bytes_per_step"]
    steps = er["decode_steps"]
    assert steps == 0      # a spec tick runs rounds, not plain steps
    ds, vs = spec["draft_steps"], spec["verify_steps"]
    assert er["stream_bytes_total"] == (ds + vs) * cbs \
        + steps * w_bytes + ds * d_bytes + vs * w_bytes
    assert er["modeled_flops"] == 2.0 * n_elems * (steps + vs * 4) \
        + 2.0 * d_elems * ds
    assert er["host_syncs"] == er["ticks"]
    assert er["modeled_tokens_per_s"] > 0


def test_transcribe_q4_0_and_a_reused_spec_engine(setup):
    """``transcribe(cache_dtype="q4_0")`` against the reference's, and
    the same audio through a reused speculative engine: the port's
    tokens equal its own plain transcription."""
    jm, tm, jp = setup
    x = synth_waveform(0.5)
    want = repro.transcribe(x, model=jm, params=jp, max_new=8,
                            cache_dtype="q4_0")
    tparams = _bridge(jp)
    got = repro_torch.transcribe(x, model=tm, params=tparams, max_new=8,
                                 cache_dtype="q4_0", device="cpu")
    assert got.cache_dtype == "q4_0"
    enc = want.engine.encode_chunks(
        j_chunk_list(np.asarray(j_audio_frames(x, 128)), 16))
    _assert_greedy_matches(jm, jp, [1], enc, got.tokens, want.tokens)
    eng = ServeEngine(tm, tparams, n_slots=1, max_len=14, enc_len=25,
                      cache_dtype="q4_0", decode_block=4, spec_k=4,
                      device="cpu")
    spec = repro_torch.transcribe(x, model=tm, params=tparams, max_new=8,
                                  engine=eng)
    assert spec.tokens == got.tokens
    assert spec.host_syncs == spec.ticks
    assert eng._verify_steps == spec.ticks
