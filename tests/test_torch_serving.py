"""The port's serving engine, scheduler and ``transcribe`` against the JAX
package's, on the reduced whisper-tiny-en with bridged parameters.

Greedy tokens must match, except that at the first divergence the
port's pick must be a near-tie of the reference's own logits (the idiom
of ``tests/test_serving.py``): both run bf16 activations, rounded at
different places, and Q8_0 caches on top of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
from repro.audio.features import audio_frames as j_audio_frames
from repro.audio.stream import chunk_list as j_chunk_list
from repro.configs import get_config, reduced
from repro.core.quantize import quantize_tree as j_quantize_tree
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
    log = eng.logits_log
    assert [r.shape[0] for r in log] == [1, 2, 2, 2, 2]
    picks = [int(log[0][0].argmax())] + \
        [int(r[st.slot].argmax()) for r in log[1:]]
    assert picks == st.out
    eng.reset_serve_stats()
    assert eng.logits_log == []


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
    for kw in (dict(paged=True), dict(spec_k=4), dict(cache_dtype="q4_0")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeEngine(tm, tparams, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        repro_torch.transcribe(synth_waveform(0.2), stream=True,
                               device="cpu")
    with pytest.raises(ValueError):
        ServeEngine(tm, tparams, device="meta")
