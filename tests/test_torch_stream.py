"""Streaming Whisper transcription in the port against the JAX package:
the streaming frontend, the f32 frontend products' row independence,
``cross_attn_kv``, the in-place cross-K/V extension, the engine's and
the scheduler's streams, ``transcribe(stream=True)`` and the launch
CLIs, on the reduced whisper-tiny-en with weights bridged from the
reference's ``init_values``.

Greedy tokens must match the reference's, except that at the first
divergence the port's pick must be a near-tie of the reference's own
logits (``tests/test_torch_serving.py``'s rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.audio.features import audio_frames as j_audio_frames
from repro.audio.stream import StreamingFrontend as JStreamingFrontend
from repro.audio.stream import chunk_list as j_chunk_list
from repro.configs import get_config, reduced
from repro.core.quantize import quantize_tree as j_quantize_tree
from repro.models import encdec as j_encdec
from repro.models.model import build as j_build
from repro_torch.audio.features import audio_frames
from repro_torch.audio.stream import (StreamingFrontend, chunk_list,
                                      synth_waveform)
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels.fp16_matmul import ops as mm_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import transcribe as transcribe_cli
from repro_torch.models import encdec
from repro_torch.models.model import build
from repro_torch.quantize import (Q4Tensor, Q8Tensor, dequantize_q4_0,
                                  dequantize_q8_0)
from repro_torch.serving.engine import (AudioRequest, RejectCode,
                                        RejectionError, ServeEngine,
                                        StreamingAudioRequest)
from repro_torch.serving.scheduler import BatchScheduler

TIE_MARGIN = 0.15   # tests/test_serving.py's bf16 margin
VOCAB = 512
D = 128             # the reduced whisper-tiny-en's d_model


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
        return i
    return None


def _chunks(rng, sizes):
    return [rng.standard_normal((n, D)).astype(np.float32) * 0.5
            for n in sizes]


# ------------------------------------------------------------- frontend

@pytest.mark.parametrize("step", [173, 1777, None])
def test_streaming_frontend_bit_exact(step):
    """Pushes of any size then ``flush`` equal the one-shot
    ``audio_frames`` bit for bit, and the reference's streaming frontend
    within ``test_audio_frames_match_jax``'s tolerance."""
    x = synth_waveform(0.7)
    step = step or len(x)
    one = audio_frames(x, D, device="cpu")
    sf = StreamingFrontend(D, device="cpu")
    jsf = JStreamingFrontend(D)
    outs, jouts = [], []
    for i in range(0, len(x), step):
        outs.append(sf.push(x[i:i + step]))
        jouts.append(np.asarray(jsf.push(x[i:i + step])))
        assert outs[-1].shape == jouts[-1].shape
        assert outs[-1].device.type == "cpu"
    outs.append(sf.flush())
    jouts.append(np.asarray(jsf.flush()))
    got = torch.cat(outs)
    assert got.shape == one.shape == (35, D)
    assert torch.equal(got, one)
    assert sf.frames_emitted == one.shape[0]
    assert sf.samples_received == len(x)
    np.testing.assert_allclose(got.numpy(), np.concatenate(jouts),
                               atol=1e-4, rtol=1e-4)
    assert sf.flush().shape == (0, D)
    with pytest.raises(ValueError):
        sf.push(x[:10])              # push after flush


@pytest.mark.parametrize("m,k,n", [(3000, 201, 80), (1500, 80, 384)])
def test_frontend_product_rows_do_not_depend_on_m(m, k, n):
    """The frontend's f32 x f32 products (the mel filterbank and the
    projection) give a row the same bits in a call of 1-100 rows as in
    the full product, at offsets across the rows; a library GEMM blocks
    the rows by M and does not."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.random((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    full = mm_ops.fp16_matmul(x, w)
    for rows in range(1, 101):
        at = (rows * 37) % (m - rows)
        part = mm_ops.fp16_matmul(x[at:at + rows].contiguous(), w)
        assert torch.equal(part, full[at:at + rows]), rows
    np.testing.assert_allclose(full.numpy(), x.double().numpy()
                               @ w.double().numpy(), rtol=1e-5,
                               atol=1e-5 * float(full.abs().max()))


# ---------------------------------------------- cross K/V and extension

@pytest.mark.parametrize("weights", ["bf16", "q8_0", "q4_0"])
def test_cross_attn_kv_matches_jax(setup, weights):
    """``cross_attn_kv`` of the serving tree against the reference's of
    the same weights: (L, B, S_new, Hkv, Dh) in bf16."""
    jm, tm, jp = setup
    jparams = j_quantize_tree(jp, tier=weights) if weights != "bf16" \
        else jp
    served = tm.prepare_serving(_bridge(jparams))
    states = np.random.default_rng(2).standard_normal((1, 7, D)) \
        .astype(np.float32)
    jk, jv = j_encdec.cross_attn_kv(jparams, jm.cfg, jnp.asarray(states))
    k, v = encdec.cross_attn_kv(served, tm.cfg,
                                torch.from_numpy(states).to(torch.bfloat16))
    cfg = tm.cfg
    assert k.shape == v.shape == (cfg.n_layers, 1, 7, cfg.n_kv_heads,
                                  cfg.head_dim)
    assert k.dtype == torch.bfloat16
    for got, want in ((k, jk), (v, jv)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)


def _planes(eng, lo, hi):
    """The slot-0 cross K and V planes at positions [lo, hi), as f32
    values (dequantized for a q8_0 or q4_0 pool)."""
    cross = eng.cache["layers"]["cross"]
    if eng.cache_dtype == "bf16":
        return [cross[c][:, 0, lo:hi].float() for c in ("k", "v")]
    deq, qt, codes = (dequantize_q8_0, Q8Tensor, ("kq", "vq")) \
        if eng.cache_dtype == "q8_0" else (dequantize_q4_0, Q4Tensor,
                                           ("kp", "vp"))
    return [deq(qt(cross[c][:, 0, lo:hi], cross[s][:, 0, lo:hi]),
                torch.float32, axis=-1)
            for c, s in zip(codes, ("ks", "vs"))]


@pytest.mark.parametrize("cache_dtype", ["bf16", "q8_0", "q4_0"])
def test_cross_planes_extension_matches_prefill(setup, cache_dtype):
    """A chunk's cross K/V written by the extension equal those the
    finalize prefill writes over the same states, in every pool tier;
    the pool and the encoder lengths keep their storage."""
    _, tm, jp = setup
    c1, c2 = _chunks(np.random.default_rng(5), (6, 5))
    eng = ServeEngine(tm, _bridge(jp), n_slots=1, max_len=32, enc_len=16,
                      cache_dtype=cache_dtype, device="cpu")
    ptrs = [t.data_ptr() for t in eng.cache["layers"]["cross"].values()]
    lens_ptr = eng._enc_lens.data_ptr()
    st = eng.open_stream(StreamingAudioRequest(
        uid=0, tokens=[1, 2], max_new=4, eos_id=-2, chunks=[c1, c2]))
    eng.stream_feed(st, c1)                    # anchor: prefill over c1
    eng.stream_feed(st, c2)                    # extension in place
    inc = _planes(eng, 6, 11)
    assert int(eng._enc_lens[0]) == 11
    assert eng.lanestate.held(0)["cross_kv"] == 11
    eng.stream_finalize(st)                    # prefill over c1 + c2
    fin = _planes(eng, 6, 11)
    assert float(inc[0].abs().max()) > 0
    for a, b in zip(inc, fin):
        torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)
    assert [t.data_ptr() for t in eng.cache["layers"]["cross"].values()] \
        == ptrs
    assert eng._enc_lens.data_ptr() == lens_ptr


# ------------------------------------------------------ streams served

def test_transcribe_stream_matches_one_shot_and_jax(setup):
    """``transcribe(stream=True)`` through a reused engine emits the
    one-shot tokens, with partial hypotheses on the way, and the tokens
    and partials of ``repro.transcribe(stream=True)``."""
    jm, tm, jp = setup
    tparams = _bridge(jp)
    x = synth_waveform(0.4)
    one = repro_torch.transcribe(x, model=tm, params=tparams,
                                 chunk_frames=6, max_new=5, device="cpu")
    got = repro_torch.transcribe(x, model=tm, params=tparams,
                                 chunk_frames=6, max_new=5, stream=True,
                                 engine=one.engine)
    assert got.tokens == one.tokens
    assert len(got.partials) >= 2 and one.partials == []
    assert got.n_frames == one.n_frames == 20
    assert got.host_syncs == got.ticks and one.engine.n_streams == 0
    want = repro.transcribe(x, model=jm, params=jp, chunk_frames=6,
                            max_new=5, stream=True)
    enc = want.engine.encode_chunks(
        j_chunk_list(np.asarray(j_audio_frames(x, D)), 6))
    flip = _assert_greedy_matches(jm, jp, [1], enc, got.tokens, want.tokens)
    assert [len(p) for p in got.partials] == [len(p) for p in want.partials]
    if flip is None:
        assert got.partials == want.partials


def test_streams_mixed_with_audio_requests(setup):
    """Streams and one-shot audio requests share the pool: both complete,
    the slots are recycled, the stream bookkeeping drains."""
    _, tm, jp = setup
    eng = ServeEngine(tm, _bridge(jp), n_slots=2, max_len=32, enc_len=16,
                      device="cpu")
    sched = BatchScheduler(eng)
    frames = _chunks(np.random.default_rng(0), (10,))[0]
    sched.submit(StreamingAudioRequest(uid=0, tokens=[1, 2], max_new=4,
                                       eos_id=-2,
                                       chunks=chunk_list(frames, 4)))
    sched.submit(AudioRequest(uid=1, tokens=[3, 4, 5], max_new=3,
                              eos_id=-2, enc_frames=frames))
    sched.run_until_drained(max_ticks=100)
    assert sched.drained and eng.n_streams == 0
    assert len(sched.results[0].out) == 4
    assert len(sched.results[0].partials) >= 3   # one per chunk + final
    assert len(sched.results[1].out) == 3
    assert not sched.results[0].error and not sched.results[1].error
    assert sorted(eng.free) == [0, 1] and eng.lanestate.drained
    assert sched.metrics.completed == 2 and sched.metrics.admitted == 2


def test_stream_validation_and_rejection(setup):
    """The stream branch of ``validate`` and the refusals around it."""
    _, tm, jp = setup
    tparams = _bridge(jp)
    eng = ServeEngine(tm, tparams, n_slots=1, max_len=32, enc_len=8,
                      device="cpu")
    big = [np.zeros((6, D), np.float32), np.zeros((6, D), np.float32)]
    rej = eng.validate(StreamingAudioRequest(uid=0, tokens=[1], max_new=2,
                                             chunks=big))
    assert rej.code == RejectCode.ENC_OVERFLOW     # 12 > enc_len 8
    rej = eng.validate(StreamingAudioRequest(
        uid=0, tokens=[1], max_new=2,
        chunks=[np.zeros((2, D)), np.zeros((2, 64))]))
    assert rej.code == RejectCode.BAD_ENC_SHAPE and "chunk 1" in rej.message
    rej = eng.validate(StreamingAudioRequest(
        uid=0, tokens=[1] * 20, max_new=12, chunks=[np.zeros((2, D))]))
    assert rej.code == RejectCode.TOO_LONG
    with pytest.raises(ValueError, match="open_stream"):
        eng.admit(StreamingAudioRequest(uid=1, tokens=[1], max_new=2,
                                        chunks=[np.zeros((2, D))]))
    with pytest.raises(ValueError, match="StreamingAudioRequest"):
        eng.open_stream(AudioRequest(uid=1, tokens=[1], max_new=2,
                                     enc_frames=np.zeros((2, D))))
    with pytest.raises(RejectionError):
        eng.open_stream(StreamingAudioRequest(uid=1, tokens=[1], max_new=2,
                                              chunks=big))
    with pytest.raises(ValueError):
        StreamingAudioRequest(uid=2, tokens=[1], max_new=2, chunks=[])
    with pytest.raises(ValueError):
        StreamingAudioRequest(uid=2, tokens=[1], max_new=2,
                              chunks=[np.zeros((2, D))],
                              enc_frames=np.zeros((2, D)))
    # both encoder inputs on a plain request cannot be served
    assert eng.validate(AudioRequest(
        uid=3, tokens=[1], max_new=2,
        enc_frames=np.zeros((4, D), np.float32),
        enc_states=np.zeros((4, D), np.float32))).code \
        == RejectCode.AMBIGUOUS_ENC_INPUT
    # the scheduler completes an unservable stream as a failed state
    sched = BatchScheduler(eng)
    st = sched.submit(StreamingAudioRequest(uid=4, tokens=[1], max_new=2,
                                            chunks=big))
    assert st is not None and st.error and st.slot == -1
    assert st.error_code == RejectCode.ENC_OVERFLOW
    # a stream overflowing mid-way is refused at the feed
    eng2 = ServeEngine(tm, tparams, n_slots=1, max_len=32, enc_len=8,
                       device="cpu")
    st = eng2.open_stream(StreamingAudioRequest(
        uid=5, tokens=[1], max_new=2, chunks=[np.zeros((4, D))]))
    eng2.stream_feed(st, np.zeros((4, D), np.float32))
    with pytest.raises(RejectionError, match="overflows"):
        eng2.stream_feed(st, np.zeros((5, D), np.float32))
    # a spec engine keeps spec_k - 1 positions of headroom for streams
    spec = ServeEngine(tm, tparams, n_slots=1, max_len=32, enc_len=8,
                       decode_block=4, spec_k=4, device="cpu")
    req = StreamingAudioRequest(uid=6, tokens=[1] * 8, max_new=22,
                                chunks=[np.zeros((2, D))])
    assert eng.validate(req) is None                 # 8 + 22 < 32
    assert spec.validate(req).code == RejectCode.TOO_LONG
    # a decoder-only engine refuses streams
    xm = build(t_reduced(t_get_config("xlstm-350m")))
    xeng = ServeEngine(xm, xm.init_values(torch.Generator().manual_seed(0),
                                          device="cpu"),
                       n_slots=1, max_len=32, device="cpu")
    assert xeng.validate(StreamingAudioRequest(
        uid=7, tokens=[1], max_new=2, chunks=[np.zeros((2, D))])).code \
        == RejectCode.ENC_ON_DECODER_ONLY


def _serve_stream(tm, tparams, **kw):
    """A stream whose lane finishes its mid-stream hypothesis at once
    (``max_new=2``) and parks, beside a one-shot request, through the
    scheduler (the reference's parked-lane parity tests)."""
    rng = np.random.default_rng(1)
    chunks = _chunks(rng, (4, 4, 4))
    frames = _chunks(rng, (8,))[0]
    eng = ServeEngine(tm, tparams, n_slots=4, max_len=64, enc_len=16,
                      device="cpu", **kw)
    sched = BatchScheduler(eng)
    sched.submit(StreamingAudioRequest(uid=0, tokens=[5, 6], max_new=2,
                                       eos_id=-2, chunks=chunks))
    sched.submit(AudioRequest(uid=1, tokens=[7, 8, 9], max_new=9,
                              eos_id=-2, enc_frames=frames))
    sched.run_until_drained(max_ticks=100)
    assert sched.drained and eng.n_streams == 0 and eng.lanestate.drained
    return sched.results, eng


def test_stream_decode_block_parity(setup):
    """A parked streaming lane stays frozen through fused ticks while the
    other lane decodes: ``decode_block`` 1 and 4 give the same tokens and
    partials."""
    _, tm, jp = setup
    tparams = _bridge(jp)
    seq, _ = _serve_stream(tm, tparams, decode_block=1)
    fus, eng = _serve_stream(tm, tparams, decode_block=4)
    assert fus[0].out == seq[0].out and len(fus[0].out) == 2
    assert fus[0].partials == seq[0].partials
    assert len(fus[0].partials) == 4              # 3 chunks + the final
    assert fus[1].out == seq[1].out
    assert eng._host_syncs == eng._ticks


@pytest.mark.parametrize("cache_dtype", ["bf16", "q8_0", "q4_0"])
def test_spec_stream_equals_plain(setup, cache_dtype):
    """A stream served by a ``spec_k=4`` engine emits the plain engine's
    transcript and partial hypotheses (the reference's
    ``test_spec_streaming_whisper_parity``)."""
    _, tm, jp = setup
    tparams = _bridge(jp)
    plain, _ = _serve_stream(tm, tparams, decode_block=4,
                             cache_dtype=cache_dtype)
    spec, eng = _serve_stream(tm, tparams, decode_block=4, spec_k=4,
                              cache_dtype=cache_dtype)
    assert spec[0].out == plain[0].out
    assert spec[0].partials == plain[0].partials
    assert spec[1].out == plain[1].out
    assert eng._verify_steps == eng._ticks > 0


def test_abort_of_an_open_stream(setup):
    """Aborting an open stream, fed or not yet, frees its slot and its
    lane-state reservation and closes the stream."""
    _, tm, jp = setup
    eng = ServeEngine(tm, _bridge(jp), n_slots=2, max_len=32, enc_len=16,
                      decode_block=2, device="cpu")
    chunks = _chunks(np.random.default_rng(3), (4, 4, 4))
    sched = BatchScheduler(eng)
    sched.submit(StreamingAudioRequest(uid=0, tokens=[1], max_new=6,
                                       eos_id=-2, chunks=chunks))
    sched.tick()                     # opened, first chunk fed, anchored
    assert eng.n_streams == 1 and eng.lanestate.n_live == 1
    st = sched.abort(0)
    assert st.done and st.error_code == RejectCode.CANCELLED
    assert eng.n_streams == 0 and eng.n_active == 0
    assert sorted(eng.free) == [0, 1] and eng.lanestate.drained
    assert sched.drained and int(eng._enc_lens.abs().sum()) == 0
    # opened and never fed: abort on the engine
    st = eng.open_stream(StreamingAudioRequest(uid=1, tokens=[1],
                                               max_new=6, chunks=chunks))
    assert eng.n_streams == 1 and len(eng.free) == 1
    eng.abort(st)
    assert eng.n_streams == 0 and sorted(eng.free) == [0, 1]
    assert eng.lanestate.drained
    assert sched.abort(99) is None


# ------------------------------------------------------------- CLIs

def test_transcribe_cli_streams_on_the_cpu():
    args = ["--device", "cpu", "--seconds", "0.3", "--max-new", "4",
            "--decode-block", "2", "--cache-dtype", "q8_0"]
    one = transcribe_cli.main(args)
    streamed = transcribe_cli.main(args + ["--stream"])
    assert streamed.tokens == one.tokens and len(one.tokens) == 4
    assert len(streamed.partials) >= 2 and streamed.cache_dtype == "q8_0"


def test_serve_cli_spec_k_gives_the_plain_tokens(monkeypatch):
    made = []

    class Recording(BatchScheduler):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr("repro_torch.serving.scheduler.BatchScheduler",
                        Recording)
    args = ["--arch", "whisper-tiny-en", "--reduced", "--requests", "3",
            "--slots", "2", "--max-len", "64", "--enc-len", "16",
            "--max-new", "6", "--decode-block", "4", "--device", "cpu"]
    serve_cli.main(args + ["--spec-k", "0"])
    serve_cli.main(args + ["--spec-k", "4"])
    plain, spec = made
    assert spec.engine.spec_k == 4 and plain.engine.spec_k == 0
    assert spec.engine._verify_steps > 0
    assert {u: st.out for u, st in spec.results.items()} \
        == {u: st.out for u, st in plain.results.items()}
    assert len(spec.results) == 3
