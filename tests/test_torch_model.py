"""The port's frontend and Whisper model against the JAX package, on the
reduced whisper-tiny-en (2+2 layers, d_model 128, 4 query heads over 2
KV heads, head_dim 32) with the reference's own parameters carried
across by the bridge.

Tolerances: activations are bf16 in both packages, rounded at slightly
different places (XLA vs PyTorch elementwise fusion, bf16 GELU). States,
caches and logits of magnitude up to ~4 differ by at most two bf16 ulps
at that magnitude (0.031 measured), and the relative error over a whole
tensor, ||a - b|| / ||b||, is at most 0.0082 measured. ``assert_near``
allows 0.05 absolute (three ulps) and 1.5e-2 relative, so a divergence
spread over the tensor fails even where no element passes 0.05. The
frontend is f32 end to end: 1e-4, as the reference's own golden test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.audio.features import audio_frames as j_audio_frames
from repro.configs import get_config, reduced
from repro.core.quantize import quantize_tree as j_quantize_tree
from repro.kernels.api import DispatchContext as JDispatchContext
from repro.kernels.api import use_context as j_use_context
from repro.models.attention import quantize_kv_cache as j_quantize_kv
from repro.models.layers import logits_head as j_logits_head
from repro.models.model import build as j_build
from repro_torch.audio.features import audio_frames, log_mel, log_mel_ref
from repro_torch.audio.stream import synth_waveform
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.attention import quantize_kv_cache
from repro_torch.models.layers import logits_head
from repro_torch.models.model import build

MAX_ABS = 0.05
MAX_REL = 1.5e-2
VOCAB = 512
ENC_S = 40


@pytest.fixture(scope="module")
def models():
    cfg = reduced(get_config("whisper-tiny-en"))
    tcfg = t_reduced(t_get_config("whisper-tiny-en"))
    assert dataclasses_equal(cfg, tcfg)
    jm, tm = j_build(cfg), build(tcfg)
    jp = jm.init_values(jax.random.key(0))
    return jm, tm, jp


def dataclasses_equal(a, b):
    import dataclasses
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    return {k: fa[k] for k in fb} == fb


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_near(got, want, max_abs=MAX_ABS, max_rel=MAX_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=max_abs, rtol=0)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= max_rel, rel


def test_log_mel_matches_numpy_golden():
    for seconds in (0.37, 1.0):
        x = synth_waveform(seconds, seed=3)
        np.testing.assert_allclose(log_mel(x, device="cpu").numpy(),
                                   log_mel_ref(x), atol=1e-4, rtol=1e-4)
    assert log_mel(np.zeros(0, np.float32), device="cpu").shape == (0, 80)


def test_audio_frames_match_jax():
    x = synth_waveform(0.61, seed=1)
    want = np.asarray(j_audio_frames(x, 128))
    got = audio_frames(x, 128, device="cpu")
    assert got.shape == want.shape == (31, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_init_values_shapes_and_distributions(models):
    jm, tm, jp = models
    tp = tm.init_values(torch.Generator().manual_seed(0), device="cpu")

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, path + (k,))
        else:
            yield path, tuple(tree.shape)
    assert dict(walk(jax.tree.map(np.asarray, jp))) == dict(walk(tp))
    d = tm.cfg.d_model
    wq = tp["enc_layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(tp["dec_pos"].std()) - 0.02) < 0.002
    assert float(tp["dec_layers"]["ln1"]["scale"].min()) == 1.0
    assert float(tp["enc_ln"]["bias"].abs().max()) == 0.0


@pytest.mark.parametrize("weights", ["bf16", "q8_0"])
def test_encode_prefill_and_decode_logits_match_jax(models, weights):
    jm, tm, jp = models
    jparams = j_quantize_tree(jp) if weights == "q8_0" else jp
    tparams = _bridge(jparams)
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((1, ENC_S, 128)).astype(np.float32)
    toks = np.array([[1, 5, 9, 3, 0, 0, 0, 0]], np.int32)

    je = _f32(jm.encode(jparams, jnp.asarray(frames)))
    te = tm.encode(tparams, torch.from_numpy(frames))
    assert_near(te.float().numpy(), je)

    jl, jc = jm.forward(jparams, {"tokens": jnp.asarray(toks),
                                  "enc_frames": jnp.asarray(frames)},
                        mode="prefill", cache=jm.init_cache(1, 16, ENC_S))
    tl, tc = tm.forward(tparams, {"tokens": torch.from_numpy(toks).long(),
                                  "enc_frames": torch.from_numpy(frames)},
                        mode="prefill",
                        cache=tm.init_cache(1, 16, ENC_S, device="cpu"))
    assert_near(tl.numpy()[..., :VOCAB], _f32(jl)[..., :VOCAB])
    # the prefill caches agree too, plane for plane
    for kind in ("self", "cross"):
        for key in ("k", "v"):
            assert_near(tc["layers"][kind][key].float().numpy(),
                        _f32(jc["layers"][kind][key]))

    # one decode step against the same (bridged) cache, bf16 and q8_0
    for cache_tier in ("bf16", "q8_0"):
        jcache = j_quantize_kv(jc) if cache_tier == "q8_0" else jc
        tcache = _bridge(jcache)
        jd, jn = jm.forward(jparams, {"tokens": jnp.asarray([[7]]),
                                      "enc_lens": jnp.asarray([ENC_S])},
                            mode="decode", cache=jcache,
                            pos=jnp.asarray([4]))
        td, tn = tm.forward(tparams, {"tokens": torch.tensor([[7]]),
                                      "enc_lens": torch.tensor([ENC_S])},
                            mode="decode", cache=tcache,
                            pos=torch.tensor([4]))
        assert_near(td.numpy()[..., :VOCAB], _f32(jd)[..., :VOCAB])
        assert int(td[0, 0, :VOCAB].argmax()) == \
            int(jnp.argmax(jd[0, 0, :VOCAB]))
        # the port wrote the new token in place; the planes match JAX's
        key = "kq" if cache_tier == "q8_0" else "k"
        got_plane = tn["layers"]["self"][key][:, :, 4].float().numpy()
        want_plane = _f32(jn["layers"]["self"][key][:, :, 4])
        if key == "kq":   # int8 codes of nearly equal inputs: off by <= 1
            np.testing.assert_allclose(got_plane, want_plane, atol=1.01)
        else:
            assert_near(got_plane, want_plane)


def test_quantize_kv_cache_matches_jax(models):
    jm, tm, _ = models
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 1, 16, 2, 32)).astype(np.float32)
    tree = {"layers": {"self": {"k": k, "v": -k}, "cross": {"k": k,
                                                           "v": k * 2}}}
    want = j_quantize_kv(jax.tree.map(jnp.asarray, tree))
    got = quantize_kv_cache(params_from_numpy(tree))
    for kind in ("self", "cross"):
        for key in ("kq", "ks", "vq", "vs"):
            np.testing.assert_array_equal(
                got["layers"][kind][key].numpy(),
                np.asarray(want["layers"][kind][key]))


def _j_prefill_cache(jm, jparams, frames, toks, max_len=16):
    """The reference's prefill cache (the port's prefill matches it, see
    the test above): both packages decode from the same bridged cache."""
    _, jc = jm.forward(jparams, {"tokens": jnp.asarray(toks),
                                 "enc_frames": jnp.asarray(frames)},
                       mode="prefill", cache=jm.init_cache(1, max_len, ENC_S))
    return jc


def _j_q4_ref_ctx():
    """The reference's context with ``q4_matmul`` on its ``ref`` oracle:
    its host path ``q4_matmul_xla`` is a bf16 x bf16 -> f32 dot that
    jax's CPU runtime refuses."""
    import dataclasses
    return dataclasses.replace(JDispatchContext.from_env(),
                               backends={"q4_matmul": "ref"})


@pytest.mark.parametrize("cache_tier", ["bf16", "q8_0", "q4_0"])
def test_verify_forward_matches_jax(models, cache_tier):
    """The speculative verify: 4 tokens a lane in one decode forward, token
    j at pos + j attending [0, pos + j], against the reference's
    multi-query decode on the same cache; all 4 positions' K/V land in
    place."""
    jm, tm, jp = models
    tparams = _bridge(jp)
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((1, ENC_S, 128)).astype(np.float32)
    toks = np.array([[1, 5, 9, 3, 0, 0, 0, 0]], np.int32)
    jc = _j_prefill_cache(jm, jp, frames, toks)
    jcache = j_quantize_kv(jc, cache_tier) if cache_tier != "bf16" else jc
    tcache = _bridge(jcache)
    key = {"bf16": "k", "q8_0": "kq", "q4_0": "kp"}[cache_tier]
    rest = tcache["layers"]["self"][key][:, :, 8:].clone()
    ver = [[7, 8, 2, 4]]
    jd, jn = jm.forward(jp, {"tokens": jnp.asarray(ver),
                             "enc_lens": jnp.asarray([ENC_S])},
                        mode="decode", cache=jcache, pos=jnp.asarray([4]))
    td, tn = tm.forward(tparams, {"tokens": torch.tensor(ver),
                                  "enc_lens": torch.tensor([ENC_S])},
                        mode="decode", cache=tcache, pos=torch.tensor([4]))
    assert td.shape == (1, 4, jd.shape[-1])
    # A q4_0 code step is a block's max / 7: where the two packages' bf16
    # K/V of a new token round to different nibbles (1-2 of the 256 bytes
    # written here), the logits move by up to 0.061 abs, 0.017 relative
    # (measured; 0.047 / 0.016 for a single decode step). Held to 0.1 and
    # 3e-2 there, with the argmax equal; the other tiers as above.
    tol = (0.1, 3e-2) if cache_tier == "q4_0" else (MAX_ABS, MAX_REL)
    assert_near(td.numpy()[..., :VOCAB], _f32(jd)[..., :VOCAB], *tol)
    np.testing.assert_array_equal(td[0, :, :VOCAB].argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jd[0, :, :VOCAB],
                                                        -1)))
    got = tn["layers"]["self"][key][:, :, 4:8].float().numpy()
    want = _f32(jn["layers"]["self"][key][:, :, 4:8])
    if key == "k":
        assert_near(got, want)
    elif key == "kq":   # int8 codes of nearly equal inputs: off by <= 1
        np.testing.assert_allclose(got, want, atol=1.01)
    else:               # packed nibble pairs: each nibble off by <= 1
        g, w = got.astype(np.int64), want.astype(np.int64)
        assert np.abs((g & 15) - (w & 15)).max() <= 1
        assert np.abs((g >> 4) - (w >> 4)).max() <= 1
    # the positions past the 4 new tokens are untouched
    assert torch.equal(tn["layers"]["self"][key][:, :, 8:], rest)


def test_draft_step_on_q4_params_matches_jax(models):
    """One decode step of the speculative draft: Q4_0 weights through
    q4_matmul, the Q4 vocab table widened to bf16, on a q4_0 cache. The
    draft's tied head alone, on one bf16 input, to f32 accumulation
    order: the reference's bf16 x bf16 -> f32 product, never rounded to
    bf16 (within 1e-5 of the largest logit; a bf16 rounding of the
    logits would be up to 2 ** -9 of it). The whole step to
    ``assert_near``, whose bf16 GEMMs upstream of the head set it."""
    jm, tm, jp = models
    jq4 = j_quantize_tree(jp, tier="q4_0")
    tq4 = _bridge(jq4)
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((1, ENC_S, 128)).astype(np.float32)
    toks = np.array([[1, 5, 9, 3, 0, 0, 0, 0]], np.int32)
    jc = j_quantize_kv(_j_prefill_cache(jm, jp, frames, toks), "q4_0")
    with j_use_context(_j_q4_ref_ctx()):
        jd, _ = jm.forward(jq4, {"tokens": jnp.asarray([[7]]),
                                 "enc_lens": jnp.asarray([ENC_S])},
                           mode="decode", cache=jc, pos=jnp.asarray([4]))
    td, _ = tm.forward(tq4, {"tokens": torch.tensor([[7]]),
                             "enc_lens": torch.tensor([ENC_S])},
                       mode="decode", cache=_bridge(jc),
                       pos=torch.tensor([4]))
    assert_near(td.numpy()[..., :VOCAB], _f32(jd)[..., :VOCAB])
    x = jnp.asarray(rng.standard_normal((1, 3, 128)), jnp.bfloat16)
    want = _f32(j_logits_head(jq4["embed"], x, VOCAB))
    got = logits_head(tq4["embed"], tensor_from_numpy(np.asarray(x)),
                      VOCAB).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got[..., :VOCAB], want[..., :VOCAB], rtol=0,
                               atol=1e-5 * np.abs(want[..., :VOCAB]).max())
