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
from repro.models.attention import quantize_kv_cache as j_quantize_kv
from repro.models.model import build as j_build
from repro_torch.audio.features import audio_frames, log_mel, log_mel_ref
from repro_torch.audio.stream import synth_waveform
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models.attention import quantize_kv_cache
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


def assert_near(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=MAX_ABS, rtol=0)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= MAX_REL, rel


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
