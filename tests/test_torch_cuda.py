"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs an NVIDIA GPU and ``nvcc`` (marker ``cuda``) and
skips without one. The file imports no JAX, so it also runs where JAX
is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Shapes are the main path's (whisper-tiny.en: d_model 384, 6 heads of 64,
d_ff 1536, 1500 encoder frames, the 32-token prefill bucket, decode at a
few lanes, the speculative verify's 4 queries a lane; xlstm-350m: the
sLSTM recurrence over 4 heads of 256 and the f32 head (4,1024) @
(1024,51200); the decoder-only models' attention at head_dim 128 with
GQA 4 and 8, at 112 (zamba2-7b) and at 256 with softcap and window)
plus small ragged ones. Both sides accumulate in f32 in a
different order, so f32 results agree to ~1e-5 relative; results stored
in bf16 agree to one bf16 rounding of each side, at most 2^-7 of the
largest output (``assert_bf16_close``). The attention cases also run
with V only on the last keys before the end (or before a lane's length,
with a large V past it), so a kernel that drops the ragged last tile or
reads short or past ``length`` fails.

The serving engine's decode tick replayed from a CUDA graph is held to
the eager tick (``cuda_graph=False``) at the reduced whisper-tiny.en
(bf16, q8_0, q4_0, ``spec_k=4``, a stream whose cross K/V grows between
replays), xlstm-350m, qwen3-4b (bf16 and Q8_0 weights with the q8_0
cache), qwen3-moe-30b-a3b, gemma2-2b and the zamba2-7b hybrid (15
layers: mamba states, the shared block's K/V and the tail): tokens and
logits bit for bit,
one capture per tick size, one synchronising call a tick. The streaming frontend equals
the one-shot frontend bit for bit on the card. The paged engine's
captured tick, whose page-table rows are rewritten between replays
(admissions, a stream's cross pages, freed lanes), equals its eager tick
and its slot-pool twin bit for bit, and the paged decode op's CUDA route
(the gather, then the tier's decode-attention kernel) its plain version.
A tick fetched on an executor thread, as the gateway fetches it, is the
tick issued on another stream of the main thread. The bf16 decode
attention's card formulation (bf16 planes into f32 results) equals the
widened one within 1e-5 of the largest output, and the paged bf16 tick
the slot pool's bit for bit. The static checks (``repro_torch.
staticcheck``) pass on the card: no synchronising call inside a traced
program, buffers in place, one capture per tick size. A reduced train
step on the card (whisper-tiny.en, qwen3-4b, and qwen3-moe-30b-a3b and
zamba2-7b, whose backward runs through the MoE combine and the mamba
blocks) launches no kernel (the grad-safe torch bindings) and matches
the same step on the CPU.
"""

import gc
import warnings

import numpy as np
import pytest
import torch

from repro_torch.audio.features import audio_frames
from repro_torch.audio.stream import StreamingFrontend, synth_waveform
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import api
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import plain as pa_plain
from repro_torch.kernels.flash_attention import plain as fa_plain
from repro_torch.kernels.fp16_matmul import ops as mm_ops
from repro_torch.kernels.fp16_matmul import plain as mm_plain
from repro_torch.kernels.q4_attention import ops as q4a_ops
from repro_torch.kernels.q4_attention import plain as q4a_plain
from repro_torch.kernels.q4_matmul import ops as q4_ops
from repro_torch.kernels.q4_matmul import plain as q4_plain
from repro_torch.kernels.q8_attention import ops as qa_ops
from repro_torch.kernels.q8_attention import plain as qa_plain
from repro_torch.kernels.q8_matmul import ops as q8_ops
from repro_torch.kernels.q8_matmul import plain as q8_plain
from repro_torch.kernels.slstm_scan import ops as sl_ops
from repro_torch.kernels.slstm_scan import plain as sl_plain
from repro_torch.models.model import build
from repro_torch.quantize import (Q4Tensor, Q8Tensor, quantize_q4_0,
                                  quantize_q8_0, quantize_tree)
from repro_torch.serving.engine import (AudioRequest, Request, ServeEngine,
                                        StreamingAudioRequest)
from repro_torch.serving.scheduler import BatchScheduler

pytestmark = pytest.mark.cuda

BF16_RTOL = 2 ** -7   # two roundings to bf16 (kernel and plain output)


def assert_bf16_close(got, want):
    """Within one bf16 rounding of each side at the largest output."""
    err = float((got.float() - want.float()).abs().max())
    tol = BF16_RTOL * float(want.float().abs().max())
    assert tol > 0 and err <= tol, (err, tol)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype=torch.float32, scale=1.0):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return (x * scale).to(dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n", [(3000, 201, 80), (1500, 80, 384),
                                   (1500, 384, 1536), (1500, 1536, 384),
                                   (32, 384, 384), (4, 384, 1536),
                                   (1, 1536, 384), (33, 45, 70),
                                   # the decoder's GEMVs, and the verify's
                                   # rows on each side of the GEMV/tile
                                   # threshold (16 rows)
                                   (1, 384, 384), (1, 384, 1536),
                                   (4, 1536, 384), (15, 1536, 384),
                                   (16, 1536, 384), (17, 1536, 384),
                                   (32, 1536, 384), (1500, 384, 384)])
def test_fp16_matmul_kernel(dev, dtype, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = _randn(rng, (m, k), dev, dtype)
    w = _randn(rng, (k, n), dev, dtype, k ** -0.5)
    before = mm_ops.fp16_matmul.launches
    got = mm_ops.fp16_matmul(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm_ops.fp16_matmul.launches == before + 1
    want = mm_plain.fp16_matmul(x, w, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    got16 = mm_ops.fp16_matmul(x, w, out_dtype=torch.bfloat16)
    torch.testing.assert_close(got16.float(), want, rtol=BF16_RTOL,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("m,k,n", [(1500, 384, 384), (1500, 384, 1536),
                                   (1500, 1536, 384), (32, 384, 1536),
                                   (4, 1536, 384), (1, 384, 384),
                                   # N % 16 != 0: element loads, GEMV
                                   # and tile
                                   (7, 64, 50), (33, 96, 70),
                                   # the GEMV/tile threshold (16 rows) and
                                   # one row on each side of it
                                   (15, 1536, 384), (16, 1536, 384),
                                   (17, 1536, 384), (15, 1536, 1536),
                                   (16, 1536, 1536), (17, 1536, 1536)])
def test_q8_matmul_kernel(dev, dtype, m, k, n):
    """The tile layout (M > 16, tensor cores for bf16 and f16 x, f32
    FMAs for f32 x) and the split-K GEMV layout (M <= 16), against the
    plain version in f32, and rounded to x's type."""
    assert q8_ops.GEMV_MAX_M == 16
    rng = np.random.default_rng(m * k + n)
    x = _randn(rng, (m, k), dev, dtype)
    w = quantize_q8_0(_randn(rng, (k, n), dev, scale=k ** -0.5), axis=0)
    before = q8_ops.q8_matmul.launches
    got = q8_ops.q8_matmul(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert q8_ops.q8_matmul.launches == before + 1
    want = q8_plain.q8_matmul(x, w.q, w.scale, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if dtype != torch.float32:
        assert_bf16_close(q8_ops.q8_matmul(x, w, out_dtype=dtype), want)


@pytest.mark.parametrize("tail", [None, 3])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window,softcap", [
    (1, 1500, 1500, 6, 6, 64, False, None, None),   # encoder
    (1, 32, 32, 6, 6, 64, True, None, None),        # decoder prefill
    (1, 32, 1500, 6, 6, 64, False, None, None),     # cross prefill
    (2, 40, 40, 4, 2, 32, True, None, None),        # reduced GQA
    (2, 70, 70, 4, 2, 32, True, 16, None),          # sliding window
    (1, 50, 50, 2, 1, 64, True, None, 5.0),         # softcap
    (1, 45, 20, 4, 4, 64, True, None, None),        # sq > skv, causal
    # KV split across blocks (few queries against 1500 frames) and the
    # combine: Sq 1, 16 and 33; a ragged Skv whose last tile holds 29
    # keys (1501) or 1 (65); GQA with D = 32; a causal window, whose
    # splits past the diagonal hold no key a row sees; rows whose every
    # key is masked (causal window, Sq > Skv); softcap
    (1, 1, 1500, 6, 6, 64, False, None, None),
    (1, 16, 1500, 6, 6, 64, False, None, None),
    (1, 33, 1500, 6, 6, 64, False, None, None),
    (1, 32, 1501, 6, 6, 64, False, None, None),
    (2, 40, 65, 6, 6, 64, False, None, None),
    (2, 16, 1500, 4, 2, 32, False, None, None),
    (1, 33, 1500, 6, 6, 64, True, 100, None),
    (1, 200, 65, 2, 1, 32, True, 16, None),
    (1, 16, 1500, 4, 1, 64, False, None, 5.0),
    # head_dim 128 (the decoder-only models: qwen3-4b's GQA 4, qwen3-moe's
    # GQA 8) and 256 (gemma2-2b: softcap 50, a window that binds), with a
    # ragged S, the KV split and rows whose every key is masked
    (1, 256, 256, 32, 8, 128, True, None, None),
    (1, 200, 200, 32, 4, 128, True, None, None),
    (2, 70, 70, 4, 2, 128, True, 16, 50.0),
    (1, 33, 1500, 8, 4, 128, False, None, None),
    (1, 256, 256, 8, 4, 256, True, 128, 50.0),
    (1, 200, 200, 8, 4, 256, True, None, 50.0),
    (1, 33, 1500, 8, 4, 256, False, None, None),
    (1, 200, 65, 2, 1, 256, True, 16, None),
    # head_dim 112 (zamba2-7b's shared block, 32 heads MHA): its prefill
    # buckets, the ragged S = 300, the KV split and masked rows
    (1, 64, 64, 32, 32, 112, True, None, None),
    (1, 300, 300, 32, 32, 112, True, None, None),
    (1, 33, 1500, 8, 8, 112, False, None, None),
    (1, 200, 65, 2, 1, 112, True, 16, None),
])
def test_flash_attention_kernel(dev, b, sq, skv, h, hkv, d, causal, window,
                                softcap, tail):
    rng = np.random.default_rng(sq * 7 + skv)
    q = _randn(rng, (b, sq, h, d), dev, torch.bfloat16)
    k = _randn(rng, (b, skv, hkv, d), dev, torch.bfloat16)
    v = _randn(rng, (b, skv, hkv, d), dev, torch.bfloat16)
    if tail:   # V only on the last keys a row sees (causal: the keys
        # before min(Sq, Skv); the later keys keep V and must weigh 0):
        # the output is the ragged tile's
        v[:, :(min(sq, skv) if causal else skv) - tail] = 0
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa_plain.flash_attention(q, k, v, **kw)
    assert_bf16_close(got, want)


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 51200), (1, 384, 70),
                                   (16, 1536, 384), (77, 1024, 512),
                                   (33, 45, 70)])
def test_fp16_matmul_kernel_f32_x_16_bit_w(dev, wdtype, m, k, n):
    """f32 x with a bf16 or f16 w widened in the kernel (the xLSTM head
    reads its bf16 lm_head as stored): the plain version's f32 products,
    to f32 summation order, in the GEMV and in the FMA loop."""
    rng = np.random.default_rng(m + n + k)
    x = _randn(rng, (m, k), dev)
    w = _randn(rng, (k, n), dev, wdtype, k ** -0.5)
    before = mm_ops.fp16_matmul.launches
    got = mm_ops.fp16_matmul(x, w)
    torch.cuda.synchronize()
    assert mm_ops.fp16_matmul.launches == before + 1
    assert_f32_close(got, mm_plain.fp16_matmul(x, w))


def test_fp16_matmul_kernel_refuses_other_pairs(dev):
    x = torch.zeros((4, 64), device=dev, dtype=torch.float16)
    for xd, wd in ((torch.float16, torch.bfloat16),
                   (torch.bfloat16, torch.float16),
                   (torch.float16, torch.float32)):
        with pytest.raises(TypeError):
            mm_ops.fp16_matmul(x.to(xd), torch.zeros((64, 8), device=dev,
                                                     dtype=wd))


def _q8_planes(rng, shape, dev):
    t = quantize_q8_0(_randn(rng, shape, dev), axis=-1)
    return t.q, t.scale


@pytest.mark.parametrize("bh,s,d", [(24, 1500, 64), (6, 35, 64),
                                    (8, 40, 32)])
def test_q8_decode_attention_kernel(dev, bh, s, d):
    rng = np.random.default_rng(bh + s)
    q = _randn(rng, (bh, 1, d), dev, torch.bfloat16)
    kq, ks = _q8_planes(rng, (bh, s, d), dev)
    vq, vs = _q8_planes(rng, (bh, s, d), dev)
    lens = torch.from_numpy(rng.integers(1, s + 1, bh)).to(dev)
    lens[0], lens[-1] = s, 0
    got = qa_ops.q8_decode_attention(q, kq, ks, vq, vs, lens)
    torch.cuda.synchronize()
    want = qa_plain.q8_decode_attention(q, kq, ks, vq, vs, lens)
    assert_bf16_close(got, want)
    assert float(got[-1].abs().max()) == 0.0


@pytest.mark.parametrize("bh,s,d", [(24, 1500, 64), (6, 35, 64)])
def test_q8_decode_attention_kernel_reads_exactly_to_length(dev, bh, s, d):
    # V only on the 3 positions before each lane's length and a large V
    # past it: reading short drops the output, reading long poisons it
    rng = np.random.default_rng(bh * s)
    q = _randn(rng, (bh, 1, d), dev, torch.bfloat16)
    kq, ks = _q8_planes(rng, (bh, s, d), dev)
    lens = torch.from_numpy(rng.integers(3, s + 1, bh)).to(dev)
    v = _randn(rng, (bh, s, d), dev)
    pos = torch.arange(s, device=dev)[None, :, None]
    n = lens[:, None, None]
    v = torch.where(pos >= n, 8.0 * v, torch.where(pos >= n - 3, v, 0.0))
    vt = quantize_q8_0(v, axis=-1)
    got = qa_ops.q8_decode_attention(q, kq, ks, vt.q, vt.scale, lens)
    torch.cuda.synchronize()
    want = qa_plain.q8_decode_attention(q, kq, ks, vt.q, vt.scale, lens)
    assert_bf16_close(got, want)


@pytest.mark.parametrize("L,b,s,h,hkv,d,layer", [(4, 4, 1500, 6, 6, 64, 2),
                                                 (4, 1, 35, 6, 6, 64, 3),
                                                 (2, 3, 40, 4, 2, 32, 1),
                                                 # GQA 4 and 8 at D = 128
                                                 (2, 4, 512, 32, 8, 128, 1),
                                                 (2, 4, 512, 32, 4, 128, 0)])
def test_q8_decode_attention_cache_kernel(dev, L, b, s, h, hkv, d, layer):
    rng = np.random.default_rng(L * b * s)
    q = _randn(rng, (b, 1, h, d), dev, torch.bfloat16)
    kq, ks = _q8_planes(rng, (L, b, s, hkv, d), dev)
    vq, vs = _q8_planes(rng, (L, b, s, hkv, d), dev)
    lens = torch.from_numpy(rng.integers(1, s + 1, b)).to(dev)
    got = qa_ops.q8_decode_attention_cache(q, kq, ks, vq, vs, lens, layer)
    torch.cuda.synchronize()
    want = qa_plain.q8_decode_attention_cache(q, kq, ks, vq, vs, lens,
                                              layer)
    assert_bf16_close(got, want)


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((4, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        mm_ops.fp16_matmul(x, torch.zeros((64, 8), device=dev))
    with pytest.raises(ValueError):
        mm_ops.fp16_matmul(x.t(), torch.zeros((4, 8), device=dev,
                                              dtype=torch.bfloat16))
    w = Q8Tensor(torch.zeros((64, 8), dtype=torch.int8, device=dev),
                 torch.zeros((2, 8), dtype=torch.float16, device=dev))
    with pytest.raises(ValueError):
        q8_ops.q8_matmul(torch.zeros((4, 32), device=dev), w)
    for d in (48, 96, 512):   # head_dims the kernel is not built for
        q = torch.zeros((2, 1, 4, d), device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa_ops.flash_attention(q, q, q)
    q = torch.zeros((2, 1, 4, 64), device=dev)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, q, q)
    kq = torch.zeros((2, 8, 64), dtype=torch.int8, device=dev)
    ks = torch.zeros((2, 8, 2), dtype=torch.float16, device=dev)
    with pytest.raises(TypeError):
        qa_ops.q8_decode_attention(torch.zeros((2, 1, 64), device=dev),
                                   kq, ks, kq, ks, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 384, 384), (1, 384, 1536),
                                   (1, 1536, 384), (4, 384, 384),
                                   (4, 384, 1536), (4, 1536, 384),
                                   (7, 64, 50), (33, 96, 70),
                                   # the GEMV's last row count, and one
                                   # past it (the row tile)
                                   (16, 384, 1536), (16, 1536, 384),
                                   (17, 384, 384), (1500, 384, 1536)])
def test_q4_matmul_kernel(dev, dtype, m, k, n):
    rng = np.random.default_rng(m * k + n + 1)
    x = _randn(rng, (m, k), dev, dtype)
    w = quantize_q4_0(_randn(rng, (k, n), dev, scale=k ** -0.5), axis=0)
    before = q4_ops.q4_matmul.launches
    got = q4_ops.q4_matmul(x, w, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert q4_ops.q4_matmul.launches == before + 1
    want = q4_plain.q4_matmul(x, w.q, w.scale, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    got16 = q4_ops.q4_matmul(x, w, out_dtype=torch.bfloat16)
    assert_bf16_close(got16, want)


@pytest.mark.parametrize("layout,cgw", [(q4_ops.MMA, 0), (q4_ops.GEMV, 1),
                                        (q4_ops.GEMV, 2)])
@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("m,k,n", [(4, 384, 1536), (1, 1536, 384),
                                   # N not a multiple of 16: byte loads
                                   # and a ragged last column group; 16 rows
                                   (3, 384, 200), (2, 1536, 77),
                                   (16, 384, 96)])
def test_q4_matmul_gemv_at_each_cluster_split(dev, monkeypatch, layout, cgw,
                                              ranks, m, k, n):
    """Both GEMVs (the tensor cores, and the CUDA cores at every
    column-group width) with K split across 1-8 CTAs of a cluster (each a
    whole number of 8-row runs of the packed w; every split here leaves no
    rank empty) and 1-8 warps a CTA."""
    rng = np.random.default_rng(ranks * 31 + cgw + n)
    x = _randn(rng, (m, k), dev, torch.bfloat16)
    w = quantize_q4_0(_randn(rng, (k, n), dev, scale=k ** -0.5), axis=0)
    want = q4_plain.q4_matmul(x, w.q, w.scale, torch.float32)
    ran = 0
    for warps in (1, 2, 4, 8):
        if not q4_ops.gemv_fits(k, cgw, warps, ranks):
            continue
        monkeypatch.setattr(q4_ops, "plan", lambda *a, p=(
            layout, cgw, warps, ranks): p)
        got = q4_ops.q4_matmul(x, w, out_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        ran += 1
    assert ran == 4


def _planes(tier, rng, shape, dev, v=None):
    """Code and scale planes of the ``tier`` cache for random (or the
    given) values of ``shape``, blocked along head_dim."""
    x = _randn(rng, shape, dev) if v is None else v
    t = (quantize_q8_0 if tier == "q8_0" else quantize_q4_0)(x, axis=-1)
    return t.q, t.scale


_OPS = {"q8_0": (qa_ops.q8_decode_attention, qa_plain.q8_decode_attention,
                 qa_ops.q8_decode_attention_cache,
                 qa_plain.q8_decode_attention_cache),
        "q4_0": (q4a_ops.q4_decode_attention, q4a_plain.q4_decode_attention,
                 q4a_ops.q4_decode_attention_cache,
                 q4a_plain.q4_decode_attention_cache)}


@pytest.mark.parametrize("bh,s,d", [(24, 1500, 64), (6, 35, 64),
                                    (8, 40, 32)])
def test_q4_decode_attention_kernel(dev, bh, s, d):
    rng = np.random.default_rng(bh + s + 1)
    q = _randn(rng, (bh, 1, d), dev, torch.bfloat16)
    kp, ks = _planes("q4_0", rng, (bh, s, d), dev)
    vp, vs = _planes("q4_0", rng, (bh, s, d), dev)
    lens = torch.from_numpy(rng.integers(1, s + 1, bh)).to(dev)
    lens[0], lens[-1] = s, 0
    before = q4a_ops.q4_decode_attention.launches
    got = q4a_ops.q4_decode_attention(q, kp, ks, vp, vs, lens)
    torch.cuda.synchronize()
    assert q4a_ops.q4_decode_attention.launches == before + 1
    want = q4a_plain.q4_decode_attention(q, kp, ks, vp, vs, lens)
    assert_bf16_close(got, want)
    assert float(got[-1].abs().max()) == 0.0


@pytest.mark.parametrize("tier", ["q8_0", "q4_0"])
@pytest.mark.parametrize("nq", [1, 4])
@pytest.mark.parametrize("bh,s,d", [(24, 1500, 64), (6, 35, 64)])
def test_decode_attention_kernel_reads_exactly_to_length(dev, tier, nq, bh,
                                                         s, d):
    # V only on the 3 positions before each query's length and a large V
    # past it: reading short drops the output, reading long poisons it
    rng = np.random.default_rng(bh * s + nq)
    q = _randn(rng, (bh, nq, d), dev, torch.bfloat16)
    kc, ks = _planes(tier, rng, (bh, s, d), dev)
    lens = torch.from_numpy(rng.integers(3, s - nq + 2, bh)).to(dev)
    lens = lens[:, None] + torch.arange(nq, device=dev)[None, :]
    v = _randn(rng, (bh, s, d), dev)
    n = lens[:, :1, None]      # the first query's length
    pos = torch.arange(s, device=dev)[None, :, None]
    v = torch.where(pos >= n, 8.0 * v, torch.where(pos >= n - 3, v, 0.0))
    vc, vs = _planes(tier, rng, None, dev, v=v)
    kern, plain = _OPS[tier][:2]
    got = kern(q, kc, ks, vc, vs, lens)
    torch.cuda.synchronize()
    want = plain(q, kc, ks, vc, vs, lens)
    assert_bf16_close(got, want)


@pytest.mark.parametrize("tier", ["q8_0", "q4_0"])
@pytest.mark.parametrize("L,b,nq,s,h,hkv,d,layer", [
    (4, 4, 4, 64, 6, 6, 64, 2),       # self verify: 4 lanes x 4 queries
    (4, 4, 4, 1500, 6, 6, 64, 1),     # cross verify, (B,) lengths
    (4, 4, 1, 1500, 6, 6, 64, 3),     # cross decode
    (2, 3, 3, 40, 4, 2, 32, 1)])      # reduced GQA
def test_decode_attention_cache_kernel_multi_query(dev, tier, L, b, nq, s,
                                                   h, hkv, d, layer):
    rng = np.random.default_rng(L * b * s + nq)
    q = _randn(rng, (b, nq, h, d), dev, torch.bfloat16)
    kc, ks = _planes(tier, rng, (L, b, s, hkv, d), dev)
    vc, vs = _planes(tier, rng, (L, b, s, hkv, d), dev)
    first = torch.from_numpy(rng.integers(1, s - nq + 2, b)).to(dev)
    if s == 1500:   # cross: one length a lane for every query
        lens = torch.tensor([1500, 1000, 500, 1250][:b], device=dev)
    else:           # self: token j attends [0, pos + j]
        lens = first[:, None] + torch.arange(nq, device=dev)[None, :]
    kern, plain = _OPS[tier][2:]
    got = kern(q, kc, ks, vc, vs, lens, layer)
    torch.cuda.synchronize()
    want = plain(q, kc, ks, vc, vs, lens, layer)
    assert_bf16_close(got, want)


def _chunked_case(tier, rng, dev, L, b, nq, s, h, hkv, d, lens):
    """Cache planes of ``tier`` with V only on the 3 positions before
    each lane's first length and a large V past it, and the kernel's and
    the plain version's outputs on layer L - 1."""
    q = _randn(rng, (b, nq, h, d), dev, torch.bfloat16)
    kc, ks = _planes(tier, rng, (L, b, s, hkv, d), dev)
    v = _randn(rng, (L, b, s, hkv, d), dev)
    n = lens if lens.dim() == 1 else lens[:, 0]
    pos = torch.arange(s, device=dev)[None, None, :, None, None]
    n = n[None, :, None, None, None]
    v = torch.where(pos >= n, 8.0 * v, torch.where(pos >= n - 3, v, 0.0))
    vc, vs = _planes(tier, rng, None, dev, v=v)
    kern, plain = _OPS[tier][2:]
    got = kern(q, kc, ks, vc, vs, lens, L - 1)
    torch.cuda.synchronize()
    return got, plain(q, kc, ks, vc, vs, lens, L - 1)


@pytest.mark.parametrize("tier", ["q8_0", "q4_0"])
@pytest.mark.parametrize("b,at", [(1, [10, 0]), (1, [10, 1]), (1, [0, 1]),
                                  (4, [2, 0]), (4, [2, 1])])
def test_decode_attention_kernel_at_chunk_boundaries(dev, tier, b, at):
    """S = 1500 split across CTAs as the wrapper plans it (decode.
    chunk_plan): a length on a chunk's end, one a position past it, a
    length of 1, and beside them a lane of length 0, which returns 0."""
    from repro_torch.kernels import build, decode
    chunk, nch = decode.chunk_plan(b, 6, 1, 1500, build.sm_count(dev))
    assert nch > 1
    first = at[0] * chunk + at[1]
    lens = torch.tensor([first, 0, 1500, 2 * chunk][:b] if b > 1 else
                        [first], device=dev)
    got, want = _chunked_case(tier, np.random.default_rng(first + b), dev,
                              2, b, 1, 1500, 6, 6, 64, lens)
    assert_bf16_close(got, want)
    if b > 1:
        assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("tier", ["q8_0", "q4_0"])
@pytest.mark.parametrize("L,b,nq,s,h,hkv,d", [
    (2, 2, 4, 1500, 6, 6, 64),     # the verify's (B, Q) lengths, chunked
    (2, 2, 3, 1500, 4, 2, 32),     # GQA (4 heads over 2), D = 32
    (1, 1, 1, 65536, 6, 6, 64),    # S beyond one block's shared memory
    (1, 1, 4, 65536, 6, 6, 64)])
def test_decode_attention_kernel_split_s(dev, tier, L, b, nq, s, h, hkv, d):
    rng = np.random.default_rng(s + nq + d)
    first = torch.from_numpy(rng.integers(s // 2, s - nq + 2, b)).to(dev)
    lens = first[:, None] + torch.arange(nq, device=dev)[None, :]
    got, want = _chunked_case(tier, rng, dev, L, b, nq, s, h, hkv, d, lens)
    assert_bf16_close(got, want)


def test_q4_kernels_refuse_what_they_do_not_take(dev):
    w = Q4Tensor(torch.zeros((32, 8), dtype=torch.uint8, device=dev),
                 torch.zeros((2, 8), dtype=torch.float16, device=dev))
    with pytest.raises(ValueError):
        q4_ops.q4_matmul(torch.zeros((4, 32), device=dev), w)
    with pytest.raises(TypeError):
        q4_ops.q4_matmul(torch.zeros((4, 64), device=dev),
                         Q4Tensor(w.q.to(torch.int8), w.scale))
    kp = torch.zeros((2, 8, 32), dtype=torch.uint8, device=dev)
    ks = torch.zeros((2, 8, 2), dtype=torch.float16, device=dev)
    q = torch.zeros((2, 3, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):   # (B, Q) lengths of the wrong shape
        q4a_ops.q4_decode_attention(q, kp, ks, kp, ks,
                                    torch.ones((2, 2), device=dev))
    with pytest.raises(TypeError):
        q4a_ops.q4_decode_attention(q, kp.to(torch.int8), ks,
                                    kp.to(torch.int8), ks, 8)


# ----------------------------------------------------------------------------
# slstm_scan (xlstm-350m's sLSTM recurrence)
# ----------------------------------------------------------------------------

def _slstm_inputs(rng, dev, s, b, h, hd, init):
    wx = _randn(rng, (s, 4, b, h, hd), dev)
    r = _randn(rng, (4, h, hd, hd), dev, scale=hd ** -0.5)
    if init:
        st = torch.zeros((4, b, h, hd), device=dev)
        st[3] = -1e30
    else:   # a lane's pool state: c, n > 0, h, a finite m
        st = torch.stack([_randn(rng, (b, h, hd), dev),
                          _randn(rng, (b, h, hd), dev).abs() + 0.5,
                          _randn(rng, (b, h, hd), dev, scale=0.5),
                          _randn(rng, (b, h, hd), dev)])
    return wx, r, st


def assert_f32_close(got, want):
    """f32 summation order only: 1e-5 of the largest output."""
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("s,b,h,hd,init", [
    (256, 1, 4, 256, True), (77, 1, 4, 256, True), (1, 4, 4, 256, False),
    (13, 2, 2, 32, False), (5, 3, 4, 100, False), (1, 1, 1, 1, False)])
def test_slstm_scan_kernel(dev, s, b, h, hd, init):
    """Prefill from the initial state, decode from a non-initial one,
    and ragged head widths (hd not a multiple of 32): hs and every leaf
    of the final state against the plain version."""
    wx, r, st = _slstm_inputs(np.random.default_rng(s + hd), dev, s, b, h,
                              hd, init)
    n0 = sl_ops.slstm_scan.launches
    hk, sk = sl_ops.slstm_scan(wx, r, st)
    torch.cuda.synchronize()
    assert sl_ops.slstm_scan.launches == n0 + 1
    hp, sp = sl_plain.slstm_scan(wx, r, st)
    assert hk.shape == hp.shape and sk.shape == sp.shape
    assert_f32_close(hk, hp)
    for leaf in range(4):
        assert_f32_close(sk[leaf], sp[leaf])


# outputs of a run that may differ from the plain version bit for bit:
# the f64 dot's order is the kernel's own, and a sum within ~2^-45 of an
# f32 rounding boundary (a tie) may round the other way. One tie at the
# last step moves at most the 5 outputs of its (lane, column): hs, c, n,
# h, m; no more than one is expected in these runs.
SLSTM_TIES = 5


def _differing(got, want) -> int:
    return sum(int((g != w).sum()) for g, w in zip(got, want))


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("s,b,init", [(256, 1, True), (1, 4, False),
                                      (9, 3, False)])
def test_slstm_scan_kernel_bit_equal_to_plain(dev, monkeypatch, cluster, s,
                                              b, init):
    """The cluster layout at xlstm-350m's width (4 heads of 256) against
    the plain version bit for bit, but for SLSTM_TIES: prefill of the
    longest prompt on one lane, a decode step of 4 lanes, and 3 lanes (a
    group with a lane past B)."""
    wx, r, st = _slstm_inputs(np.random.default_rng(s + b), dev, s, b, 4,
                              256, init)
    monkeypatch.setattr(sl_ops, "plan", lambda *a: (sl_ops.CLUSTER,
                                                    cluster))
    got = sl_ops.slstm_scan(wx, r, st)
    torch.cuda.synchronize()
    want = sl_plain.slstm_scan(wx, r, st)
    assert _differing(got, want) <= SLSTM_TIES


@pytest.mark.parametrize("s,b,hd", [(256, 1, 256), (1, 4, 256),
                                    (13, 2, 32), (5, 3, 100)])
def test_slstm_scan_kernel_takes_a_bf16_r(dev, s, b, hd):
    """R in bf16 as the model stores it: exactly the result of the same
    values widened to f32 (both layouts), and the plain version's."""
    wx, r, st = _slstm_inputs(np.random.default_rng(hd + s), dev, s, b, 4,
                              hd, False)
    rb = r.to(torch.bfloat16)
    got = sl_ops.slstm_scan(wx, rb, st)
    same = sl_ops.slstm_scan(wx, rb.float(), st)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, same))
    want = sl_plain.slstm_scan(wx, rb, st)
    assert_f32_close(got[0], want[0])
    assert_f32_close(got[1], want[1])


def test_slstm_scan_kernel_saturated_gates(dev):
    """i >> 0 with f << 0 on lane 0 and the reverse on lane 1: finite,
    and the plain version's answer."""
    wx, r, st = _slstm_inputs(np.random.default_rng(5), dev, 64, 2, 4, 256,
                              False)
    wx[:, 0, 0] += 60.0
    wx[:, 1, 0] -= 60.0
    wx[:, 0, 1] -= 60.0
    wx[:, 1, 1] += 60.0
    hk, sk = sl_ops.slstm_scan(wx, r, st)
    hp, sp = sl_plain.slstm_scan(wx, r, st)
    assert torch.isfinite(hk).all() and torch.isfinite(sk).all()
    assert_f32_close(hk, hp)
    for leaf in range(4):
        assert_f32_close(sk[leaf], sp[leaf])


def test_slstm_scan_kernel_continues_from_its_state(dev):
    """Two launches, the second from the first's final state, equal one
    launch over both halves: decode resumes where prefill stopped."""
    wx, r, st = _slstm_inputs(np.random.default_rng(8), dev, 40, 2, 4, 256,
                              True)
    h_all, s_all = sl_ops.slstm_scan(wx, r, st)
    h1, s1 = sl_ops.slstm_scan(wx[:25].contiguous(), r, st)
    h2, s2 = sl_ops.slstm_scan(wx[25:].contiguous(), r, s1)
    assert_f32_close(torch.cat([h1, h2]), h_all)
    assert_f32_close(s2, s_all)


def test_slstm_scan_kernel_refuses_what_it_does_not_take(dev):
    wx, r, st = _slstm_inputs(np.random.default_rng(0), dev, 3, 1, 1, 512,
                              True)
    with pytest.raises(ValueError, match="256"):
        sl_ops.slstm_scan(wx, r, st)
    wx, r, st = _slstm_inputs(np.random.default_rng(0), dev, 3, 1, 2, 32,
                              True)
    with pytest.raises(TypeError):
        sl_ops.slstm_scan(wx.half(), r, st)
    with pytest.raises(ValueError):
        sl_ops.slstm_scan(wx, r.cpu(), st)


@pytest.mark.parametrize("m", [4, 77, 256])
def test_fp16_matmul_kernel_at_the_xlstm_head(dev, m):
    """xlstm-350m's untied head in f32: (m, 1024) @ (1024, 51200), at
    a decode step of 4 lanes and at prefill of a ragged 77-id prompt
    and of the longest prompt of chip_smoke.py's xLSTM phase."""
    rng = np.random.default_rng(11)
    x = _randn(rng, (m, 1024), dev)
    w = _randn(rng, (1024, 51200), dev, scale=1024 ** -0.5)
    assert_f32_close(mm_ops.fp16_matmul(x, w), mm_plain.fp16_matmul(x, w))


# ----------------------------------------------------------------------------
# The decode tick captured in a CUDA graph, against the eager tick
# ----------------------------------------------------------------------------

def _tick_syncs(eng, k) -> list:
    """Run one tick of ``k`` steps; where it made a synchronising CUDA
    call (``torch.cuda``'s sync debug mode), one (file, line) each."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step(k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [(w.filename, w.lineno) for w in seen
            if "synchroniz" in str(w.message)]


def _serve_ticks(model, params, reqs, ks, cuda_graph, **kw):
    """Admit ``reqs`` and tick until they finish, the ticks' sizes taken
    in turn from ``ks``. Returns (outputs and logits rows by request,
    the engine, synchronising calls a tick, the launches and routing
    counters the ticks added)."""
    eng = ServeEngine(model, params, n_slots=len(reqs), keep_logits=True,
                      cuda_graph=cuda_graph, device="cuda", **kw)
    sts = [eng.admit(r) for r in reqs]
    launches0, counters0 = api.launch_counts(), api.dispatch_counters()
    syncs = []
    while eng.n_active:
        syncs.append(_tick_syncs(eng, ks[len(syncs) % len(ks)]))
    torch.cuda.synchronize()
    launches = {k: n - launches0[k] for k, n in api.launch_counts().items()}
    counters = api.dispatch_counters() - counters0
    return ([(st.out, st.logits) for st in sts], eng, syncs, launches,
            counters)


def _whisper_case(cache, spec_k):
    model = build(reduced(get_config("whisper-tiny-en")))
    params = model.init_values(torch.Generator().manual_seed(0),
                               device="cuda")
    if cache == "q8_0" and not spec_k:
        params = quantize_tree(params)
    rng = np.random.default_rng(1)
    reqs = [AudioRequest(uid=i, tokens=[1, 3 + i], max_new=n, eos_id=-1,
                         enc_frames=rng.standard_normal((12 + 4 * i, 128))
                         .astype(np.float32) * 0.5)
            for i, n in enumerate((40, 23))]
    return model, params, reqs, dict(max_len=64, enc_len=16,
                                     cache_dtype=cache, spec_k=spec_k,
                                     decode_block=4)


def _xlstm_case():
    model = build(reduced(get_config("xlstm-350m")))
    params = model.init_values(torch.Generator().manual_seed(0),
                               device="cuda")
    params = _cast_tree(params, torch.bfloat16)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, tokens=rng.integers(3, 500, size=n).tolist(),
                    max_new=m, eos_id=-1)
            for i, (n, m) in enumerate(((9, 40), (17, 23)))]
    return model, params, reqs, dict(max_len=64)


def _decoder_case(arch, cache):
    model = build(reduced(get_config(arch)))
    params = model.init_values(torch.Generator(device="cuda").manual_seed(0),
                               device="cuda", dtype=torch.bfloat16)
    if cache == "q8_0":
        params = model.quantize(params)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, tokens=rng.integers(3, 500, size=n).tolist(),
                    max_new=m, eos_id=-1)
            for i, (n, m) in enumerate(((9, 40), (17, 23)))]
    return model, params, reqs, dict(max_len=64, cache_dtype=cache)


def _hybrid_case():
    """The reduced zamba2-7b at 15 layers (2 segments and a tail of 3
    mamba blocks), bf16 weights drawn on the card."""
    import dataclasses
    model = build(dataclasses.replace(reduced(get_config("zamba2-7b")),
                                      n_layers=15))
    params = model.init_values(torch.Generator(device="cuda").manual_seed(0),
                               device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, tokens=rng.integers(3, 500, size=n).tolist(),
                    max_new=m, eos_id=-1)
            for i, (n, m) in enumerate(((9, 40), (17, 23)))]
    return model, params, reqs, dict(max_len=64)


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


@pytest.mark.parametrize("case", ["bf16", "q8_0", "q4_0", "spec_k=4",
                                  "xlstm", "qwen3-4b", "qwen3-4b|q8_0",
                                  "qwen3-moe-30b-a3b", "gemma2-2b",
                                  "zamba2-7b"])
def test_captured_tick_equals_the_eager_tick(dev, case):
    """Ticks of 4 and 8 steps in turn, captured and eager: the same
    tokens and the same logits rows bit for bit, one capture per tick
    size, one synchronising CUDA call a tick, and the same launches and
    routing counted per tick (the replays' recorded ones). A first run
    of the case, not held, leaves the process's one-time set-up (the
    library handles' first use) outside the runs compared."""
    if case == "xlstm":
        model, params, reqs, kw = _xlstm_case()
    elif case == "zamba2-7b":
        model, params, reqs, kw = _hybrid_case()
    elif case.partition("|")[0] in ("qwen3-4b", "qwen3-moe-30b-a3b",
                                     "gemma2-2b"):
        arch, _, cache = case.partition("|")
        model, params, reqs, kw = _decoder_case(arch, cache or "bf16")
    else:
        cache = "q4_0" if case == "q4_0" else \
            "q8_0" if case in ("q8_0", "spec_k=4") else "bf16"
        model, params, reqs, kw = _whisper_case(
            cache, 4 if case == "spec_k=4" else 0)
    _serve_ticks(model, params, reqs[:1], (4,), False, **kw)
    runs = {g: _serve_ticks(model, params, reqs, (4, 8), g, **kw)
            for g in (False, True)}
    (got, eng, syncs, launches, counters) = runs[True]
    (want, eager, eager_syncs, eager_launches, eager_counters) = runs[False]
    for i, ((gt, gl), (wt, wl)) in enumerate(zip(got, want)):
        assert gt == wt, (i, gt, wt)
        assert len(gl) == len(wl) == len(gt)
        for j, (g, w) in enumerate(zip(gl, wl)):
            assert torch.equal(g, w), (
                i, j, float((g - w).abs().max()), float(w.abs().max()))
    assert eng.captures == 2 and eager.captures == 0
    assert eng.replays == len(syncs) - 2 >= 2
    assert all(len(n) == 1 for n in syncs), syncs
    assert all(len(n) == 1 for n in eager_syncs), eager_syncs
    assert launches == eager_launches and counters == eager_counters
    assert all(key[1:] == ("accel", "cuda") for key in counters)


def test_capture_with_a_dead_captured_engine_awaiting_collection(dev):
    """A captured engine that dies in a reference cycle waits for the
    cyclic collector, which frees its graphs whenever it runs; freeing
    them inside the next engine's capture would invalidate that capture.
    The collector runs at nearly every allocation here, and the capture
    must hold it off."""
    model, params, reqs, kw = _whisper_case("bf16", 0)

    def captured_engine():
        eng = ServeEngine(model, params, n_slots=2, cuda_graph=True,
                          device="cuda", **kw)
        eng.admit(reqs[0])
        for _ in range(3):
            eng.step(4)
        return eng

    dead = captured_engine()
    assert dead.captures == 1
    dead.cycle = dead
    del dead
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        eng = captured_engine()
    finally:
        gc.set_threshold(*thresholds)
    assert eng.captures == 1 and eng.replays == 2


def test_step_fetch_from_an_executor_thread_returns_the_finished_tick(dev):
    """The gateway fetches a tick in an executor thread, whose current
    stream is not the one the tick was issued on. Each tick here is
    issued on a side stream behind a ~20 ms busy wait; the fetch from a
    worker thread must still return that tick's tokens, equal to an
    engine that ticks on the main thread."""
    from concurrent.futures import ThreadPoolExecutor
    model, params, reqs, kw = _whisper_case("bf16", 0)
    want, *_ = _serve_ticks(model, params, reqs, (4,), True, **kw)
    eng = ServeEngine(model, params, n_slots=len(reqs), keep_logits=True,
                      device="cuda", **kw)
    sts = [eng.admit(r) for r in reqs]
    side = torch.cuda.Stream()
    with ThreadPoolExecutor(1) as pool:
        while eng.n_active:
            # after what the main stream wrote (admission, freed lanes)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                torch.cuda._sleep(40_000_000)
                pending = eng.step_begin(4)
            tok_blk, emit_blk = pool.submit(eng.step_fetch, pending).result()
            eng.step_replay(pending, tok_blk, emit_blk)
    assert eng.captures == 1 and eng.replays >= 2
    assert [st.out for st in sts] == [w[0] for w in want]
    for st, (_, wl) in zip(sts, want):
        assert all(torch.equal(g, w) for g, w in zip(st.logits, wl))


# ----------------------------------------------------------------------------
# Streaming: the frontend's rows, and a streamed engine's captured ticks
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(3000, 201, 80), (1500, 80, 384)])
def test_frontend_product_rows_do_not_depend_on_m(dev, m, k, n):
    """The frontend's f32 x f32 products give a row the same bits in a
    call of 1-17 rows as in the full product (the FMA loop at every M)."""
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.random((m, k)).astype(np.float32)).to(dev)
    w = _randn(rng, (k, n), dev)
    full = mm_ops.fp16_matmul(x, w)
    for rows in (1, 5, 10, 16, 17):
        for at in (0, 7, m - rows):
            part = mm_ops.fp16_matmul(x[at:at + rows].contiguous(), w)
            assert torch.equal(part, full[at:at + rows]), (rows, at)


@pytest.mark.parametrize("step", [1600, 173])
def test_streaming_frontend_bit_exact(dev, step):
    """Pushes of 100 ms packets and of 173 samples, then ``flush``,
    equal the one-shot ``audio_frames`` on the card bit for bit."""
    x = synth_waveform(3.0)
    one = audio_frames(x, 384, device=dev)
    sf = StreamingFrontend(384, device=dev)
    outs = [sf.push(x[i:i + step]) for i in range(0, len(x), step)]
    got = torch.cat(outs + [sf.flush()])
    assert got.shape == one.shape == (150, 384)
    assert torch.equal(got, one)


def _watch_ticks(eng) -> list:
    """Wrap ``eng.step``: for each tick with an active lane, where it made
    a synchronising CUDA call."""
    syncs, step = [], eng.step

    def watched(k=None):
        if not eng.n_active:
            return step(k)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return step(k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                syncs.append([(w.filename, w.lineno) for w in seen
                              if "synchroniz" in str(w.message)])

    eng.step = watched
    return syncs


def _stream_serve(model, params, cuda_graph):
    """A stream of 5 chunks beside a one-shot request through the
    scheduler: the stream's cross K/V grows between replayed ticks in
    which the other lane decodes."""
    eng = ServeEngine(model, params, n_slots=2, max_len=64, enc_len=40,
                      cache_dtype="q8_0", decode_block=4, keep_logits=True,
                      cuda_graph=cuda_graph, device="cuda")
    syncs = _watch_ticks(eng)
    sched = BatchScheduler(eng)
    rng = np.random.default_rng(2)
    chunks = [rng.standard_normal((n, 128)).astype(np.float32) * 0.5
              for n in (8, 8, 8, 8, 5)]
    frames = rng.standard_normal((20, 128)).astype(np.float32) * 0.5
    sched.submit(StreamingAudioRequest(uid=0, tokens=[1, 3], max_new=12,
                                       eos_id=-1, chunks=chunks))
    sched.submit(AudioRequest(uid=1, tokens=[1, 4], max_new=30, eos_id=-1,
                              enc_frames=frames))
    sched.run_until_drained(max_ticks=100)
    torch.cuda.synchronize()
    assert sched.drained and eng.n_streams == 0 and eng.lanestate.drained
    return sched.results, eng, syncs


def test_captured_stream_equals_the_eager_stream(dev):
    """Streamed and one-shot lanes ticked from a CUDA graph while the
    stream extends its cross planes and encoder length in place: the
    eager run's tokens, partial hypotheses and logits rows bit for bit,
    one capture, one synchronising call a tick."""
    model = build(reduced(get_config("whisper-tiny-en")))
    params = quantize_tree(model.init_values(
        torch.Generator().manual_seed(0), device="cuda"))
    _stream_serve(model, params, False)
    (got, eng, syncs), (want, eager, eager_syncs) = (
        _stream_serve(model, params, g) for g in (True, False))
    for uid in (0, 1):
        assert got[uid].out == want[uid].out, uid
        assert got[uid].partials == want[uid].partials, uid
        assert len(got[uid].logits) == len(got[uid].out)
        for g, w in zip(got[uid].logits, want[uid].logits):
            assert torch.equal(g, w), uid
    assert len(got[0].partials) == 6 and len(got[0].out) == 12
    assert eng.captures == 1 and eager.captures == 0
    assert eng.replays == len(syncs) - 1 >= 4
    assert all(len(n) == 1 for n in syncs + eager_syncs), syncs


# ----------------------------------------------------------------------------
# Paged KV: the op's CUDA route, and the paged engine's captured ticks
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("nq", [1, 4])
def test_paged_decode_attention_on_the_card(dev, tier, nq):
    """The CUDA route (page gather, then the tier's decode-attention
    kernel) against the plain version on the same pool, at whisper's 6
    heads of 64 over 2 KV heads, 188 logical pages of 8 (1504 positions,
    the cross block of phase g), shared and scratch pages in the rows;
    a quantized tier launches its kernel once a call."""
    rng = np.random.default_rng(5)
    b, h, hkv, d, n_lp, n_pages = 4, 6, 2, 64, 188, 600
    pool = [_randn(rng, (n_pages, 8, hkv, d), dev, torch.bfloat16)
            for _ in range(2)]
    if tier != "bf16":
        qz = quantize_q8_0 if tier == "q8_0" else quantize_q4_0
        key = "q" if tier == "q8_0" else "p"
        pool = [{key: t.q, "s": t.scale}
                for t in (qz(x, axis=-1) for x in pool)]
    table = torch.from_numpy(rng.integers(1, n_pages, (b, n_lp))).to(dev)
    table[1, :40] = table[0, :40]          # a shared prefix
    table[3, 100:] = 0                      # the scratch page past a lane
    q = _randn(rng, (b, nq, h, d), dev, torch.bfloat16)
    lens = torch.tensor([1504, 700, 1, 800], device=dev)
    if nq > 1:
        lens = lens[:, None] - torch.arange(nq - 1, -1, -1, device=dev)
        lens = lens.clamp(min=1)
    launcher = {"q8_0": qa_ops.q8_decode_attention,
                "q4_0": q4a_ops.q4_decode_attention}.get(tier)
    before = launcher.launches if launcher else 0
    got = pa_ops.paged_decode_attention(q, *pool, table, lens)
    want = pa_plain.paged_decode_attention(q, *pool, table, lens)
    torch.cuda.synchronize()
    assert got.shape == (b, nq, h, d)
    assert_bf16_close(got, want)
    if launcher:
        assert launcher.launches == before + 1


def _paged_serve(model, params, paged, cuda_graph, cache="q8_0"):
    """A stream of 5 chunks of 8 frames, and three one-shot requests, two
    with the same audio and full prompt page, on 3 slots through the
    scheduler, one admission a tick: the page tables' rows change between
    replayed ticks (each admission, the stream's cross pages, each freed
    lane)."""
    eng = ServeEngine(model, params, n_slots=3, max_len=64, enc_len=40,
                      cache_dtype=cache, decode_block=4, keep_logits=True,
                      cuda_graph=cuda_graph, device="cuda", paged=paged,
                      page_size=8)
    syncs = _watch_ticks(eng)
    sched = BatchScheduler(eng, max_admit_per_tick=1)
    rng = np.random.default_rng(3)
    chunks = [rng.standard_normal((8, 128)).astype(np.float32) * 0.5
              for _ in range(5)]
    frames = rng.standard_normal((20, 128)).astype(np.float32) * 0.5
    other = rng.standard_normal((13, 128)).astype(np.float32) * 0.5
    prompt = list(range(1, 10))
    sched.submit(AudioRequest(uid=0, tokens=prompt, max_new=20, eos_id=-1,
                              enc_frames=frames))
    sched.submit(StreamingAudioRequest(uid=1, tokens=[1, 3], max_new=12,
                                       eos_id=-1, chunks=chunks))
    sched.submit(AudioRequest(uid=2, tokens=prompt, max_new=24, eos_id=-1,
                              enc_frames=frames))
    sched.submit(AudioRequest(uid=3, tokens=[1, 4], max_new=30, eos_id=-1,
                              enc_frames=other))
    sched.run_until_drained(max_ticks=100)
    torch.cuda.synchronize()
    assert sched.drained and eng.lanestate.drained
    return sched.results, eng, syncs


def test_captured_paged_tick_equals_the_eager_tick(dev):
    """The paged engine ticked from a CUDA graph while admissions, a
    stream and freed lanes rewrite its page tables in place between
    replays: the eager run's tokens, partial hypotheses and logits rows
    bit for bit, and the slot pool's of the same lengths; one capture,
    one synchronising call a tick, the tables never rebound, prefix
    pages shared, both pools drained."""
    model = build(reduced(get_config("whisper-tiny-en")))
    params = quantize_tree(model.init_values(
        torch.Generator().manual_seed(0), device="cuda"))
    _paged_serve(model, params, True, False)
    runs = {(p, g): _paged_serve(model, params, p, g)
            for p, g in ((True, True), (True, False), (False, True))}
    got, eng, syncs = runs[True, True]
    tables = eng.page_tables
    for key in ((True, False), (False, True)):
        want = runs[key][0]
        for uid in range(4):
            assert got[uid].out == want[uid].out, (key, uid)
            assert got[uid].partials == want[uid].partials, (key, uid)
            assert len(got[uid].logits) == len(got[uid].out)
            for g, w in zip(got[uid].logits, want[uid].logits):
                assert torch.equal(g, w), (key, uid)
    assert eng.captures == 1 and eng.replays == len(syncs) - 1 >= 4
    assert all(len(n) == 1 for n in syncs + runs[True, False][2]), syncs
    assert eng.pages.self_table.device() is tables["self"]
    assert eng.pages.cross_table.device() is tables["cross"]
    assert eng.paging_report()["prefix"]["self"]["hits"] >= 1
    assert eng.pages.self_pool.used_pages == 0
    assert eng.pages.cross_pool.used_pages == 0
    eng.pages.check()


def test_captured_paged_bf16_tick_equals_the_slot_pool(dev):
    """The bf16 pool, whose decode attention multiplies the bf16 planes
    into f32 results (``attend_bf16_planes``): the paged engine's
    captured ticks equal its eager ticks and the slot pool's bit for
    bit."""
    model = build(reduced(get_config("whisper-tiny-en")))
    params = model.init_values(torch.Generator().manual_seed(0),
                               device="cuda")
    runs = {(p, g): _paged_serve(model, params, p, g, "bf16")
            for p, g in ((True, True), (True, False), (False, True))}
    got = runs[True, True][0]
    for key in ((True, False), (False, True)):
        want = runs[key][0]
        for uid in range(4):
            assert got[uid].out == want[uid].out, (key, uid)
            for g, w in zip(got[uid].logits, want[uid].logits):
                assert torch.equal(g, w), (key, uid)


# ----------------------------------------------------------------------------
# The bf16 decode attention on the card, and the static checks
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("b,nq,h,hkv,d,s,softcap", [
    (4, 1, 6, 6, 64, 1504, None),      # whisper-tiny.en cross, 4 lanes
    (4, 4, 6, 6, 64, 64, None),        # the speculative verify
    (4, 1, 32, 32, 112, 300, None),    # zamba2-7b's shared block
    (4, 1, 32, 8, 128, 512, None),     # qwen3-4b, GQA 4
    (4, 1, 8, 4, 256, 512, 50.0),      # gemma2-2b with softcap
    (2, 1, 8, 4, 256, 37, 30.0)])
def test_bf16_decode_attention_streams_the_bf16_planes(dev, b, nq, h, hkv, d,
                                                       s, softcap):
    """The card's formulation (bf16 operands into f32 results, query
    heads grouped per KV head) against the widened one, masked per lane:
    each product within 1e-5 of its largest value (only the f32
    summation order differs), the attention within one bf16 rounding of
    the largest output (both round the probabilities to bf16, and a
    summation-order difference can move one across a rounding boundary:
    3.4e-5 of the largest output measured at qwen3-4b's shape). It makes
    no f32 tensor of a K/V plane's size."""
    from repro_torch.staticcheck.trace import trace_call
    rng = np.random.default_rng(11)
    q = _randn(rng, (b, nq, h, d), dev)
    k = _randn(rng, (b, s, hkv, d), dev, torch.bfloat16)
    v = _randn(rng, (b, s, hkv, d), dev, torch.bfloat16)
    lens = torch.from_numpy(rng.integers(1, s + 1, (b,))).to(dev)
    mask = torch.arange(s, device=dev)[None, None, :] < lens[:, None, None]
    got, nodes = trace_call(pa_plain.bf16_decode_attention, q, k, v,
                            mask.expand(b, nq, s), softcap)
    want = pa_plain.attend_widened(q, k, v, mask.expand(b, nq, s), softcap)
    g = h // hkv
    qg = q.to(torch.bfloat16).reshape(b, nq, hkv, g, d) \
        .permute(0, 2, 3, 1, 4).reshape(b * hkv, g * nq, d)
    kt = k.permute(0, 2, 3, 1).reshape(b * hkv, d, s)
    vg = v.permute(0, 2, 1, 3).reshape(b * hkv, s, d)
    w = torch.softmax(_randn(rng, (b * hkv, g * nq, s), dev), -1) \
        .to(torch.bfloat16)
    for x, y in ((qg, kt), (w, vg)):
        prod = torch.bmm(x, y, out_dtype=torch.float32)
        wide = torch.bmm(x.float(), y.float())
        err = float((prod - wide).abs().max())
        assert err <= 1e-5 * float(wide.abs().max()), err
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, nq, h, d)
    assert_bf16_close(got, want)
    plane = b * s * hkv * d
    assert not [n.op for n in nodes for t in n.outputs
                if t.dtype == "float32" and t.numel >= plane]


def test_staticcheck_on_the_card(dev):
    """SC-SYNC, SC-DON and SC-RECOMP on a reduced whisper q8_0 engine and
    a paged one: every traced program free of a synchronising CUDA call,
    its buffers updated in place, one capture per tick size and no
    recapture after an admission."""
    from repro_torch.staticcheck.config import StaticcheckConfig
    from repro_torch.staticcheck.harness import build_engine
    from repro_torch.staticcheck.report import Report
    from repro_torch.staticcheck.run import apply_waivers, check_engines
    only = {"SC-SYNC", "SC-DON", "SC-RECOMP"}
    findings = check_engines([build_engine("q8_0", device="cuda")],
                             [build_engine("q8_0", device="cuda",
                                           paged=True)], only=only)
    rep = Report(apply_waivers(findings, StaticcheckConfig.load(), "cuda"))
    assert rep.ok and all(f.ok for f in rep.findings), rep.human()
    assert {f.check for f in rep.findings} == only
    recomp = [f for f in rep.findings if f.check == "SC-RECOMP"]
    assert len(recomp) == 4
    assert all(f.data["after_admission"] == [1, 2, 1]
               for f in recomp if "decode_block" in f.subject)


@pytest.mark.parametrize("arch", ["whisper-tiny-en", "qwen3-4b",
                                  "qwen3-moe-30b-a3b", "zamba2-7b"])
def test_train_step_on_the_card_launches_no_kernel(dev, arch):
    """A reduced train step on CUDA tensors runs the grad-safe torch
    bindings (no kernel launch, every dispatch ``(op, accel|host,
    "torch")``) and matches the same step on the CPU: the loss within a
    bf16 rounding, the gradient norm within 1e-2 and every parameter
    within 2 * lr (Adam's first step moves an element +-lr, so a
    near-zero gradient of another sign moves it 2 * lr apart)."""
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.optim.adamw import AdamWConfig, init_state, leaves
    from repro_torch.train.step import make_train_step
    model = build(reduced(get_config(arch)))
    params = model.init_values(torch.Generator().manual_seed(0),
                               device="cpu")
    batch = batch_for_step(model.cfg, 64, 4, seed=0, step=0)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=0,
                                              total_steps=10))
    gpu = _cast_tree(params, dev)
    cpu_state, cpu_m = step({"params": params, "opt": init_state(params)},
                            batch)
    before = api.launch_counts()
    api.reset_dispatch_log()
    gpu_state, gpu_m = step({"params": gpu, "opt": init_state(gpu)}, batch)
    torch.cuda.synchronize()
    assert api.launch_counts() == before
    routing = api.dispatch_counters()
    assert routing and all(k[1] in ("accel", "host") and k[2] == "torch"
                           for k in routing), routing
    assert gpu_m["loss"].is_cuda and gpu_state["opt"]["step"].is_cuda
    assert abs(float(gpu_m["loss"]) / float(cpu_m["loss"]) - 1) <= BF16_RTOL
    assert abs(float(gpu_m["grad_norm"]) / float(cpu_m["grad_norm"])
               - 1) <= 1e-2
    bound = 2 * float(cpu_m["lr"]) + 1e-7
    for a, c in zip(leaves(cpu_state["params"]),
                    leaves(gpu_state["params"])):
        assert float((c.cpu() - a).abs().max()) <= bound
