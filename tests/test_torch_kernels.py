"""Each kernel op of the port, through its wrapper on CPU tensors (which
runs the plain PyTorch version), against the JAX package's op: the
Pallas wrapper in interpret mode, as ``tests/test_kernels.py`` runs it.
The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_cuda.py``. Plus the port's dispatch layer.

Tolerances: f32 results differ only by summation order (~1e-6
relative); bf16 outputs by one bf16 rounding (2^-8 relative, so 1e-2 at
the O(1) magnitudes here); the reference's host attention path rounds
its operands and P to bf16, which costs ~3e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.burst import split_burst
from repro.core.quantize import quantize_q4_0 as j_quantize_q4
from repro.core.quantize import quantize_q8_0 as j_quantize
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.fp16_matmul.ops import fp16_matmul as j_fp16
from repro.kernels.q8_attention.ops import q8_decode_attention as j_q8attn
from repro.kernels.q4_attention.ops import cache_traffic_ratio_q4 as \
    j_q4_ratio
from repro.kernels.q4_attention.ops import q4_decode_attention as j_q4attn
from repro.kernels.q4_attention.ref import q4_decode_attention_ref
from repro.kernels.q4_attention.xla import q4_decode_attention_xla
from repro.kernels.q4_matmul.ops import q4_matmul as j_q4mm
from repro.kernels.q4_matmul.ref import q4_matmul_ref
from repro.kernels.q8_attention.ref import q8_decode_attention_ref
from repro.kernels.q8_attention.xla import q8_decode_attention_xla
from repro.kernels.q8_matmul.ops import q8_matmul as j_q8mm
from repro.models.attention import chunked_attention
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import api, decode
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.fp16_matmul import ops as mm_ops
from repro_torch.kernels.fp16_matmul.ops import fp16_matmul, offload_info
from repro_torch.kernels.q4_attention.ops import (
    cache_traffic_ratio_q4, q4_decode_attention, q4_decode_attention_cache,
    quantize_kv_q4)
from repro_torch.kernels.q4_matmul import ops as q4_ops
from repro_torch.kernels.q4_matmul.ops import q4_matmul
from repro_torch.kernels.q8_attention.ops import (q8_decode_attention,
                                                  q8_decode_attention_cache)
from repro_torch.kernels.q8_matmul import ops as q8_ops
from repro_torch.kernels.q8_matmul.ops import q8_matmul
from repro_torch.kernels.registry import KernelSpec
from repro_torch.kernels.slstm_scan import ops as sl_ops
from repro_torch.quantize import Q4Tensor, Q8Tensor

BF = jnp.bfloat16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return tensor_from_numpy(np.asarray(x))


@pytest.mark.parametrize("m,k,n,dtype", [
    (37, 201, 80, "f32"),      # frontend mel: ragged K = 201
    (19, 80, 96, "f32"),       # frontend projection: K = 80
    (9, 128, 256, "bf16"),     # model GEMM, ragged M
    (4, 96, 130, "bf16"),      # decode lanes, ragged N
])
def test_fp16_matmul_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m * k)
    dt = jnp.float32 if dtype == "f32" else BF
    x = jnp.asarray(rng.standard_normal((m, k)), dt)
    w = jnp.asarray(rng.standard_normal((k, n)) * k ** -0.5, dt)
    want = _np(j_fp16(x, w, out_dtype=jnp.float32, interpret=True))
    got = fp16_matmul(_t(x), _t(w), out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_offload_info_is_the_papers_c2_split():
    for k in (80, 201, 384, 1536):
        s = split_burst(k, 16)
        info = offload_info(1500, 384, k)
        assert (info["k_main"], info["k_residual"]) == (s.k_main,
                                                        s.k_residual)


@pytest.mark.parametrize("m,k,n", [(7, 64, 50), (33, 128, 256)])
def test_q8_matmul_matches_jax(m, k, n):
    rng = np.random.default_rng(m + n)
    x = jnp.asarray(rng.standard_normal((m, k)), BF)
    w = j_quantize(jnp.asarray(rng.standard_normal((k, n)), jnp.float32),
                   axis=0)
    want = _np(j_q8mm(x, w, out_dtype=jnp.float32, interpret=True))
    got = q8_matmul(_t(x), Q8Tensor(_t(w.q), _t(w.scale)),
                    out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 16, None), (False, None, 5.0)])
def test_flash_attention_matches_jax(causal, window, softcap):
    # S = 40 is ragged for a block of 128; GQA 4 query heads on 2 KV heads
    rng = np.random.default_rng(40)
    q, k, v = (jnp.asarray(rng.standard_normal(s), BF) for s in
               ((2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _np(j_flash(q, k, v, interpret=True, **kw))
    got = flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_sq_ne_skv_matches_reference_host_path(causal):
    # the reference sends sq != skv (cross-attention prefill) to its host
    # chunked_attention; the port's kernel takes it directly
    rng = np.random.default_rng(12)
    q = jnp.asarray(rng.standard_normal((2, 12, 4, 32)), BF)
    k, v = (jnp.asarray(rng.standard_normal((2, 40, 2, 32)), BF)
            for _ in range(2))
    kr, vr = jnp.repeat(k, 2, axis=2), jnp.repeat(v, 2, axis=2)
    want = _np(chunked_attention(q, kr, vr, causal=causal, window=None,
                                 softcap=None))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


H100_SMS = 132


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("b,sq,skv,h,want,d", [
    (1, 1500, 1500, 6, 3, 64),     # encoder: 12 x 6 = 72 query tiles x 3
    (1, 32, 32, 6, 1, 64),         # decoder prefill: one KV tile
    (1, 32, 1500, 6, 24, 64),      # cross prefill: 6 tiles x 24 splits
    (4, 32, 1500, 6, 8, 64),       # cross prefill of 4 admissions at once
    (1, 1, 1500, 6, 24, 64),
    (1, 32, 1501, 6, 24, 64),      # ragged: the last tile holds 29 keys
    (2, 40, 65, 6, 2, 64),         # 2 KV tiles, the second holds 1 key
    (1, 200, 65, 2, 2, 64),
    # head_dim 128 (64-query blocks) and 256 (64 queries, 32-key tiles,
    # one block an SM): qwen3-4b's and gemma2-2b's prefill at S=256, and
    # few queries against 1500 keys
    (1, 256, 256, 32, 2, 128),
    (2, 40, 65, 4, 2, 128),
    (1, 256, 256, 8, 4, 256),
    (1, 33, 1500, 8, 16, 256),
])
def test_flash_attention_kv_splits(b, sq, skv, h, want, d):
    """The wrapper's KV split: whole KV tiles a split (the head_dim's
    ``LAYOUT``), as many splits as keep every block resident, none of
    them empty; none where the query tiles alone fill that."""
    bq, bkv, resident = fa_ops.LAYOUT[d]
    splits = fa_ops.kv_splits(b, sq, skv, h, H100_SMS, d)
    assert splits == want
    ctas = _cdiv(sq, bq) * b * h
    tiles = _cdiv(skv, bkv)
    assert 1 <= splits <= max(1, tiles)
    per = _cdiv(tiles, splits)          # what the C entry point derives
    assert (splits - 1) * per < tiles   # the last split holds a tile
    if splits > 1:
        assert ctas * splits <= resident * H100_SMS


@pytest.mark.parametrize("m,k,n,want", [
    (4, 1536, 384, 48),      # decode MLP down: 3 column tiles x 48
    (4, 384, 1536, 12),      # decode MLP up: 12 column tiles x 12
    (1, 384, 384, 12),       # one split a scale block: 36 blocks
    (16, 1536, 384, 12),     # the verify's rows, at the threshold
    (16, 1536, 1536, 3),
    (7, 64, 50, 2),
    (1, 6144, 132 * 128, 3),  # at most 64 scale blocks a split
    (17, 1536, 384, 24),     # above it, the tile layout: 6 tiles x 24
    (32, 1536, 384, 24),     # the prefill's MLP down
    (32, 384, 1536, 6),
    (1500, 1536, 384, 2),    # encoder MLP down: 144 tiles x 2 of 12 stages
    (1500, 384, 384, 1),     # 144 tiles of 6 stages: not split
    (1500, 384, 1536, 1),    # 576 tiles: the wide tile, not split
])
def test_q8_matmul_k_splits(m, k, n, want):
    """The split of K across blocks. GEMV layout (M <= 16): whole 32-row
    scale blocks, at most 64 a split, enough splits to reach the SMs.
    Tile layout: whole stages, every block resident, at least 8 stages a
    split where the tiles alone cover the SMs; none for f32 x (its f32
    loop) or where the wide tile takes the call."""
    assert q8_ops.GEMV_MAX_M == 16
    splits = q8_ops.k_splits(m, n, k, H100_SMS)
    assert splits == want
    blocks = k // 32
    if m > q8_ops.GEMV_MAX_M:
        assert q8_ops.k_splits(m, n, k, H100_SMS, x_f32=True) == 1
        stages = _cdiv(blocks, q8_ops.TILE_SB)
        tiles = _cdiv(m, 64) * _cdiv(n, 64)
        assert (splits - 1) * _cdiv(stages, splits) < stages
        assert tiles * splits <= max(tiles, q8_ops.TILE_RESIDENT * H100_SMS)
        return
    per = _cdiv(blocks, splits)         # what the C entry point derives
    assert 1 <= per <= q8_ops.GEMV_MAX_BLOCKS
    assert (splits - 1) * per < blocks
    ctas = _cdiv(n, q8_ops.GEMV_BN) * _cdiv(m, q8_ops.GEMV_MT)
    assert ctas * splits >= H100_SMS or splits == blocks


def _q8_cache(rng, shape):
    t = j_quantize(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                   axis=-1)
    return t.q, t.scale


def test_q8_decode_attention_matches_jax():
    rng = np.random.default_rng(5)
    bh, s, d = 6, 40, 32
    q = jnp.asarray(rng.standard_normal((bh, 1, d)), BF)
    kq, ks = _q8_cache(rng, (bh, s, d))
    vq, vs = _q8_cache(rng, (bh, s, d))
    lens = jnp.asarray([40, 1, 17, 33, 40, 5], jnp.int32)
    want = _np(j_q8attn(q, kq, ks, vq, vs, lens, interpret=True))
    got = q8_decode_attention(*(_t(a) for a in (q, kq, ks, vq, vs, lens)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


def test_q8_decode_attention_length_zero_is_zero():
    """A lane of length 0 attends nothing and the port returns 0. The
    reference does not: its Pallas op returns the mean of V over the
    zero-padded S (blocks of 128) and its ref oracle the mean over S, so
    the two disagree with each other (ROADMAP queue 3)."""
    rng = np.random.default_rng(6)
    bh, s, d = 2, 40, 32
    q = jnp.asarray(rng.standard_normal((bh, 1, d)), BF)
    kq, ks = _q8_cache(rng, (bh, s, d))
    vq, vs = _q8_cache(rng, (bh, s, d))
    lens = jnp.asarray([0, s], jnp.int32)
    got = q8_decode_attention(*(_t(a) for a in (q, kq, ks, vq, vs, lens)))
    assert float(got[0].abs().max()) == 0.0
    pallas = _np(j_q8attn(q, kq, ks, vq, vs, lens, interpret=True))
    ref = _np(q8_decode_attention_ref(q, kq, ks, vq, vs, lens))
    np.testing.assert_allclose(pallas[0], ref[0] * s / 128, rtol=2e-2,
                               atol=2e-3)
    assert np.abs(ref[0]).max() > 1e-3
    np.testing.assert_allclose(got[1].float().numpy(), pallas[1],
                               rtol=1e-2, atol=1e-2)


def test_q8_decode_attention_cache_form_equals_flat_form():
    # the stacked (L, B, S, Hkv, .) entry the engine uses is the flat op
    # on the reference's repeat/transpose of one layer
    rng = np.random.default_rng(7)
    L, b, s, h, hkv, d = 2, 3, 24, 4, 2, 32
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d))).to(torch.bfloat16)
    kq, ks = (_t(a) for a in _q8_cache(rng, (L, b, s, hkv, d)))
    vq, vs = (_t(a) for a in _q8_cache(rng, (L, b, s, hkv, d)))
    lens = torch.tensor([24, 3, 11])
    got = q8_decode_attention_cache(q, kq, ks, vq, vs, lens, 1)

    def flat(c):
        lay = c[1].repeat_interleave(h // hkv, dim=2)
        return lay.permute(0, 2, 1, 3).reshape(b * h, s, -1)
    want = q8_decode_attention(q.permute(0, 2, 1, 3).reshape(b * h, 1, d),
                               flat(kq), flat(ks), flat(vq), flat(vs),
                               lens.repeat_interleave(h))
    torch.testing.assert_close(got, want.reshape(b, h, 1, d)
                               .permute(0, 2, 1, 3))


# ------------------------------------------------------------------ q4_0

@pytest.mark.parametrize("m,k,n", [(1, 64, 50), (4, 128, 96), (7, 96, 130)])
def test_q4_matmul_matches_jax(m, k, n):
    # against the reference's oracle and its Pallas kernel in interpret
    # mode (never q4_matmul_xla, whose bf16 x bf16 -> f32 dot jax's CPU
    # runtime refuses); f32 summation order only
    rng = np.random.default_rng(m + n + 1)
    x = jnp.asarray(rng.standard_normal((m, k)), BF)
    w = j_quantize_q4(jnp.asarray(rng.standard_normal((k, n)), jnp.float32),
                      axis=0)
    got = q4_matmul(_t(x), Q4Tensor(_t(w.q), _t(w.scale)),
                    out_dtype=torch.float32).numpy()
    for want in (_np(q4_matmul_ref(x, w.q, w.scale)),
                 _np(j_q4mm(x, w, out_dtype=jnp.float32, interpret=True))):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _q4_cache(rng, shape):
    t = j_quantize_q4(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                      axis=-1)
    return t.q, t.scale


@pytest.mark.parametrize("nq", [1, 4])
def test_q4_decode_attention_matches_jax(nq):
    # Q = 1 with (BH,) lengths (the reference's Pallas kernel too) and the
    # verify's Q = 4 with (BH, Q) lengths; bf16 outputs: 1e-2, and 3e-2
    # against the host path, which rounds its operands and P to bf16
    rng = np.random.default_rng(8 + nq)
    bh, s, d = 6, 40, 32
    q = jnp.asarray(rng.standard_normal((bh, nq, d)), BF)
    kp, ks = _q4_cache(rng, (bh, s, d))
    vp, vs = _q4_cache(rng, (bh, s, d))
    first = np.array([37, 1, 17, 33, 30, 5], np.int32)
    lens = jnp.asarray(first if nq == 1 else
                       first[:, None] + np.arange(nq)[None, :])
    got = q4_decode_attention(*(_t(a) for a in (q, kp, ks, vp, vs, lens)))
    got = got.float().numpy()
    np.testing.assert_allclose(
        got, _np(q4_decode_attention_ref(q, kp, ks, vp, vs, lens)),
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        got, _np(q4_decode_attention_xla(q, kp, ks, vp, vs, lens)),
        rtol=3e-2, atol=3e-2)
    if nq == 1:
        np.testing.assert_allclose(
            got, _np(j_q4attn(q, kp, ks, vp, vs, lens, interpret=True)),
            rtol=1e-2, atol=1e-2)


def test_q8_decode_attention_multi_query_matches_jax():
    # the verify's (BH, Q) lengths against the reference's host path,
    # the only reference backend that takes Q > 1 (tolerance as above)
    rng = np.random.default_rng(9)
    bh, nq, s, d = 6, 4, 40, 32
    q = jnp.asarray(rng.standard_normal((bh, nq, d)), BF)
    kq, ks = _q8_cache(rng, (bh, s, d))
    vq, vs = _q8_cache(rng, (bh, s, d))
    lens = jnp.asarray(np.array([36, 1, 17, 33, 30, 5])[:, None]
                       + np.arange(nq)[None, :], jnp.int32)
    want = _np(q8_decode_attention_xla(q, kq, ks, vq, vs, lens))
    got = q8_decode_attention(*(_t(a) for a in (q, kq, ks, vq, vs, lens)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(
        got.float().numpy(),
        _np(q8_decode_attention_ref(q, kq, ks, vq, vs, lens)),
        rtol=1e-2, atol=1e-2)


def test_q4_decode_attention_cache_form_equals_flat_form():
    # the stacked (L, B, S, Hkv, D/2) entry with (B, Q) lengths is the
    # flat op on one layer, repeated over the query heads
    rng = np.random.default_rng(10)
    L, b, nq, s, h, hkv, d = 2, 3, 4, 24, 4, 2, 32
    q = torch.from_numpy(rng.standard_normal((b, nq, h, d))) \
        .to(torch.bfloat16)
    kp, ks = (_t(a) for a in _q4_cache(rng, (L, b, s, hkv, d)))
    vp, vs = (_t(a) for a in _q4_cache(rng, (L, b, s, hkv, d)))
    lens = torch.tensor([20, 0, 8])[:, None] + torch.arange(nq)[None, :]
    got = q4_decode_attention_cache(q, kp, ks, vp, vs, lens, 1)

    def flat(c):
        lay = c[1].repeat_interleave(h // hkv, dim=2)
        return lay.permute(0, 2, 1, 3).reshape(b * h, s, -1)
    want = q4_decode_attention(q.permute(0, 2, 1, 3).reshape(b * h, nq, d),
                               flat(kp), flat(ks), flat(vp), flat(vs),
                               lens.repeat_interleave(h, dim=0))
    torch.testing.assert_close(got, want.reshape(b, h, nq, d)
                               .permute(0, 2, 1, 3))
    # lane 1's first query has length 0: it attends nothing
    assert float(got[1, 0].abs().max()) == 0.0


def test_quantize_kv_q4_and_its_traffic_ratio():
    k = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 5, 64)).astype(np.float32))
    p, sc = quantize_kv_q4(k)
    assert p.shape == (2, 5, 32) and p.dtype == torch.uint8
    assert sc.shape == (2, 5, 2) and sc.dtype == torch.float16
    assert cache_traffic_ratio_q4() == j_q4_ratio() == 0.28125


# ------------------------------------------------------------- dispatch

def _spec(op, m, n, k, tag="proj", dtype="f16"):
    return KernelSpec(op, m=m, n=n, k=k, dtype=dtype, tag=tag)


def test_h100_budget_routes_every_main_path_call_to_accel():
    ctx = api.DispatchContext.for_platform("h100-sxm")
    assert ctx.vmem_budget == 232_448
    for spec in (_spec("fp16_matmul", 1500, 1536, 384),
                 _spec("fp16_matmul", 4, 384, 1536),
                 _spec("fp16_matmul", 3000, 80, 201, tag="frontend"),
                 _spec("q8_matmul", 1500, 384, 1536, dtype="q8_0"),
                 _spec("flash_attention", 1500, 1500, 64, tag="attn_qk"),
                 _spec("q8_decode_attention", 1, 1500, 64, tag="attn_qk",
                       dtype="q8_0"),
                 _spec("q4_matmul", 4, 384, 1536, dtype="q4_0"),
                 _spec("q4_decode_attention", 4, 1500, 64, tag="attn_qk",
                       dtype="q4_0")):
        assert api.decide(spec.name, spec, ctx) == ("accel", "cuda")
        # CPU tensors bind the accel decision to the plain version
        assert api.decide(spec.name, spec, ctx, on_cuda=False) == \
            ("accel", "torch")


def test_dispatch_records_host_and_forced_routes():
    api.reset_dispatch_log()
    x, w = torch.ones(4, 64), torch.ones(64, 8)
    with api.use_context(api.DispatchContext(vmem_budget=0, tag="t")):
        y = api.dispatch("fp16_matmul", x, w, tag="frontend")
    with api.use_context(api.DispatchContext(force_backend="torch")):
        api.dispatch("fp16_matmul", x, w)
    with api.use_context(api.DispatchContext(
            backends={"fp16_matmul": "torch"})):
        api.dispatch("fp16_matmul", x, w)
    assert torch.equal(y, torch.full((4, 8), 64.0))
    counts = api.dispatch_counters()
    assert counts[("fp16_matmul", "host", "torch")] == 1
    assert counts[("fp16_matmul", "forced", "torch")] == 2
    rec = api.dispatch_trace()[0]
    assert (rec.spec.tag, rec.tag, rec.budget) == ("frontend", "t", 0)
    with pytest.raises(ValueError):
        with api.use_context(api.DispatchContext(force_backend="pallas")):
            api.dispatch("fp16_matmul", x, w)


def test_cuda_tensors_never_route_to_the_plain_version_quietly():
    spec = _spec("fp16_matmul", 1500, 1536, 384)
    # over budget the law says HOST; on the card the call still runs the
    # kernel, and the record keeps the decision
    over = api.DispatchContext(vmem_budget=0)
    assert api.decide("fp16_matmul", spec, over) == ("host", "cuda")
    assert api.decide("fp16_matmul", spec, over, on_cuda=False) == \
        ("host", "torch")
    for ctx in (api.DispatchContext(force_backend="torch"),
                api.DispatchContext(backends={"fp16_matmul": "torch"})):
        with pytest.raises(ValueError, match="allow_plain_on_cuda"):
            api.decide("fp16_matmul", spec, ctx)
        assert api.decide("fp16_matmul", spec, ctx, on_cuda=False) == \
            ("forced", "torch")
    ctx = api.DispatchContext(force_backend="torch", allow_plain_on_cuda=True)
    assert api.decide("fp16_matmul", spec, ctx) == ("forced", "torch")


def test_wrappers_validate_calls_before_choosing_a_path():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fp16_matmul(x, torch.zeros(64, 8))
    with pytest.raises(ValueError):
        flash_attention(*(torch.zeros(1, 8, 2, 48, dtype=torch.bfloat16),) * 3)
    with pytest.raises(TypeError):     # the kernel takes bf16 only
        flash_attention(*(torch.zeros(1, 8, 2, 64),) * 3)
    with pytest.raises(ValueError):   # (B, Q) lengths for 2 x 2 queries
        q8_decode_attention(torch.zeros(2, 3, 32, dtype=torch.bfloat16), *(
            torch.zeros(2, 8, 32, dtype=torch.int8),
            torch.zeros(2, 8, 1, dtype=torch.float16)) * 2,
            torch.ones(2, 2))
    with pytest.raises(ValueError):   # K = 64 against 24 packed rows
        q4_matmul(x, Q4Tensor(torch.zeros(24, 8, dtype=torch.uint8),
                              torch.zeros(2, 8, dtype=torch.float16)))


# ----------------------------------------------------------------------------
# The Hopper redesigns' planners (pure Python; the wrappers pass their
# choice to the C entry points), and the mixed-type GEMM
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,rows,s,sms,want", [
    (1, 6, 1, 1500, H100_SMS, (64, 24)),     # phases a, b: 144 CTAs
    (4, 6, 1, 1500, H100_SMS, (224, 7)),     # serve, c: 168 CTAs
    (1, 6, 4, 1500, H100_SMS, (64, 24)),     # cross verify, 1 lane
    (4, 6, 4, 1500, H100_SMS, (224, 7)),     # cross verify, 4 lanes
    (1, 6, 1, 35, H100_SMS, (64, 1)),        # self decode: one chunk
    (4, 6, 4, 64, H100_SMS, (64, 1)),        # self verify
    (1, 6, 1, 65536, H100_SMS, (512, 128)),  # above the old shared-memory cap
    (24, 1, 1, 1500, H100_SMS, (224, 7)),    # the flat (BH, Q, D) form
    (2, 2, 6, 40, 8, (64, 1)),               # reduced GQA: 2 row groups
    (3, 2, 3, 100, 8, (64, 2)),
    (1, 1, 1, 0, H100_SMS, (64, 1)),         # an empty cache: one chunk
])
def test_decode_attention_chunk_plan(b, hkv, rows, s, sms, want):
    """The split of the cache positions across CTAs: whole multiples of
    CHUNK_ALIGN, between CHUNK_MIN and CHUNK_MAX, covering [0, S)
    exactly once; at the main path's shapes the CTAs reach the SMs."""
    chunk, nch = decode.chunk_plan(b, hkv, rows, s, sms)
    assert (chunk, nch) == want
    assert chunk % decode.CHUNK_ALIGN == 0
    assert decode.CHUNK_MIN <= chunk <= decode.CHUNK_MAX
    covered = [p for c in range(nch)
               for p in range(c * chunk, min(s, (c + 1) * chunk))]
    assert covered == list(range(s))
    assert nch == 1 or (nch - 1) * chunk < s     # no chunk is empty
    ctas = b * hkv * _cdiv(rows, decode.ROWS_MAX) * nch
    if s == 1500 and sms == H100_SMS:
        assert ctas >= sms


TBF, TF16, TF32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("m,n,k,xd,wd,aligned,want", [
    (1500, 1536, 384, TBF, TBF, True, ("tile", 0, 0)),   # MLP up: 144 tiles
    (1500, 384, 1536, TBF, TBF, True, ("tile", 1, 0)),   # MLP down: 64x128
    (1500, 384, 384, TBF, TBF, True, ("tile", 1, 0)),    # wo
    (1500, 1536, 384, TF16, TF16, True, ("tile", 0, 0)),
    (32, 1536, 384, TBF, TBF, True, ("tile", 2, 0)),     # the prefill: 64x64
    (32, 384, 1536, TBF, TBF, True, ("tile", 2, 0)),
    (17, 384, 1536, TBF, TBF, True, ("tile", 2, 0)),     # one above the GEMV
    (16, 384, 1536, TBF, TBF, True, ("gemv", 16, 8)),    # the verify's rows
    (15, 384, 1536, TBF, TBF, True, ("gemv", 16, 8)),
    (4, 384, 1536, TBF, TBF, True, ("gemv", 16, 8)),     # decode, 4 lanes
    (1, 384, 384, TBF, TBF, True, ("gemv", 16, 8)),      # decode, 1 lane
    (1, 384, 384, TF32, TF32, True, ("fma", 0, 0)),     # f32 x f32: rows
    (4, 51200, 1024, TF32, TBF, True, ("gemv", 16, 1)),  # the xLSTM head
    (4, 51200, 1024, TF32, TF32, True, ("fma", 0, 0)),  # independent of M
    (7, 50, 64, TBF, TBF, False, ("gemv", 16, 8)),       # any alignment
    (256, 51200, 1024, TF32, TBF, True, ("fma", 0, 0)),  # head at prefill
    (3000, 80, 201, TF32, TF32, True, ("fma", 0, 0)),    # the frontend
    (33, 70, 45, TBF, TBF, True, ("fma", 0, 0)),         # rows not 16 B
    (1500, 1536, 384, TBF, TBF, False, ("fma", 0, 0)),   # unaligned base
    (64, 48, 384, TBF, TBF, True, ("fma", 0, 0)),        # N under a box
])
def test_fp16_matmul_plan(m, n, k, xd, wd, aligned, want):
    """The layout the wrapper picks by M, dtype and alignment: the GEMV
    at or under 16 rows for every operand pair but f32 x f32 (a cluster
    of up to 8 CTAs splitting K where the column tiles leave SMs idle),
    the wgmma tile above it for 16-byte aligned bf16 or f16 operands, and
    the f32 FMA loop for f32 x above 16 rows, for f32 x f32 at every M
    (the frontend's rows must not depend on M) and for unaligned rows."""
    names = {mm_ops.FMA: "fma", mm_ops.TILE: "tile", mm_ops.GEMV: "gemv"}
    layout, p0, p1 = mm_ops.plan(m, n, k, xd, wd, H100_SMS, aligned)
    assert (names[layout], p0, p1) == want
    if layout == mm_ops.GEMV:
        vec = 16 // (4 if wd == TF32 else 2)
        tiles = _cdiv(n, p0 * vec)
        assert 1 <= p1 <= mm_ops.CLUSTER_MAX
        assert tiles * p1 >= H100_SMS or p1 == mm_ops.CLUSTER_MAX
        assert mm_ops._gemv_smem(k, p1, 16) <= mm_ops.GEMV_SMEM


@pytest.mark.parametrize("m,k,n", [
    (4, 384, 1536), (4, 1536, 384), (4, 384, 384),   # the draft, 4 lanes
    (1, 384, 1536), (1, 1536, 384), (1, 384, 384),   # the draft, 1 lane
    (16, 1536, 384), (3, 384, 200), (2, 1536, 77),   # row groups, ragged N
    (7, 64, 50), (1, 32, 16), (16, 65536, 384),      # tiny and long K
    (17, 384, 384), (1500, 384, 1536)])              # the row tile
@pytest.mark.parametrize("xd,aligned", [(torch.bfloat16, True),
                                         (torch.float16, True),
                                         (torch.float32, True),
                                         (torch.bfloat16, False)])
def test_q4_matmul_plan(m, k, n, xd, aligned):
    """The Q4_0 GEMM's layout: at 2-16 rows the tensor-core GEMV for bf16
    or f16 x on aligned rows, else (one row too) the CUDA-core GEMV, each
    in a split the C entry point takes (every rank of the cluster a whole
    number of 8-row runs of the packed w, none empty) that leaves a warp
    MMA_CHUNKS 16-k chunks or a lane one packed row, as far as 8 ranks
    reach; the row tile above 16 rows."""
    layout, cgw, warps, ranks = q4_ops.plan(m, n, k, H100_SMS, xd, aligned)
    if m > q4_ops.GEMV_MAX_M:
        assert (layout, cgw, warps, ranks) == (q4_ops.ROWS, 0, 0, 0)
        return
    mma = m >= 2 and xd != torch.float32 and aligned
    assert (layout, cgw) == ((q4_ops.MMA, 0) if mma else (q4_ops.GEMV, 1))
    assert q4_ops.gemv_fits(k, cgw, warps, ranks)
    rpr = q4_ops.rows_per_rank(k, ranks)
    assert rpr % 8 == 0 and (ranks - 1) * rpr < k // 2 <= ranks * rpr
    per_rank = 8 * q4_ops.MMA_CHUNKS * warps if mma else warps * 32
    assert rpr <= 8 * _cdiv(per_rank, 8) or ranks == q4_ops.CLUSTER_MAX


@pytest.mark.parametrize("b,h,hd,aligned,want", [
    (1, 4, 256, True, ("cluster", 16)),   # phase d's prefill, one lane
    (4, 4, 256, True, ("cluster", 16)),   # phase d's decode, 4 lanes
    (7, 4, 256, True, ("cluster", 16)),   # two groups of lanes
    (4, 4, 256, False, ("one", 0)),       # R not on 16 bytes
    (2, 4, 32, True, ("one", 0)),         # the reduced xlstm-350m
    (3, 4, 100, True, ("one", 0)),        # ragged heads
    (1, 1, 1, True, ("one", 0)),
])
def test_slstm_scan_plan(b, h, hd, aligned, want):
    """The sLSTM recurrence's layout: a cluster of CTAs per (head, group
    of up to 4 lanes) at the full head width of 256, each rank holding
    256 / cluster columns of R; one CTA per (lane, head) elsewhere."""
    names = {sl_ops.CLUSTER: "cluster", sl_ops.ONE_CTA: "one"}
    layout, cluster = sl_ops.plan(b, h, hd, aligned)
    assert (names[layout], cluster) == want
    if layout == sl_ops.CLUSTER:
        assert cluster in (8, 16) and hd % (16 * cluster) == 0


def test_fp16_matmul_plan_refuses_x_it_cannot_stage():
    with pytest.raises(ValueError, match="staging"):
        mm_ops.plan(16, 384, 65536, TBF, TBF, H100_SMS)


@pytest.mark.parametrize("xd", [TF32, TBF, TF16])
@pytest.mark.parametrize("wd", [TF32, TBF, TF16])
def test_fp16_matmul_operand_pairs(xd, wd):
    """Equal types, or f32 x with a bf16 or f16 w (widened as it is
    read: the same f32 products); every other pair raises TypeError."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32))
    x, w = x.to(xd), w.to(wd)
    if xd != wd and xd != TF32:
        with pytest.raises(TypeError):
            fp16_matmul(x, w)
        return
    got = fp16_matmul(x, w, out_dtype=TF32)
    want = x.double() @ w.double()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def _head_inputs(seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, 3, 64)), jnp.float32)
    head = jnp.asarray(rng.standard_normal((64, 128)) * 64 ** -0.5, BF)
    return x, head


def test_mm_f32_with_a_bf16_weight_matches_jax(monkeypatch):
    """mm(x_f32, w_bf16, f32): the reference widens w to f32 and
    multiplies; the port passes w as it is stored (the kernel widens it
    in the tile) and gets the same f32 products, to 1e-5 of the
    largest output."""
    from repro.models.layers import mm as j_mm
    from repro_torch.kernels.fp16_matmul import plain as mm_plain
    from repro_torch.models.layers import mm
    x, w = _head_inputs(12)
    seen = []
    real = mm_plain.fp16_matmul

    def spy(a, b, out_dtype=torch.float32):
        seen.append(b.dtype)
        return real(a, b, out_dtype)
    monkeypatch.setattr(mm_plain, "fp16_matmul", spy)
    got = mm(_t(x), _t(w), torch.float32)
    want = _np(j_mm(x, w, jnp.float32))
    assert seen == [torch.bfloat16] and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_logits_head_with_an_untied_bf16_head_matches_jax():
    """The xLSTM head: f32 activations against a bf16 (d, padded vocab)
    head, padding ids at -1e9, to 1e-5 of the largest real logit."""
    from repro.models.layers import logits_head as j_logits_head
    from repro_torch.models.layers import logits_head
    x, head = _head_inputs(13)
    vocab = 100
    table = jnp.zeros((128, 64), BF)
    want = _np(j_logits_head({"table": table}, x, vocab, head=head))
    got = logits_head({"table": _t(table)}, _t(x), vocab,
                      head=_t(head)).numpy()
    err = np.abs(got[..., :vocab] - want[..., :vocab]).max()
    assert err <= 1e-5 * np.abs(want[..., :vocab]).max(), err
    np.testing.assert_allclose(got[..., vocab:], want[..., vocab:],
                               rtol=1e-6)
