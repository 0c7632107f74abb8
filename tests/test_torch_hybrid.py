"""The port's mamba2 block and zamba2 hybrid against the JAX package, on
the CPU, at the reduced zamba2-7b (d_model 128, 4 heads of 32, d_ff 256,
ssm_state 16, 8 SSM heads of 32, vocab 512) with the reference's
parameters carried across by the bridge; and the port's registry
against the reference's, with whisper-base's model.

``reduced()`` gives the hybrid 12 layers (2 segments of 5 mamba blocks
and the shared attention block) and no tail; the 15-layer cases add a
tail of 3 mamba blocks, as zamba2-7b's 81 layers have.

The SSD is f32 in both packages, in the same operation order but for the
einsums' contraction order: 1e-5. The block's bf16 products and
activations round where the reference's do, so it stays within the
reference's own 2e-2 bound of ``tests/test_models_smoke.py``. Through 12
or 15 layers of random weights the residual stream carries each block's
bf16 roundings tipped apart (a mamba block here amplifies its input's
difference ~4x; measured), so the model's logits agree to ~4 % in
relative norm (measured 3.3-4.5 %) where the dense models' 2 layers give
~1 %.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs, reduced
from repro.models import ssm as js
from repro.models.model import build as j_build
from repro_torch.bridge import (params_from_numpy, params_to_numpy,
                                tensor_from_numpy)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import ssm as ts
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import layer_slice
from repro_torch.models.model import build
from repro_torch.serving.scheduler import BatchScheduler

from test_torch_dense import (PROMPTS, _drain, _engine, _request, _setup,
                              conformance_battery)

VOCAB = 512
ARCH = "zamba2-7b"
TIE_MARGIN = 0.15   # tests/test_serving.py's bf16 margin
#: the model's logits over the reference's, in relative norm (measured
#: 3.3-4.5 % at 12 and 15 layers)
LOGIT_REL = 0.1
#: the reference's bound for a mamba block (tests/test_models_smoke.py)
BLOCK_TOL = 2e-2
LAYERS = (12, 15)


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return tensor_from_numpy(np.asarray(x))


def _hybrid(n_layers: int = 12):
    """(reference model, port model, reference params, bridged params) of
    the reduced zamba2-7b at ``n_layers``."""
    return _setup(ARCH, n_layers=n_layers)


def _block(n_layers: int = 12, seg: int = 0, j: int = 0):
    """Mamba block ``j`` of segment ``seg``: (reference cfg, port cfg,
    reference params, bridged params)."""
    jm, tm, jp, tp = _hybrid(n_layers)
    jb = jax.tree.map(lambda a: a[seg], jp["segments"][f"block{j}"]["mamba"])
    tb = layer_slice(tp["segments"][f"block{j}"]["mamba"], seg)
    return jm.cfg, tm.cfg, jb, tb


def _rel(got, want) -> float:
    g, w = got.float().numpy(), _f32(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


# ----------------------------------------------------------------------------
# The causal conv and the chunked SSD
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    """The depthwise conv of bf16 inputs over f32 taps (W = 4), from the
    zero padding or from a bf16 state: the same f32 products summed in
    the same order, so the sum and the tail agree bit for bit and the
    silu to f32 rounding (1e-6 of the largest value)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 11, 40)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 40)) * 0.5, jnp.float32)
    st = jnp.asarray(rng.standard_normal((2, 3, 40)), jnp.bfloat16) \
        if with_state else None
    yj, tj = js._causal_conv(x, w, st)
    yt, tt = ts._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    assert yt.dtype == torch.float32 and tt.dtype == torch.bfloat16
    assert yt.shape == yj.shape and tt.shape == tj.shape
    assert _rel(yt, yj) <= 1e-6
    assert np.array_equal(tt.float().numpy(), _f32(tj))


def test_ssd_chunked_matches_reference():
    """``_ssd_chunked`` at chunk 8 over S = 29 (3 whole chunks and a
    padded one) from a non-zero state: y and the final state within 1e-5
    of their largest value (measured 2.1e-7 and 7.3e-8)."""
    rng = np.random.default_rng(1)
    b, s, h, hd, n = 2, 29, 8, 32, 16
    xh = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = (-np.exp(0.5 * rng.standard_normal(h)) * dt).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, hd, n)).astype(np.float32)
    args = (xh, dt, a, B, C, h0)
    yj, hj = js._ssd_chunked(*map(jnp.asarray, args), chunk=8)
    yt, ht = ts._ssd_chunked(*map(torch.from_numpy, args), chunk=8)
    assert yt.shape == (b, s, h, hd) and ht.shape == (b, h, hd, n)
    assert _rel(yt, yj) <= 1e-5 and _rel(ht, hj) <= 1e-5


# ----------------------------------------------------------------------------
# The mamba block
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mamba_block_matches_reference(mode):
    """One mamba block over 40 positions (train, prefill with a bf16
    cache), and one decode step from the reference's prefill cache
    carried across: the output and the cache within the reference's 2e-2
    (measured 7e-4 for the outputs, 2e-3 for the bf16 conv tail)."""
    cfg, tcfg, jb, tb = _block()
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 40, 128)), jnp.bfloat16)
    if mode == "decode":
        _, jc = js.mamba_block(jb, x, cfg, mode="prefill",
                               cache=js.init_mamba_cache(cfg, 2))
        x1 = jnp.asarray(rng.standard_normal((2, 1, 128)), jnp.bfloat16)
        yj, cj = js.mamba_block(jb, x1, cfg, mode="decode", cache=jc)
        yt, ct = ts.mamba_block(tb, _t(x1), tcfg, mode="decode",
                                cache=_bridge(jc))
    else:
        cj0 = js.init_mamba_cache(cfg, 2) if mode == "prefill" else None
        yj, cj = js.mamba_block(jb, x, cfg, mode=mode, cache=cj0)
        yt, ct = ts.mamba_block(tb, _t(x), tcfg, mode=mode,
                                cache=None if cj0 is None
                                else ts.init_mamba_cache(tcfg, 2))
    assert yt.dtype == torch.bfloat16 and yt.shape == yj.shape
    np.testing.assert_allclose(yt.float().numpy(), _f32(yj),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
    if mode == "train":
        assert ct is None and cj is None
        return
    assert set(ct) == set(cj) == {"conv", "h"}
    for k in cj:
        assert ct[k].dtype == torch.bfloat16 and ct[k].shape == cj[k].shape
        np.testing.assert_allclose(ct[k].float().numpy(), _f32(cj[k]),
                                   rtol=BLOCK_TOL, atol=BLOCK_TOL)


SPLIT = 11


def test_chunked_prefill_continued_stepwise_equals_recurrent_ref():
    """The reference's ``test_mamba_prefill_state_matches_stepwise`` and
    ``test_ssd_chunked_equals_recurrent`` on the port alone: the chunked
    prefill's f32 state, continued step by step, gives the tail of the
    all-steps oracle ``mamba_recurrent_ref``, and the chunked train
    forward its every position, within the reference's 2e-2."""
    _, tcfg, _, tb = _block()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 24, 128)).astype(np.float32) * 0.5)
    _, cache = ts.mamba_block(tb, x[:, :SPLIT], tcfg, mode="prefill",
                              cache=ts.init_mamba_cache(tcfg, 2,
                                                        torch.float32))
    ys = []
    for t in range(SPLIT, x.shape[1]):
        y, cache = ts.mamba_block(tb, x[:, t:t + 1], tcfg, mode="decode",
                                  cache=cache)
        ys.append(y)
    y_ref = ts.mamba_recurrent_ref(tb, x, tcfg)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(),
                               y_ref[:, SPLIT:].numpy(),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
    y_par, _ = ts.mamba_block(tb, x, tcfg, mode="train")
    np.testing.assert_allclose(y_par.numpy(), y_ref.numpy(),
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_prepared_mamba_equals_unprepared(mode):
    """``prepare_mamba``'s fused bf16 ``w_in``, fused conv taps and bf16
    ``wo`` give the block's outputs and state bit for bit: the forward
    makes the same tensors where they are absent."""
    _, tcfg, _, tb = _block()
    rng = np.random.default_rng(5)
    x = _t(jnp.asarray(rng.standard_normal((2, 9, 128)), jnp.bfloat16))
    cache = ts.init_mamba_cache(tcfg, 2)
    _, cache = ts.mamba_block(tb, x, tcfg, mode="prefill", cache=cache)
    if mode == "decode":
        x = x[:, :1]
    outs = [ts.mamba_block(p, x, tcfg, mode=mode, cache=cache)
            for p in (tb, ts.prepare_mamba(tb))]
    (y0, c0), (y1, c1) = outs
    assert torch.equal(y0, y1)
    assert all(torch.equal(c0[k], c1[k]) for k in ("conv", "h"))


# ----------------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------------

def _assert_picks(got, want):
    """The greedy pick at every position equals the reference's, but at
    a near-tie: the reference's logit of the port's pick within
    ``TIE_MARGIN`` of its own argmax's."""
    g, w = got.argmax(-1), want.argmax(-1)
    gap = np.take_along_axis(want, w[..., None], -1) \
        - np.take_along_axis(want, g[..., None], -1)
    assert np.all((g == w) | (gap[..., 0] < TIE_MARGIN)), gap[g != w]


def _assert_logits(got, want):
    g, w = got.numpy()[..., :VOCAB], _f32(want)[..., :VOCAB]
    assert g.shape == w.shape
    assert np.linalg.norm(g - w) <= LOGIT_REL * np.linalg.norm(w)


def test_bridge_carries_the_hybrid_tree():
    """The reference's tree crosses with its ``segments`` (the empty
    ``block5`` of the shared block), ``shared`` and ``tail`` subtrees and
    back bit for bit; the port's own init draws the same tree, the
    projections in bf16 at ``dtype=bf16`` and the SSM leaves f32."""
    jm, tm, jp, tp = _hybrid(15)
    assert set(tp) == {"embed", "segments", "final_norm", "tail", "shared",
                       "lm_head"}
    assert tp["segments"]["block5"] == {}
    assert tp["tail"]["block0"]["mamba"]["wz"].shape == (3, 128, 256)
    assert tp["shared"]["attn"]["wq"].shape == (128, 4, 32)
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert np.array_equal(np.asarray(a), b), path
    mine = tm.init_values(torch.Generator().manual_seed(0), device="cpu",
                          dtype=torch.bfloat16)
    assert jax.tree.structure(params_to_numpy(mine)) \
        == jax.tree.structure(back)
    assert all(np.shape(a) == np.shape(b) for a, b in zip(
        jax.tree.leaves(params_to_numpy(mine)), jax.tree.leaves(back)))
    mb = mine["segments"]["block0"]["mamba"]
    assert mb["wx"].dtype == torch.bfloat16 == mine["shared"]["mlp"]["up"] \
        .dtype
    assert all(mb[k].dtype == torch.float32
               for k in ("wdt", "dt_bias", "A_log", "D", "out_norm",
                         "conv_x"))


@pytest.mark.parametrize("n_layers", LAYERS)
def test_model_prefill_and_decode_match_reference(n_layers):
    """``Model.forward`` train and prefill of a 30-token prompt, then 3
    greedy decode steps, the first from the port's own prefill cache and
    each from the reference's cache carried across: logits within
    ``LOGIT_REL`` in relative norm, the same greedy picks position by
    position but for near-ties, padding ids at the large negative logit, and the decode
    writing into the pool it was given (the shared block's K/V rows at
    each occurrence, every mamba state, the tail's)."""
    jm, tm, jp, tp = _hybrid(n_layers)
    toks = np.random.default_rng(3).integers(3, VOCAB, size=(2, 30))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tc is None
    _assert_logits(tl, jl)
    jl, jc = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        mode="prefill", cache=jm.init_cache(2, 48))
    tl, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", cache=tm.init_cache(2, 48,
                                                            device="cpu"))
    _assert_logits(tl, jl)
    assert set(tc) == ({"segments", "tail"} if n_layers == 15
                       else {"segments"})
    _assert_picks(tl.numpy()[:, :, :VOCAB], _f32(jl)[:, :, :VOCAB])
    nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]
    for i in range(3):
        pos = np.full((2,), 30 + i)
        pools = [_bridge(jc)] + ([tc] if i == 0 else [])
        jl, jc = jm.forward(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                            mode="decode", cache=jc, pos=jnp.asarray(pos))
        for pool in pools:
            tl, new = tm.forward(tp, {"tokens": torch.from_numpy(nxt)},
                                 mode="decode", cache=pool,
                                 pos=torch.from_numpy(pos))
            assert new is pool
            _assert_logits(tl, jl)
            _assert_picks(tl.numpy()[:, -1:, :VOCAB],
                          _f32(jl)[:, -1:, :VOCAB])
        got = pools[0]["segments"]["block5"]["kv"]["k"][:, :, 30 + i]
        want = _f32(jc["segments"]["block5"]["kv"]["k"][:, :, 30 + i])
        assert np.linalg.norm(got.float().numpy() - want) \
            <= LOGIT_REL * np.linalg.norm(want)
        for part in ("segments", "tail") if n_layers == 15 else ("segments",):
            for name, w in jc[part]["block0"]["ssm"].items():
                g = pools[0][part]["block0"]["ssm"][name].float().numpy()
                assert np.linalg.norm(g - _f32(w)) \
                    <= LOGIT_REL * np.linalg.norm(_f32(w)), (part, name)
        nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]
    assert float(tl[..., VOCAB:].max()) < -1e8


def test_state_spec_and_lane_bytes_match_reference():
    """The lane state spec the engine drives off and the per-lane
    footprint by kind equal the reference's at full width (no quantized
    tier: head_dim 112 is not a multiple of 32; 68 mamba states, 13 K/V
    occurrences), reduced (q8_0 and q4_0 at head_dim 32) and at 15
    layers."""
    for shrink, t_shrink in (
            (lambda c: c, lambda c: c), (reduced, t_reduced),
            (lambda c: dataclasses.replace(reduced(c), n_layers=15),
             lambda c: dataclasses.replace(t_reduced(c), n_layers=15))):
        jm = j_build(shrink(get_config(ARCH)))
        tm = build(t_shrink(t_get_config(ARCH)))
        js_, ts_ = jm.state_spec(), tm.state_spec()
        for f in ("family", "self_kv", "cross_kv", "recurrent",
                  "moe_experts", "moe_top_k", "prefill_exact",
                  "quant_tiers", "state_kinds"):
            assert getattr(ts_, f) == getattr(js_, f), f
        assert ts_.recurrent == ("ssm",) and ts_.self_kv \
            and ts_.prefill_exact
        for max_len in (64, 320):
            for dt in ("bf16",) + ts_.quant_tiers:
                jdt = jnp.bfloat16 if dt == "bf16" else dt
                tdt = torch.bfloat16 if dt == "bf16" else dt
                assert tm.lane_state_bytes(max_len, dtype=tdt) \
                    == jm.lane_state_bytes(max_len, dtype=jdt), \
                    (max_len, dt)
    full = build(t_get_config(ARCH))
    assert full.state_spec().quant_tiers == ()
    assert tf_mod.n_segments(full.cfg) == 13
    assert len(tf_mod.tail_pattern(full.cfg)) == 3


def test_quantize_refuses_mamba_blocks():
    """The reference's ``mamba_block`` casts its weights with
    ``.astype``, which a quantized weight lacks: the port refuses to
    quantize a tree with mamba blocks, and says why."""
    _, tm, _, tp = _hybrid()
    for tier in ("q8_0", "q4_0"):
        with pytest.raises(ValueError, match="mamba blocks take float"):
            tm.quantize(tp, tier)


def test_engine_refuses_spec_k_and_pages():
    """Speculative decoding is refused at construction (a rejected draft
    would leave the ssm state advanced), with the xLSTM refusal's
    wording; pages need an enc-dec model, as in the reference."""
    _, tm, _, tp = _hybrid()
    with pytest.raises(ValueError, match="roll"):
        _engine(tm, tp, spec_k=2)
    with pytest.raises(ValueError, match="enc-dec"):
        _engine(tm, tp, paged=True)


# ----------------------------------------------------------------------------
# The serving engine (the reference's tests/test_engine_conformance.py)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", LAYERS)
@pytest.mark.parametrize("cache_dtype", ["bf16", "q8_0"])
def test_conformance_battery(n_layers, cache_dtype):
    """The reference's battery for zamba2-7b (its rows at 12 layers, and
    at 15 with the tail): exact-length prefill, fused ticks, EOS mid-block,
    abort, the ledger drained, one host sync a tick, the tokens the
    reference's full forward picks up to a near-tie."""
    jm, tm, jp, tp = _hybrid(n_layers)
    eng = conformance_battery(jm, jp, tm, tp, cache_dtype)
    rep = eng.cache_report()
    assert rep["state_kinds"] == ["self_kv", "ssm"]
    assert rep["state_bytes_total"] > 0


def test_engine_tokens_match_reference_engine():
    """The port's engine and the reference's on the same requests
    (prompts of 3, 4 and 40 ids, 3 slots, 4 steps a tick, 15 layers,
    bf16 and q8_0 caches): the same tokens up to their first difference,
    where the two picks must be a near-tie of the port's own logits row,
    and the same cache accounting."""
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServeEngine as JServeEngine
    jm, tm, jp, tp = _hybrid(15)
    prompts = list(PROMPTS) + [list(range(3, 43))]
    for cache_dtype in ("bf16", "q8_0"):
        kw = dict(n_slots=3, max_len=64, decode_block=4,
                  cache_dtype=cache_dtype)
        jeng = JServeEngine(jm, jp, **kw)
        jsts = [jeng.admit(JRequest(uid=i, tokens=p, max_new=6, eos_id=-1))
                for i, p in enumerate(prompts)]
        while jeng.n_active:
            jeng.step()
        eng = _engine(tm, tp, keep_logits=True, **kw)
        sts = [eng.admit(_request(i, p, eos=-1)) for i, p in
               enumerate(prompts)]
        _drain(eng)
        for st, jst in zip(sts, jsts):
            assert len(st.out) == len(jst.out) == 6
            diff = [i for i, (g, w) in enumerate(zip(st.out, jst.out))
                    if g != w]
            if diff:
                i = diff[0]
                row = st.logits[i].float()
                gap = float(row[st.out[i]] - row[jst.out[i]])
                assert gap < TIE_MARGIN, (cache_dtype, i, gap)
        got, want = eng.cache_report(), jeng.cache_report()
        for k in ("kv_bytes_total", "state_bytes_total", "bytes_per_step",
                  "state_bytes_per_step", "self_kv_bytes_per_token",
                  "state_kinds", "family", "traffic_ratio_vs_bf16"):
            assert got[k] == want[k], (cache_dtype, k)


def test_scheduler_serves_the_hybrid():
    """5 requests through 2 slots with a queued cancel (the reference's
    ``test_scheduler_serves_family``)."""
    _, tm, _, tp = _hybrid(15)
    eng = _engine(tm, tp, n_slots=2)
    sched = BatchScheduler(eng)
    for i in range(5):
        sched.submit(_request(i, PROMPTS[i % 2], max_new=3))
    assert sched.abort(3) is not None
    sched.run_until_drained(max_ticks=200)
    assert sched.drained and eng.lanestate.drained
    assert sched.metrics.completed == 4
    assert all(len(sched.results[i].out) == 3 for i in (0, 1, 2, 4))


def test_serve_cli_on_the_cpu(capsys):
    """``repro_torch.launch.serve --arch zamba2-7b --reduced --device
    cpu`` serves every request, with the energy report."""
    m = serve_cli.main(["--arch", "zamba2-7b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2",
                        "--max-len", "64", "--max-new", "4",
                        "--decode-block", "4", "--platform", "h100-sxm"])
    out = capsys.readouterr().out
    assert m.completed == 3 and "energy[h100-sxm]" in out


# ----------------------------------------------------------------------------
# The registry, and whisper-base
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", list_archs())
def test_config_equals_the_reference(name):
    """Every name of the reference's registry resolves in the port to a
    config equal field by field, at full width and reduced."""
    for shrink, t_shrink in ((lambda c: c, lambda c: c),
                             (reduced, t_reduced)):
        want = shrink(get_config(name))
        got = t_shrink(t_get_config(name))
        fields = [f.name for f in dataclasses.fields(got)]
        assert fields == [f.name for f in dataclasses.fields(want)]
        assert {f: getattr(got, f) for f in fields} \
            == {f: getattr(want, f) for f in fields}, name


def test_whisper_base_prefill_and_greedy_decode_match_reference():
    """The reduced whisper-base on the same frames and weights: the
    prefill's logits and 4 greedy decode steps from the port's own
    prefill cache, within the Whisper tests' bounds
    (``tests/test_torch_model.py``: 0.05 absolute, 1.5e-2 in relative
    norm), with the same greedy tokens."""
    cfg, tcfg = reduced(get_config("whisper-base")), \
        t_reduced(t_get_config("whisper-base"))
    jm, tm = j_build(cfg), build(tcfg)
    jp = jm.init_values(jax.random.key(2))
    tp = _bridge(jp)
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((1, 24, 128)).astype(np.float32)
    toks = np.array([[1, 5, 9, 3]], np.int32)
    jl, jc = jm.forward(jp, {"tokens": jnp.asarray(toks),
                             "enc_frames": jnp.asarray(frames)},
                        mode="prefill", cache=jm.init_cache(1, 16, 24))
    tl, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks).long(),
                             "enc_frames": torch.from_numpy(frames)},
                        mode="prefill",
                        cache=tm.init_cache(1, 16, 24, device="cpu"))

    def near(g, w):
        g, w = g.numpy()[..., :VOCAB], _f32(w)[..., :VOCAB]
        np.testing.assert_allclose(g, w, atol=0.05, rtol=0)
        assert np.linalg.norm(g - w) <= 1.5e-2 * np.linalg.norm(w)
    near(tl, jl)
    nxt = int(_f32(jl)[0, -1, :VOCAB].argmax())
    assert int(tl[0, -1, :VOCAB].argmax()) == nxt
    for i in range(4):
        pos = 4 + i
        jl, jc = jm.forward(jp, {"tokens": jnp.asarray([[nxt]]),
                                 "enc_lens": jnp.asarray([24])},
                            mode="decode", cache=jc, pos=jnp.asarray([pos]))
        tl, tc = tm.forward(tp, {"tokens": torch.tensor([[nxt]]),
                                 "enc_lens": torch.tensor([24])},
                            mode="decode", cache=tc,
                            pos=torch.tensor([pos]))
        near(tl, jl)
        nxt = int(_f32(jl)[0, 0, :VOCAB].argmax())
        assert int(tl[0, 0, :VOCAB].argmax()) == nxt
