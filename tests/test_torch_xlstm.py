"""The port's xLSTM slice against the JAX package, on the CPU, at the
reduced xlstm-350m (d_model 128, 4 heads, 4 blocks, vocab 512) with the
reference's parameters carried across by the bridge.

Where the kernels run their plain versions here (CPU tensors), the
``slstm_scan`` op is held to the reference's Pallas kernel in interpret
mode and to its ``ref`` oracle in f32. The blocks, the model and the
engine are held to the reference with the tolerances stated beside each
test: the port's bf16 products and activations round where the
reference's do, so what remains is f32 summation order and, rarely, a
bf16 rounding that it tips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.slstm_scan.ops import slstm_scan as j_slstm_scan
from repro.kernels.slstm_scan.ref import slstm_scan_ref
from repro.models import xlstm as jx
from repro.models.model import build as j_build
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.bridge import (params_from_numpy, params_to_numpy,
                                tensor_from_numpy)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import api
from repro_torch.kernels.slstm_scan import ops as sl_ops
from repro_torch.kernels.slstm_scan import plain as sl_plain
from repro_torch.launch import serve as serve_cli
from repro_torch.models import xlstm as tx
from repro_torch.models.layers import layer_slice
from repro_torch.models.model import build
from repro_torch.serving.engine import RejectCode, Request, ServeEngine
from repro_torch.serving.scheduler import BatchScheduler

VOCAB = 512
TIE_MARGIN = 0.15   # tests/test_serving.py's bf16 margin
# f32 recurrences, the same step math: summation order only
F32_ATOL = 2e-5
F32_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("xlstm-350m"))
    tcfg = t_reduced(t_get_config("xlstm-350m"))
    assert (cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.vocab) \
        == (tcfg.d_model, tcfg.n_heads, tcfg.n_layers, tcfg.vocab) \
        == (128, 4, 4, 512)
    jm, tm = j_build(cfg), build(tcfg)
    jp = jm.init_values(jax.random.key(1))
    return jm, tm, jp, _bridge(jp)


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return tensor_from_numpy(np.asarray(x))


# ----------------------------------------------------------------------------
# slstm_scan: the op against the reference's Pallas kernel and oracle
# ----------------------------------------------------------------------------

def _scan_inputs(s, b=2, h=2, hd=32, seed=0):
    """wx, R and a non-initial state0 (c, n > 0, h, finite m)."""
    rng = np.random.default_rng(seed)
    wx = rng.standard_normal((s, 4, b, h, hd)).astype(np.float32)
    r = (rng.standard_normal((4, h, hd, hd)) * hd ** -0.5) \
        .astype(np.float32)
    st = np.stack([rng.standard_normal((b, h, hd)),
                   np.abs(rng.standard_normal((b, h, hd))) + 0.5,
                   0.5 * rng.standard_normal((b, h, hd)),
                   rng.standard_normal((b, h, hd))]).astype(np.float32)
    return wx, r, st


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
@pytest.mark.parametrize("s", [13, 1])
def test_slstm_scan_matches_the_reference_op(oracle, s):
    """S=13 with t_chunk=8 runs through the reference's state-preserving
    chunk padding; S=1 is the decode step. Both from a non-initial state;
    hs and each state leaf within F32_ATOL + F32_RTOL * |want|."""
    wx, r, st = _scan_inputs(s)
    if oracle == "pallas":
        jh, js = j_slstm_scan(jnp.asarray(wx), jnp.asarray(r),
                              jnp.asarray(st), t_chunk=8, interpret=True)
    else:
        jh, js = slstm_scan_ref(jnp.asarray(wx), jnp.asarray(r),
                                jnp.asarray(st))
    th, ts = sl_plain.slstm_scan(torch.from_numpy(wx), torch.from_numpy(r),
                                 torch.from_numpy(st))
    assert th.shape == (s, 2, 2, 32) and ts.shape == (4, 2, 2, 32)
    np.testing.assert_allclose(th.numpy(), _f32(jh), atol=F32_ATOL,
                               rtol=F32_RTOL)
    for leaf in range(4):
        np.testing.assert_allclose(ts[leaf].numpy(), _f32(js)[leaf],
                                   atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("s", [13, 1])
def test_slstm_scan_takes_a_bf16_r(s):
    """R in bf16, as the model stores it: exactly the result of the same
    values widened to f32, and the reference's op (its ``ref`` oracle,
    which casts R to f32 itself) within F32_ATOL + F32_RTOL * |want|."""
    wx, r, st = _scan_inputs(s, seed=4)
    rb = torch.from_numpy(r).to(torch.bfloat16)
    wt, stt = torch.from_numpy(wx), torch.from_numpy(st)
    th, ts = sl_ops.slstm_scan(wt, rb, stt)
    fh, fs = sl_ops.slstm_scan(wt, rb.float(), stt)
    assert torch.equal(th, fh) and torch.equal(ts, fs)
    jh, js = slstm_scan_ref(jnp.asarray(wx),
                            jnp.asarray(rb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(st))
    np.testing.assert_allclose(th.numpy(), _f32(jh), atol=F32_ATOL,
                               rtol=F32_RTOL)
    np.testing.assert_allclose(ts.numpy(), _f32(js), atol=F32_ATOL,
                               rtol=F32_RTOL)


def test_slstm_block_passes_r_as_stored(setup, monkeypatch):
    """The sLSTM block hands ``slstm_scan`` its bf16 recurrent weights as
    stored, stacked (4, H, hd, hd) without an f32 copy; f32 weights stay
    f32."""
    tp = setup[3]
    tcfg = t_reduced(t_get_config("xlstm-350m"))
    tpb = layer_slice(tp["segments"]["block1"]["slstm"], 0)
    seen = []
    real = tx.dispatch

    def spy(name, *args, **kw):
        if name == "slstm_scan":
            seen.append(args[1].dtype)
        return real(name, *args, **kw)
    monkeypatch.setattr(tx, "dispatch", spy)
    x = torch.zeros((1, 3, 128), dtype=torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        p = {**tpb, **{g: {**tpb[g], "r": tpb[g]["r"].to(dt)}
                       for g in tx.GATES}}
        tx.slstm_block(p, x, tcfg, mode="prefill",
                       cache=tx.init_slstm_cache(tcfg, 1))
    assert seen == [torch.bfloat16, torch.float32]


def test_slstm_scan_saturated_gates_stay_finite():
    """i >> 0 and f << 0 (and the reverse): the stabiliser exponentiates
    differences only, so nothing overflows; same answer as the oracle."""
    wx, r, st = _scan_inputs(9)
    wx[:, 0, 0] += 60.0
    wx[:, 1, 0] -= 60.0
    wx[:, 0, 1] -= 60.0
    wx[:, 1, 1] += 60.0
    jh, js = slstm_scan_ref(jnp.asarray(wx), jnp.asarray(r), jnp.asarray(st))
    th, ts = sl_ops.slstm_scan(torch.from_numpy(wx), torch.from_numpy(r),
                               torch.from_numpy(st))
    assert torch.isfinite(th).all() and torch.isfinite(ts).all()
    np.testing.assert_allclose(th.numpy(), _f32(jh), atol=F32_ATOL,
                               rtol=F32_RTOL)
    np.testing.assert_allclose(ts.numpy(), _f32(js), atol=F32_ATOL,
                               rtol=F32_RTOL)


def test_slstm_scan_dispatch_spec_and_refusals():
    """The op's KernelSpec is the reference's (m = B*H, n = k = hd, f32,
    count = 4*S, tag ssm), CPU tensors route to the plain version, and
    the wrapper refuses what the kernel does not take."""
    wx, r, st = (torch.from_numpy(a) for a in _scan_inputs(5))
    api.reset_dispatch_log()
    hs, state = api.dispatch("slstm_scan", wx, r, st)
    rec = api.dispatch_trace()[-1]
    assert (rec.decision, rec.backend) == ("accel", "torch")
    spec = rec.spec
    assert (spec.m, spec.n, spec.k, spec.dtype, spec.count, spec.tag) == \
        (4, 32, 32, "f32", 20, "ssm")
    want = sl_plain.slstm_scan(wx, r, st)
    assert torch.equal(hs, want[0]) and torch.equal(state, want[1])
    with pytest.raises(TypeError, match="float32"):
        sl_ops.slstm_scan(wx.to(torch.bfloat16), r, st)
    with pytest.raises(ValueError, match="contiguous"):
        sl_ops.slstm_scan(wx.transpose(0, 1).contiguous().transpose(0, 1),
                          r, st)
    with pytest.raises(ValueError, match="do not fit"):
        sl_ops.slstm_scan(wx, r[:, :1], st)
    with pytest.raises(ValueError, match="S >= 1"):
        sl_ops.slstm_scan(wx[:0], r, st)


# ----------------------------------------------------------------------------
# Blocks, model
# ----------------------------------------------------------------------------

BLOCKS = {"mlstm": ("block0", jx.mlstm_block, tx.mlstm_block,
                    jx.init_mlstm_cache, tx.init_mlstm_cache),
          "slstm": ("block1", jx.slstm_block, tx.slstm_block,
                    jx.init_slstm_cache, tx.init_slstm_cache)}


@pytest.mark.parametrize("s", [150, 20])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_block_prefill_and_decode_match_reference(setup, block, s):
    """One block, prefill of S positions (150 > MCHUNK: the chunk carry
    runs) then one decode step from the reference's own bf16 cache. The
    outputs (bf16) within 2 bf16 ulps of the largest value and 1e-3 in
    relative norm (measured 8e-4: a product the two sides round
    differently tips a bf16 rounding now and then); the bf16 cache leaves
    within one bf16 rounding of each value plus 4e-3 of the leaf's
    largest (measured 1.4e-3 in C after 150 steps, whose bf16 k and v
    carry those tipped roundings), and 1e-3 in relative norm (measured
    2.3e-4)."""
    jm, _, jp, tp = setup
    cfg, tcfg = jm.cfg, t_reduced(t_get_config("xlstm-350m"))
    key, jf, tf, jinit, tinit = BLOCKS[block]
    jpb = jax.tree.map(lambda a: a[0], jp["segments"][key][block])
    tpb = layer_slice(tp["segments"][key][block], 0)
    rng = np.random.default_rng(7)
    xj = jnp.asarray(rng.standard_normal((2, s, 128)), jnp.bfloat16)
    xt = _t(xj)
    yj, cj = jf(jpb, xj, cfg, mode="prefill", cache=jinit(cfg, 2))
    yt, ct = tf(tpb, xt, tcfg, mode="prefill", cache=tinit(tcfg, 2))
    _assert_bf16_out(yt, yj)
    _assert_bf16_cache(ct, cj)
    # decode from the reference's cache, carried across
    x1 = jnp.asarray(rng.standard_normal((2, 1, 128)), jnp.bfloat16)
    yj, cj2 = jf(jpb, x1, cfg, mode="decode", cache=cj)
    yt, ct2 = tf(tpb, _t(x1), tcfg, mode="decode", cache=_bridge(cj))
    _assert_bf16_out(yt, yj)
    _assert_bf16_cache(ct2, cj2)


def _assert_bf16_out(got, want):
    g, w = got.float().numpy(), _f32(want)
    assert np.abs(g - w).max() <= 2 * 2 ** -8 * np.abs(w).max()
    assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w)


def _assert_bf16_cache(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        g, w = got[k].float().numpy(), _f32(want[k])
        tol = 2 ** -7 * np.abs(w) + 4e-3 * np.abs(w).max()
        assert np.all(np.abs(g - w) <= tol), k
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), k


def test_model_prefill_and_four_decode_steps_match_reference(setup):
    """``Model.forward`` prefill of a 140-token prompt (over MCHUNK) and
    4 greedy decode steps against the reference's ``decoder_forward``:
    the first step from the port's own prefill state, handed to decode
    through its pool, each step also from the reference's cache carried
    across. Logits within 5 % in relative norm (measured 1.1-1.6 %: a
    bf16 rounding tipped in one block grows through the residual stream
    of random weights, ~3x a block), the same greedy tokens, and the
    state written into the pool within the same 5 %."""
    jm, tm, jp, tp = setup
    toks = np.random.default_rng(3).integers(3, VOCAB, size=(2, 140))
    jl, jc = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        mode="prefill", cache=jm.init_cache(2, 160))
    tl, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", cache=tm.init_cache(2, 160,
                                                            device="cpu"))
    _assert_logits(tl, jl)
    nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]
    for i in range(4):
        pos = np.full((2,), 140 + i)
        pools = [_bridge(jc)] + ([tc] if i == 0 else [])
        jl, jc = jm.forward(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                            mode="decode", cache=jc, pos=jnp.asarray(pos))
        for pool in pools:
            tl, new = tm.forward(tp, {"tokens": torch.from_numpy(nxt)},
                                 mode="decode", cache=pool,
                                 pos=torch.from_numpy(pos))
            assert new is pool    # the new state went into the pool
            _assert_logits(tl, jl)
            assert np.array_equal(tl.numpy()[:, -1, :VOCAB].argmax(-1),
                                  _f32(jl)[:, -1, :VOCAB].argmax(-1))
        for key, leaf in (("block0", "mstate"), ("block1", "sstate")):
            for name, want in jc["segments"][key][leaf].items():
                g = pools[0]["segments"][key][leaf][name].float().numpy()
                w = _f32(want)
                assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)
        nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]
    # padding ids carry the large negative logit
    assert float(tl[..., VOCAB:].max()) < -1e8


def _assert_logits(got, want):
    g, w = got.numpy()[..., :VOCAB], _f32(want)[..., :VOCAB]
    assert g.shape == w.shape
    assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)


def test_bridge_round_trip_of_the_segments_tree(setup):
    """The reference's decoder pytree crosses with its stacked
    (n_segments, ...) axis, ``embed``, ``final_norm`` and ``lm_head``,
    and back, bit for bit; the port's own init has the same tree."""
    _, tm, jp, tp = setup
    assert set(tp) == {"embed", "segments", "final_norm", "lm_head"}
    assert tp["segments"]["block1"]["slstm"]["i"]["r"].shape == (2, 4, 32, 32)
    assert tp["segments"]["block0"]["mlstm"]["wq"].shape == (2, 256, 256)
    assert tp["lm_head"].shape == (128, 2048)
    back = params_to_numpy(tp)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert np.asarray(a).dtype == b.dtype, path
        assert np.array_equal(np.asarray(a), b), path
    mine = tm.init_values(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(params_to_numpy(mine)) \
        == jax.tree.structure(back)
    assert all(np.shape(a) == np.shape(b) for a, b in zip(
        jax.tree.leaves(params_to_numpy(mine)), jax.tree.leaves(back)))


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-tiny-en"])
def test_state_spec_and_lane_bytes_match_reference(arch):
    """The lane state spec the engine drives off, and the per-lane
    footprint by kind, equal the reference's at full width and reduced."""
    for shrink, t_shrink in ((lambda c: c, lambda c: c), (reduced, t_reduced)):
        jm = j_build(shrink(get_config(arch)))
        tm = build(t_shrink(t_get_config(arch)))
        js, ts = jm.state_spec(), tm.state_spec()
        for f in ("family", "self_kv", "cross_kv", "recurrent",
                  "moe_experts", "moe_top_k", "prefill_exact",
                  "quant_tiers"):
            assert getattr(ts, f) == getattr(js, f), (arch, f)
        for max_len in (64, 320):
            assert tm.lane_state_bytes(max_len) \
                == jm.lane_state_bytes(max_len), (arch, max_len)


# ----------------------------------------------------------------------------
# Serving
# ----------------------------------------------------------------------------

PROMPTS = [list(range(3, 8)), list(range(10, 150)), [9, 8, 7, 6]]


def _assert_greedy_matches(jm, jp, prompt, got, want):
    """``got`` (port) equals ``want`` (JAX) up to the first divergence,
    where the port's pick must be within TIE_MARGIN of the reference
    argmax on the reference's full forward of the shared prefix."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        seq = list(prompt) + list(want[:i])
        logits, _ = jm.forward(jp, {"tokens": jnp.asarray([seq])},
                               mode="train")
        lg = _f32(logits)[0, -1, :VOCAB]
        assert float(lg[w] - lg[g]) < TIE_MARGIN, (i, g, w)
        return


def _serve(tm, tp, prompts, max_new=6, eos=-1, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", 160)
    kw.setdefault("decode_block", 4)
    eng = ServeEngine(tm, tp, device="cpu", **kw)
    sts = [eng.admit(Request(uid=i, tokens=list(p), max_new=max_new,
                             eos_id=eos)) for i, p in enumerate(prompts)]
    while eng.n_active:
        eng.step()
    return eng, sts


def test_engine_tokens_match_reference_engine(setup):
    """3 slots, 4 decode steps a tick, prompts of 5, 140 and 4 ids: the
    port's tokens equal the reference ``ServeEngine``'s (near-tie flips
    only), and the cache accounting splits KV from recurrent bytes as
    the reference does."""
    jm, tm, jp, tp = setup
    kw = dict(n_slots=3, max_len=160, decode_block=4)
    jeng = JServeEngine(jm, jp, **kw)
    jsts = [jeng.admit(JRequest(uid=i, tokens=p, max_new=6, eos_id=-1))
            for i, p in enumerate(PROMPTS)]
    while jeng.n_active:
        jeng.step()
    eng, sts = _serve(tm, tp, PROMPTS, **kw)
    for p, st, jst in zip(PROMPTS, sts, jsts):
        assert len(st.out) == 6
        _assert_greedy_matches(jm, jp, p, st.out, jst.out)
    got, want = eng.cache_report(), jeng.cache_report()
    for k in ("state_bytes_total", "state_bytes_per_step", "kv_bytes_total",
              "bytes_per_step", "state_kinds", "family"):
        assert got[k] == want[k], k
    assert got["state_bytes_total"] > 0 and got["kv_bytes_total"] == 0
    assert eng.lanestate.drained
    lane = tm.lane_state_bytes(160)
    assert lane == {"kv": 0, "state": got["state_bytes_total"] // 3,
                    "total": got["state_bytes_total"] // 3}


def test_fused_tick_equals_single_steps_with_one_fetch(setup):
    """A 4-step tick is token-identical to 4 single steps, with one host
    fetch a tick; recurrent lanes prefill at the exact prompt length."""
    _, tm, _, tp = setup
    outs = {}
    for block in (4, 1):
        eng, sts = _serve(tm, tp, PROMPTS, max_new=9, decode_block=block)
        assert eng._host_syncs == eng._ticks == 8 // block
        assert eng._decode_steps == 8
        outs[block] = [st.out for st in sts]
    assert outs[4] == outs[1] and all(len(o) == 9 for o in outs[4])


def test_lanes_drain_after_abort_and_eos_mid_block(setup):
    """EOS inside a 4-step tick ends that lane mid-block and an abort
    frees an in-flight lane: the lane-state ledger drains either way."""
    _, tm, _, tp = setup
    _, sts = _serve(tm, tp, PROMPTS[:1], max_new=8)
    eos = sts[0].out[2]                    # its third token, mid-block
    first = sts[0].out.index(eos)
    eng = ServeEngine(tm, tp, n_slots=3, max_len=160, decode_block=4,
                      device="cpu")
    st = eng.admit(Request(uid=0, tokens=PROMPTS[0], max_new=8,
                           eos_id=eos))
    other = eng.admit(Request(uid=1, tokens=PROMPTS[2], max_new=8,
                              eos_id=-1))
    assert eng.lanestate.n_live == 2
    eng.step()
    assert st.done and st.out == sts[0].out[:first + 1]
    eng.abort(other)
    assert other.error_code == RejectCode.CANCELLED
    assert eng.n_active == 0 and eng.lanestate.drained
    eng.lanestate.check()


def test_scheduler_serves_xlstm_with_churn_and_a_queued_cancel(setup):
    """5 token requests through 2 slots, one cancelled while queued: the
    scheduler drains, 4 complete with their tokens, the ledger empties."""
    _, tm, _, tp = setup
    eng = ServeEngine(tm, tp, n_slots=2, max_len=64, decode_block=2,
                      device="cpu")
    sched = BatchScheduler(eng)
    for i in range(5):
        sched.submit(Request(uid=i, tokens=PROMPTS[2 * (i % 2)],
                             max_new=3, eos_id=-1))
    assert sched.abort(3) is not None
    sched.run_until_drained(max_ticks=200)
    assert sched.drained and eng.lanestate.drained
    assert sched.metrics.completed == 4
    assert sched.results[3].error_code == RejectCode.CANCELLED
    assert all(len(sched.results[i].out) == 3 for i in (0, 1, 2, 4))


def test_engine_refuses_quant_tiers_spec_and_encoder_input(setup):
    """Pure-recurrent lanes have no KV plane to quantize and no self-KV
    cursor to rewind, as the reference refuses; a token request that
    carries encoder input is rejected."""
    _, tm, _, tp = setup
    for tier in ("q8_0", "q4_0"):
        with pytest.raises(ValueError, match="recurrent"):
            ServeEngine(tm, tp, device="cpu", cache_dtype=tier)
    with pytest.raises(ValueError, match="rewinds"):
        ServeEngine(tm, tp, device="cpu", decode_block=4, spec_k=4)
    eng = ServeEngine(tm, tp, n_slots=1, max_len=32, device="cpu")
    for kw in ({"enc_frames": np.zeros((4, 128), np.float32)},
               {"enc_states": np.zeros((4, 128), np.float32)}):
        rej = eng.validate(Request(uid=0, tokens=[3], max_new=4, **kw))
        assert rej.code == RejectCode.ENC_ON_DECODER_ONLY
    assert eng.validate(Request(uid=0, tokens=[3] * 30,
                                max_new=4)).code == RejectCode.TOO_LONG
    assert eng.validate(Request(uid=0, tokens=[3], max_new=4)) is None


def test_serve_cli_completes_every_request(capsys):
    """``launch/serve.py --arch xlstm-350m --reduced --device cpu`` serves
    all its requests; ``--q8`` on an xLSTM arch stops with a message."""
    m = serve_cli.main(["--arch", "xlstm-350m", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2",
                        "--max-len", "64", "--max-new", "4",
                        "--decode-block", "2", "--platform", "h100-sxm"])
    assert m.completed == 3 and m.tokens == 12
    out = capsys.readouterr().out
    assert "3/3 requests" in out and "energy[h100-sxm]" in out
    with pytest.raises(SystemExit, match="Q8_0"):
        serve_cli.main(["--arch", "xlstm-350m", "--reduced", "--device",
                        "cpu", "--q8"])
