"""The port's dense decoder-only families against the JAX package, on the
CPU, at the reduced configurations (d_model 128, heads of 32, d_ff 256,
vocab 512) with the reference's parameters carried across by the bridge.

Rotary positions, the attention block (QKV biases: codeqwen1.5-7b;
qk-norm and GQA: qwen3-4b; local/global layers and softcaps: gemma2-2b;
a sliding window: mixtral-8x7b; MHA: deepseek-7b) in train, prefill and
decode over the cache tiers each model's spec allows, ``Model.forward``,
llava's patch-prefix forward, and the serving engine's battery (the
reference's ``tests/test_engine_conformance.py``) for qwen3-4b and
gemma2-2b. The JAX side runs as its own CPU tests run it: its dispatch
picks the XLA bindings of its kernels. The port's plain flash attention
keeps P in f32 where the reference's XLA path rounds it to bf16, so an
attention output differs by up to ~0.3 % of its largest value (measured)
and the logits of a 2-4-layer model by ~1 % in relative norm (measured
0.7-1.3 %); each tolerance below is stated with its measurement.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import attention as ja
from repro.models.layers import rope as j_rope
from repro.models.model import build as j_build
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import layer_slice, rope as t_rope
from repro_torch.models.model import build
from repro_torch.quantize import Q8Tensor
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.scheduler import BatchScheduler

VOCAB = 512
TIE_MARGIN = 0.15   # tests/test_serving.py's bf16 margin
DENSE = ("qwen3-4b", "gemma2-2b", "mixtral-8x7b", "deepseek-7b",
         "codeqwen1.5-7b")
_SETUP: dict = {}


def _setup(arch, **replace):
    """(reference model, port model, reference params, bridged params)
    of the reduced ``arch`` (with ``replace`` applied to both configs)."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _SETUP:
        cfg = dataclasses.replace(reduced(get_config(arch)), **replace)
        tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **replace)
        jm, tm = j_build(cfg), build(tcfg)
        jp = jm.init_values(jax.random.key(1))
        _SETUP[key] = (jm, tm, jp, _bridge(jp))
    return _SETUP[key]


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return tensor_from_numpy(np.asarray(x))


def _max_rel(got, want) -> float:
    g, w = got.float().numpy(), _f32(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


# ----------------------------------------------------------------------------
# Rotary positions
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6, 5e6])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rope_matches_jax(theta, dtype):
    """Positions up to 511 at head_dim 128. bf16: bit for bit (the f32
    rotation, rounded once, as jax rounds it). f32: within 1e-5 of the
    largest value (measured 4.4e-6 at theta 1e6: the two libraries'
    cos / sin / pow differ in the last bits)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 7, 3, 128)), dtype)
    pos = rng.integers(0, 512, size=(2, 7))
    want = _f32(j_rope(x, jnp.asarray(pos), theta))
    got = t_rope(_t(x), torch.from_numpy(pos), theta)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    if dtype == "bfloat16":
        assert np.array_equal(got.float().numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ----------------------------------------------------------------------------
# The attention block
# ----------------------------------------------------------------------------

def _block_cases():
    out = []
    for arch in DENSE:
        spec = build(t_reduced(t_get_config(arch))).state_spec()
        kinds = ("local", "global") if arch == "gemma2-2b" else ("global",)
        for kind in kinds:
            for tier in ("bf16",) + spec.quant_tiers:
                out.append((arch, kind, tier))
    return out


@pytest.mark.parametrize("arch,kind,tier", _block_cases(),
                         ids=["|".join(c) for c in _block_cases()])
def test_attention_block_matches_reference(arch, kind, tier):
    """Layer 0's attention over 80 positions (past mixtral's window of 64
    and gemma2's local window of 32) in train and prefill, then one decode
    step of 2 lanes at positions 80 and 57 from the reference's own
    cache, carried across (q8_0 / q4_0: quantized as the reference
    quantizes it). Outputs within 1 % of their largest value (measured
    <= 0.4 %: flash's P in f32 against bf16); the prefill cache and the
    decode step's written K/V rows within one bf16 rounding of each value
    plus 2^-8 of the largest (a bf16 product that rounds apart moves a
    value by one ulp), or for a quantized tier at most one code step."""
    jm, tm, jp, tp = _setup(arch)
    cfg, tcfg = jm.cfg, tm.cfg
    jpa = jax.tree.map(lambda a: a[0], jp["segments"]["block0"]["attn"])
    tpa = layer_slice(tp["segments"]["block0"]["attn"], 0)
    if kind == "global" and arch == "gemma2-2b":
        jpa = jax.tree.map(lambda a: a[0], jp["segments"]["block1"]["attn"])
        tpa = layer_slice(tp["segments"]["block1"]["attn"], 0)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 80, 128)), jnp.bfloat16)
    yj, _ = ja.attention(jpa, x, cfg, kind=kind, mode="train")
    yt, _ = ta.attention(tpa, _t(x), tcfg, kind=kind, mode="train",
                         use_rope=True)
    assert _max_rel(yt, yj) <= 1e-2
    yj, cj = ja.attention(jpa, x, cfg, kind=kind, mode="prefill",
                          cache=ja.init_kv_cache(cfg, 2, 96))
    yt, ct = ta.attention(tpa, _t(x), tcfg, kind=kind, mode="prefill",
                          cache=ta.init_kv_cache(tcfg, 2, 96), use_rope=True)
    assert _max_rel(yt, yj) <= 1e-2
    for key in ("k", "v"):
        g, w = ct[key].float().numpy(), _f32(cj[key])
        assert np.all(np.abs(g - w) <= 2 ** -8 * (np.abs(w)
                                                  + np.abs(w).max())), key

    # decode from the reference's cache, stacked as the engine stacks it
    stacked = {k: v[None] for k, v in cj.items()}
    if tier != "bf16":
        stacked = ja.quantize_kv_cache(stacked, tier)
    pos = np.array([80, 57])
    x1 = jnp.asarray(rng.standard_normal((2, 1, 128)), jnp.bfloat16)
    yj, new_j = ja.attention(jpa, x1, cfg, kind=kind, mode="decode",
                             cache=stacked, pos=jnp.asarray(pos),
                             layer_idx=0)
    pool = _bridge(stacked)
    yt, new_t = ta.attention(tpa, _t(x1), tcfg, kind=kind, mode="decode",
                             cache=pool, pos=torch.from_numpy(pos),
                             layer_idx=0, use_rope=True)
    assert new_t is pool
    assert _max_rel(yt, yj) <= 1e-2
    lanes = np.arange(2)
    for key in pool:
        g = pool[key][0, lanes, pos].float().numpy()
        w = _f32(new_j[key])[0, lanes, pos]
        if pool[key].dtype in (torch.int8, torch.uint8):
            if pool[key].dtype == torch.uint8:   # two q4 codes a byte
                g = np.stack([g % 16, g // 16], -1)
                w = np.stack([w % 16, w // 16], -1)
            assert np.abs(g - w).max() <= 1, key
        else:
            assert np.all(np.abs(g - w) <= 2 ** -8 * (np.abs(w)
                                                      + np.abs(w).max())), key
        # nothing but the new rows was written
        rest = np.ones(pool[key].shape[2], bool)
        for b, p in zip(lanes, pos):
            assert np.array_equal(pool[key][0, b, p + 1:].float().numpy(),
                                  _f32(stacked[key])[0, b, p + 1:]), key


# ----------------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------------

def _assert_logits(got, want):
    g, w = got.numpy()[..., :VOCAB], _f32(want)[..., :VOCAB]
    assert g.shape == w.shape
    assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("arch", [a for a in DENSE
                                  if not get_config(a).n_experts])
def test_model_prefill_and_decode_match_reference(arch):
    """``Model.forward`` train and prefill of a 70-token prompt, then 3
    greedy decode steps, the first from the port's own prefill cache and
    each from the reference's cache carried across. Logits within 5 % in
    relative norm (measured 0.7-1.3 %; the xLSTM tests' bound), the same
    greedy tokens, and padding ids at the large negative logit. The MoE
    models (mixtral-8x7b among them) are held in
    ``tests/test_torch_moe.py``."""
    jm, tm, jp, tp = _setup(arch)
    toks = np.random.default_rng(3).integers(3, VOCAB, size=(2, 70))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tc is None
    _assert_logits(tl, jl)
    jl, jc = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        mode="prefill", cache=jm.init_cache(2, 96))
    tl, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", cache=tm.init_cache(2, 96,
                                                            device="cpu"))
    _assert_logits(tl, jl)
    nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]
    for i in range(3):
        pos = np.full((2,), 70 + i)
        pools = [_bridge(jc)] + ([tc] if i == 0 else [])
        jl, jc = jm.forward(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                            mode="decode", cache=jc, pos=jnp.asarray(pos))
        for pool in pools:
            tl, new = tm.forward(tp, {"tokens": torch.from_numpy(nxt)},
                                 mode="decode", cache=pool,
                                 pos=torch.from_numpy(pos))
            assert new is pool
            _assert_logits(tl, jl)
            assert np.array_equal(tl.numpy()[:, -1, :VOCAB].argmax(-1),
                                  _f32(jl)[:, -1, :VOCAB].argmax(-1))
        nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]
    assert float(tl[..., VOCAB:].max()) < -1e8


def test_llava_prefix_embed_forward_matches_reference():
    """The VLM patch stub: 16 patch embeddings put before 24 tokens, the
    logits over all 40 positions within the 5 % of the dense models
    (measured ~1 %); in decode the prefix is ignored, as the reference
    ignores it."""
    jm, tm, jp, tp = _setup("llava-next-34b")
    rng = np.random.default_rng(4)
    toks = rng.integers(3, VOCAB, size=(2, 24))
    img = jnp.asarray(rng.standard_normal((2, 16, 128)), jnp.bfloat16)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                            "img_embed": img})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks),
                            "img_embed": _t(img)})
    assert tl.shape == (2, 40, 2048)
    _assert_logits(tl, jl)
    assert tm.state_spec().self_kv and tm.cfg.family == "vlm"


@pytest.mark.parametrize("arch", DENSE + ("qwen3-moe-30b-a3b",
                                          "llava-next-34b"))
def test_state_spec_and_lane_bytes_match_reference(arch):
    """The lane state spec the engine drives off, and the per-lane
    footprint by kind, equal the reference's at full width and reduced."""
    for shrink, t_shrink in ((lambda c: c, lambda c: c),
                             (reduced, t_reduced)):
        jm = j_build(shrink(get_config(arch)))
        tm = build(t_shrink(t_get_config(arch)))
        js, ts = jm.state_spec(), tm.state_spec()
        for f in ("family", "self_kv", "cross_kv", "recurrent",
                  "moe_experts", "moe_top_k", "prefill_exact",
                  "quant_tiers"):
            assert getattr(ts, f) == getattr(js, f), (arch, f)
        for max_len in (64, 320):
            for dt in ("q8_0", "bf16"):
                if dt == "q8_0" and not ts.quant_tiers:
                    continue
                jdt = dt if dt == "q8_0" else jnp.bfloat16
                tdt = dt if dt == "q8_0" else torch.bfloat16
                assert tm.lane_state_bytes(max_len, dtype=tdt) \
                    == jm.lane_state_bytes(max_len, dtype=jdt), \
                    (arch, max_len, dt)


def test_zamba2_is_refused_naming_the_rest_of_item_14():
    """zamba2-7b's config is data; its mamba blocks and hybrid pattern are
    not ported, and every entry point says so."""
    cfg = t_get_config("zamba2-7b")
    assert cfg.attn_every == 6 and cfg.ssm_state == 64
    m = build(t_reduced(cfg))
    for call in (m.state_spec, lambda: m.init_cache(1, 8, device="meta"),
                 lambda: tf_mod.segment_pattern(cfg)):
        with pytest.raises(NotImplementedError,
                           match="item 14 \\(mamba and the zamba2 hybrid\\)"):
            call()


def test_quantize_takes_the_reference_leaves_and_keeps_qkv_float():
    """``Model.quantize`` at the reduced qwen3-4b quantizes exactly the
    leaves the reference's ``quantize_tree`` does (its Q/K/V projections
    have 4 and 2 heads, which it leaves float); the predicate keeps the
    Q/K/V projections, norms and the MoE router and experts float at any
    width (the reference would block a 32-head wq along its heads)."""
    from repro.core.quantize import quantize_tree as j_quantize_tree
    jm, tm, jp, tp = _setup("qwen3-4b")
    jq = jax.eval_shape(j_quantize_tree, jp)      # shapes only
    tq = tm.quantize(tp)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: hasattr(x, "scale"))[0]
    want = {"/".join(str(getattr(k, "key", k)) for k in path)
            for path, leaf in flat_j if hasattr(leaf, "scale")}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, path + (k,))
        elif isinstance(tree, Q8Tensor):
            yield "/".join(path)
    assert set(walk(tq)) == want
    leaf = torch.zeros(1)
    for path in (("segments", "block0", "attn", "wq"),
                 ("segments", "block0", "attn", "q_norm"),
                 ("segments", "block0", "ln1"),
                 ("segments", "block0", "moe", "router"),
                 ("segments", "block0", "moe", "gate")):
        assert not tf_mod.quantizable(path, leaf), path
    for path in (("segments", "block0", "attn", "wo"),
                 ("segments", "block0", "mlp", "gate"),
                 ("embed", "table"), ("lm_head",)):
        assert tf_mod.quantizable(path, leaf), path


# ----------------------------------------------------------------------------
# The serving engine (the reference's tests/test_engine_conformance.py)
# ----------------------------------------------------------------------------

PROMPTS = ([5, 6, 7], [9, 10, 11, 12])
MAX_NEW = 6


def _request(uid, tokens, max_new=MAX_NEW, eos=-2):
    return Request(uid=uid, tokens=list(tokens), max_new=max_new,
                   eos_id=eos)


def _engine(tm, tp, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("decode_block", 4)
    return ServeEngine(tm, tp, device="cpu", **kw)


def _drain(eng):
    while eng.n_active:
        eng.step()


def assert_matches_ref(jm, jp, prompt, got, margin=TIE_MARGIN):
    """Engine tokens equal the reference's slot-free greedy full forward,
    except that the first divergence must be a near-tie (the reference's
    logit of the engine's pick within ``margin`` of its argmax); the
    comparison stops there. One causal forward over the prompt and the
    engine's tokens gives the reference's logits at every step up to the
    first divergence, where its greedy loop would have fed the same
    tokens."""
    seq = list(prompt) + list(got)
    lg, _ = jm.forward(jp, {"tokens": jnp.asarray([seq])})
    lg = _f32(lg)[0]
    for i, tok in enumerate(got):
        row = lg[len(prompt) + i - 1]
        want = int(row.argmax())
        if tok != want:
            gap = float(row[want] - row[tok])
            assert gap < margin, (i, tok, want, gap)
            return


def conformance_battery(jm, jp, tm, tp, cache_dtype):
    """The reference's ``test_conformance_battery`` on the port's engine:
    admit -> bucketed prefill -> fused ticks -> drain, tokens against the
    reference's full forward, one host sync a tick, the fused tick equal
    to single steps, EOS mid-block, abort and reuse of the freed slot,
    the lane-state ledger drained, spec-consistent accounting. Returns
    the first engine."""
    eng = _engine(tm, tp, cache_dtype=cache_dtype)
    sts = [eng.admit(_request(i, p)) for i, p in enumerate(PROMPTS)]
    assert all(eng.lanestate.holds(st.slot) for st in sts)
    _drain(eng)
    assert eng.lanestate.drained and not eng.active
    assert eng._host_syncs == eng._ticks
    full = [list(st.out) for st in sts]
    assert all(len(o) == MAX_NEW for o in full)
    for st, p in zip(sts, PROMPTS):
        assert_matches_ref(jm, jp, p, st.out)

    seq = _engine(tm, tp, cache_dtype=cache_dtype)
    sts_seq = [seq.admit(_request(i, p)) for i, p in enumerate(PROMPTS)]
    while seq.n_active:
        seq.step(1)
    assert [st.out for st in sts_seq] == full
    assert eng._decode_steps == eng.decode_block * eng._ticks
    assert eng._ticks < seq._ticks

    eos = full[0][2]
    want = full[0][:full[0].index(eos) + 1]
    st = eng.admit(_request(7, PROMPTS[0], eos=eos))
    _drain(eng)
    assert st.out == want and st.out[-1] == eos
    assert eng.lanestate.drained

    sts = [eng.admit(_request(10 + i, p)) for i, p in enumerate(PROMPTS)]
    eng.step()
    victim, survivor = sts
    slot = victim.slot
    eng.abort(victim)
    assert not eng.lanestate.holds(slot) and slot in eng.free
    assert victim.done and not eng.lanestate.drained
    st3 = eng.admit(_request(12, PROMPTS[0]))
    assert st3.slot == slot
    _drain(eng)
    assert st3.out == full[0]
    assert len(survivor.out) == MAX_NEW
    assert eng.lanestate.drained and eng._host_syncs == eng._ticks

    rep = eng.cache_report()
    assert rep["family"] == eng.spec.family
    assert rep["state_kinds"] == list(eng.spec.state_kinds)
    assert rep["kv_bytes_total"] > 0 and rep["bytes_per_step"] > 0
    return eng


@pytest.mark.parametrize("arch,cache_dtype", [("qwen3-4b", "bf16"),
                                              ("qwen3-4b", "q8_0"),
                                              ("gemma2-2b", "bf16")])
def test_conformance_battery(arch, cache_dtype):
    jm, tm, jp, tp = _setup(arch)
    conformance_battery(jm, jp, tm, tp, cache_dtype)


def test_engine_tokens_match_reference_engine():
    """The port's engine and the reference's on the same requests
    (prompts of 3, 4 and 40 ids, 3 slots, 4 steps a tick, bf16 and q4_0
    caches; q8_0 is the battery's): the same tokens up to their first
    difference, where the
    two picks must be a near-tie of the port's own logits row (within
    ``TIE_MARGIN``), and the same cache accounting. (The q4_0 tier is
    held here, against the reference's q4_0 engine, and not in the
    battery, whose full-forward oracle has no cache to quantize: a q4_0
    code step moves a logit past its bf16 margin.)"""
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServeEngine as JServeEngine
    jm, tm, jp, tp = _setup("qwen3-4b")
    prompts = list(PROMPTS) + [list(range(3, 43))]
    for cache_dtype in ("bf16", "q4_0"):
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
                  "self_kv_bytes_per_token", "state_kinds", "family",
                  "traffic_ratio_vs_bf16"):
            assert got[k] == want[k], (cache_dtype, k)


def test_scheduler_serves_dense_family():
    """5 requests through 2 slots with a queued cancel (the reference's
    ``test_scheduler_serves_family``), on gemma2-2b."""
    _, tm, _, tp = _setup("gemma2-2b")
    eng = _engine(tm, tp, n_slots=2)
    sched = BatchScheduler(eng)
    for i in range(5):
        sched.submit(_request(i, PROMPTS[i % 2], max_new=3))
    assert sched.abort(3) is not None
    sched.run_until_drained(max_ticks=200)
    assert sched.drained and eng.lanestate.drained
    assert sched.metrics.completed == 4
    assert all(len(sched.results[i].out) == 3 for i in (0, 1, 2, 4))


def test_spec_k4_matches_the_plain_serve():
    """qwen3-4b with ``spec_k=4`` (a Q4_0 draft of the float params, 3
    draft steps and one verify a round) against the plain engine on the
    same requests: the same tokens, one host sync a tick, the reference's
    round accounting."""
    _, tm, _, tp = _setup("qwen3-4b")
    prompts = [[5, 6, 7, 8], [9, 10, 11], [3, 4, 5, 6, 7]]
    outs = {}
    for k in (0, 4):
        eng = _engine(tm, tp, n_slots=4, spec_k=k)
        sts = [eng.admit(_request(i, p, max_new=10)) for i, p in
               enumerate(prompts)]
        _drain(eng)
        outs[k] = [st.out for st in sts]
        assert eng._host_syncs == eng._ticks and eng.lanestate.drained
    assert outs[4] == outs[0]
    assert eng._verify_steps == eng._spec_rounds == eng._ticks
    assert eng._draft_steps == 3 * eng._spec_rounds
    assert 0.0 <= eng.acceptance_rate <= 1.0


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x7b"])
def test_refusals_follow_the_reference(arch):
    """gemma2-2b (softcap, local/global) and mixtral-8x7b (a sliding
    window) hold a bf16 cache only, and refuse speculative decoding, as
    the reference's engine refuses them."""
    _, tm, _, tp = _setup(arch)
    for tier in ("q8_0", "q4_0"):
        with pytest.raises(ValueError, match="cannot hold"):
            _engine(tm, tp, cache_dtype=tier)
    with pytest.raises(ValueError, match="MoE|softcap/windowed"):
        _engine(tm, tp, spec_k=4)
    with pytest.raises(ValueError, match="enc-dec"):
        _engine(tm, tp, paged=True)


def test_serve_cli_on_the_cpu(capsys):
    """``repro_torch.launch.serve --arch qwen3-4b --reduced --device cpu``
    with Q8_0 weights and the q8_0 cache serves every request."""
    m = serve_cli.main(["--arch", "qwen3-4b", "--reduced", "--device",
                        "cpu", "--requests", "3", "--slots", "2",
                        "--max-len", "64", "--max-new", "4",
                        "--decode-block", "4", "--q8", "--cache-dtype",
                        "q8_0", "--platform", "h100-sxm"])
    out = capsys.readouterr().out
    assert m.completed == 3
    assert "Q8_0-quantized weights" in out and "energy[h100-sxm]" in out
