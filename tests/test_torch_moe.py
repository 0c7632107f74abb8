"""The port's MoE FFN and MoE models against the JAX package, on the CPU,
at the reduced qwen3-moe-30b-a3b and mixtral-8x7b (4 experts, top 2,
d_model 128, expert d_ff 256) with the reference's parameters carried
across by the bridge.

Capacity routing is discontinuous: a token whose router probabilities
sit within f32 rounding of a tie can go to another expert in the two
packages (their f32 router products sum in another order), and at a
binding capacity the token an expert drops can change with it. So the
FFN is held to the reference on inputs whose routing both packages
agree on (checked: the same top-k experts and the same counters), and
the models position by position, each position that leaves the bound
traced to a router that picks other experts in the two packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import moe as jmoe
from repro.models.layers import KeyGen, split_params
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build
from repro_torch.serving.engine import ServeEngine

from test_torch_dense import (PROMPTS, _drain, _engine, _request, _setup,
                              conformance_battery)

VOCAB = 512
MOE = ("qwen3-moe-30b-a3b", "mixtral-8x7b")


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return tensor_from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def ffn():
    """The reduced qwen3-moe config (capacity factor 1.25: binding) and
    one MoE layer's parameters, the reference's and bridged."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    tcfg = t_reduced(t_get_config("qwen3-moe-30b-a3b"))
    assert (tcfg.n_experts, tcfg.top_k, tcfg.capacity_factor) == (4, 2, 1.25)
    p, _ = split_params(jmoe.init_moe(KeyGen(jax.random.key(0)), cfg))
    return cfg, tcfg, p, _bridge(p)


def _padded_input():
    """The reference's ``test_moe_prefill_padding_mask`` input: 4 live
    tokens (key 20) and 28 positions of adversarial padding, amplified
    copies of a live token that route hard into its experts."""
    xl = jax.random.normal(jax.random.key(20), (1, 4, 128), jnp.float32) * 0.5
    pad = jnp.tile(xl[:, :1] * 6.0, (1, 28, 1))
    return xl, jnp.concatenate([xl, pad], axis=1)


def _same_routing(cfg, p, x):
    """Whether the two packages' routers pick the same top-k experts for
    every token of x (the precondition of an output comparison)."""
    logits = _f32(x).astype(np.float64) @ _f32(p["router"]).astype(np.float64)
    srt = np.sort(logits, axis=-1)
    # the k-th and (k+1)-th logits apart by more than f32 rounding
    gap = srt[..., -cfg.top_k] - srt[..., -cfg.top_k - 1]
    return bool((gap > 1e-4 * np.abs(logits).max()).all())


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_matches_reference_at_binding_capacity(ffn, grouped,
                                                       masked):
    """Grouped (per batch row) and global (over the batch) dispatch at the
    config's binding capacity (cf 1.25: some tokens are dropped), over 2
    rows of 24 random tokens, or the reference's padded bucket with
    ``valid_len`` 4: outputs within one bf16 rounding of each value plus
    2^-8 of the largest (the expert products round alike; the combine's
    f32 sums may round a last bit apart), and the routing counters the
    reference's exactly."""
    cfg, tcfg, p, tp = ffn
    if masked:
        x = _padded_input()[1]
        kw = dict(valid_len=4)
    else:
        x = jax.random.normal(jax.random.key(3), (2, 24, 128),
                              jnp.float32).astype(jnp.bfloat16)
        kw = {}
    assert _same_routing(cfg, p, x)
    counts = jnp.zeros((x.shape[0], cfg.n_experts), jnp.int32)
    jy, jc = jmoe.moe_ffn(p, x, cfg, grouped=grouped, route_counts=counts,
                          **kw)
    ty, tc = tmoe.moe_ffn(tp, _t(x), tcfg, grouped=grouped,
                          route_counts=torch.zeros((x.shape[0], 4),
                                                   dtype=torch.int32), **kw)
    g, w = ty.float().numpy(), _f32(jy)
    assert ty.dtype == (torch.bfloat16 if x.dtype == jnp.bfloat16
                        else torch.float32)
    assert np.all(np.abs(g - w) <= 2 ** -8 * (np.abs(w) + np.abs(w).max()))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int32


def test_bucket_padding_never_evicts_a_live_token(ffn):
    """The reference's ``test_moe_prefill_padding_mask`` on the port, with
    a drop-free oracle. Its premise, that the 4 live tokens alone fit
    the exact-length capacity (2 an expert), does not hold: 3 of them
    route to expert 3, so the exact-length pass drops one, in the
    reference and in the port alike (bit for bit), and that test fails
    in the reference's own suite. The oracle here is the reference's
    ``moe_ffn`` over the live tokens at a capacity that drops none. The
    port's masked bucket (capacity 20 an expert) gives the live tokens
    exactly that (within 1e-5, the reference test's bound); unmasked,
    the padding crowds them out (the mask is tested); the global
    dispatch honours the same mask (5e-3, its bound); and the port's
    masked and exact-length outputs equal the reference's bit for bit."""
    cfg, tcfg, p, tp = ffn
    xl, x = _padded_input()
    drop_free = _f32(jmoe.moe_ffn(
        p, xl, dataclasses.replace(cfg, capacity_factor=4.0)))
    masked = tmoe.moe_ffn(tp, _t(x), tcfg, valid_len=4)[:, :4].numpy()
    unmasked = tmoe.moe_ffn(tp, _t(x), tcfg)[:, :4].numpy()
    np.testing.assert_allclose(masked, drop_free, atol=1e-5)
    assert not np.allclose(unmasked, drop_free, atol=5e-2)
    g = tmoe.moe_ffn(tp, _t(x), tcfg, grouped=False, valid_len=4)[:, :4]
    np.testing.assert_allclose(g.numpy(), drop_free, atol=5e-3)
    assert np.array_equal(masked, _f32(jmoe.moe_ffn(p, x, cfg,
                                                    valid_len=4))[:, :4])
    assert np.array_equal(tmoe.moe_ffn(tp, _t(xl), tcfg).numpy(),
                          _f32(jmoe.moe_ffn(p, xl, cfg)))


def test_decode_step_reads_every_expert(ffn):
    """At S = 1 the capacity is 1, so each expert takes the lane's one
    token, weighted 0 where the router did not pick it: every expert's
    weights are read each step (the reference does the same; ROADMAP's
    speed work gathers only the routed experts). The output equals the
    reference's within one bf16 rounding; each lane counts top_k."""
    cfg, tcfg, p, tp = ffn
    x = jax.random.normal(jax.random.key(5), (4, 1, 128),
                          jnp.float32).astype(jnp.bfloat16)
    assert _same_routing(cfg, p, x)
    seen = []
    real = tmoe._experts

    def spy(pp, x_e, act):
        seen.append(tuple(x_e.shape))
        return real(pp, x_e, act)
    tmoe._experts = spy
    try:
        ty, tc = tmoe.moe_ffn(tp, _t(x), tcfg, route_counts=torch.zeros(
            (4, 4), dtype=torch.int32))
    finally:
        tmoe._experts = real
    assert seen == [(4, 4, 128)]      # (E, lanes x cap, d): all experts
    assert tc.sum(dim=1).tolist() == [2, 2, 2, 2]
    w = _f32(jmoe.moe_ffn(p, x, cfg))
    assert np.all(np.abs(ty.float().numpy() - w)
                  <= 2 ** -8 * (np.abs(w) + np.abs(w).max()))


def _one_hot_combine(sel_tok, y_e, top_i, first=0, n_experts=0):
    """The port's combine before the gather-sum, kept as the oracle: a
    one-hot ((b,) n, E * C) f32 product with the entries' f32 outputs."""
    n = top_i.shape[-2]
    flat = sel_tok.reshape(*sel_tok.shape[:-2], -1)
    onehot = (flat[..., None, :] == torch.arange(n)[:, None]).to(
        torch.float32)
    return torch.matmul(onehot, y_e.to(torch.float32))


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("experts,top_k", [(4, 2), (16, 8)])
def test_combine_equals_the_one_hot_product(monkeypatch, grouped, experts,
                                            top_k):
    """The gather-sum combine (each token's top_k entries added in f32 in
    ascending expert id), in one chunk and in chunks of ceil(n / k)
    tokens, equals the one-hot product it replaced bit for bit on the
    CPU, grouped and global, at 4 experts top 2 and 16 top 8,
    over 2 rows of 12 tokens and five seeds, with a bucket's padding
    (``valid_len``) on the last seed. At this size (at most 240 entries)
    the library sums the product's entries one after another; over more
    (a global top 8 product of 480 entries: 6 of 20 seeds differ in a
    last bit) it sums them in blocks, and the oracle itself
    reassociates."""
    cfg = dataclasses.replace(t_reduced(t_get_config("qwen3-moe-30b-a3b")),
                              n_experts=experts, top_k=top_k)
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        p = tmoe.init_moe(gen, cfg, "cpu")
        x = torch.randn((2, 12, cfg.d_model), generator=gen).to(
            torch.bfloat16)
        kw = dict(grouped=grouped, valid_len=9 if seed == 4 else None)
        got = tmoe.moe_ffn(p, x, cfg, **kw)
        with monkeypatch.context() as m:
            # chunks of ceil(n / k) tokens (at this size the default is
            # one chunk)
            m.setattr(tmoe, "COMBINE_ELEMS", 0)
            chunked = tmoe.moe_ffn(p, x, cfg, **kw)
        with monkeypatch.context() as m:
            m.setattr(tmoe, "_combine", _one_hot_combine)
            want = tmoe.moe_ffn(p, x, cfg, **kw)
        for out in (got, chunked):
            assert torch.equal(out, want), (seed, float(
                (out.float() - want.float()).abs().max()))


def test_combine_holds_nothing_of_tokens_by_entries():
    """A grouped prefill of 4096 tokens (reduced qwen3-moe-30b-a3b: 4
    experts, top 2, capacity 2560 an expert, 10240 entries) traced on
    fake tensors: no intermediate scales with tokens x entries (the
    one-hot's 4096 x 10240), the largest being the experts' activations
    (E, C, d_ff)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    cfg = t_reduced(t_get_config("qwen3-moe-30b-a3b"))
    s = 4096
    cap = int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts)
    entries = cfg.n_experts * cap
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            sizes.extend(t.numel() for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            return out

    with FakeTensorMode():
        p = tmoe.init_moe(torch.Generator(), cfg, "cpu")
        x = torch.empty((1, s, cfg.d_model), dtype=torch.bfloat16)
        with Sizes():
            out = tmoe.moe_ffn(p, x, cfg)
    assert out.shape == x.shape
    assert max(sizes) <= entries * max(cfg.d_ff, cfg.d_model), \
        (max(sizes), entries)
    assert max(sizes) * 16 <= s * entries, (max(sizes), s * entries)


# ----------------------------------------------------------------------------
# The MoE models
# ----------------------------------------------------------------------------

def _assert_counts_close(got, want):
    """Routing planes (layers, lanes, E): the same totals per layer and
    lane, and at most 5 % of the assignments on another expert."""
    g, w = got.numpy().astype(np.int64), np.asarray(want, np.int64)
    assert np.array_equal(g.sum(-1), w.sum(-1))
    assert np.abs(g - w).sum() <= 2 * 0.05 * w.sum()


def _per_position(got, want):
    g, w = got.numpy()[..., :VOCAB], _f32(want)[..., :VOCAB]
    return (np.linalg.norm(g - w, axis=-1)
            / np.linalg.norm(w, axis=-1)).ravel()


def _routes_at(model, params, toks, p, tensor):
    """The per-layer top-k experts of position ``p`` (every lane): the
    routing counters of a prefill of ``toks[:, :p + 1]`` less those of
    ``toks[:, :p]`` (a causal model whose capacity drops nothing routes a
    position the same in both)."""
    def counts(n):
        batch = {"tokens": tensor(toks[:, :n])}
        cache = model.init_cache(toks.shape[0], 96)
        _, c = model.forward(params, batch, mode="prefill", cache=cache)
        return np.asarray(c["segments"]["block0"]["routing"], np.int64)
    return counts(p + 1) - (counts(p) if p else 0)


@pytest.mark.parametrize("arch", MOE)
def test_moe_model_matches_reference_position_by_position(arch):
    """``Model.forward`` prefill of 2 x 70 tokens and 3 decode steps from
    the reference's cache carried across, with the capacity raised so
    that no token is dropped (the reference's conformance idiom; the
    binding capacity is held at the FFN above). A router whose top-k
    sits within rounding of a tie can send a token to other experts in
    the two packages (the attention's ~0.3 % difference moves hidden
    states), which changes that position and, through attention, the
    lane's later ones. So per lane: every position within 5 % in relative
    norm (the dense models' bound) up to the first one that is not, where
    a layer's router must pick other experts in the two packages (read
    from the prefill's routing counters); the decode steps of a lane with
    no such position within 5 %, and every decode step's routing counters
    the reference's totals and within 5 % of its counts."""
    jm, tm, jp, tp = _setup(arch, capacity_factor=4.0)
    toks = np.random.default_rng(3).integers(3, VOCAB, size=(2, 70))
    jl, jc = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        mode="prefill", cache=jm.init_cache(2, 96))
    tl, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", cache=tm.init_cache(2, 96,
                                                            device="cpu"))
    per = _per_position(tl, jl).reshape(2, 70)
    flipped = []
    for lane in range(2):
        off = np.nonzero(per[lane] > 5e-2)[0]
        if not len(off):
            continue
        flipped.append(lane)
        f = int(off[0])
        want = _routes_at(jm, jp, toks, f, lambda t: jnp.asarray(t,
                                                                 jnp.int32))
        got = _routes_at(tm, tp, toks, f, torch.from_numpy)
        assert not np.array_equal(got[:, lane], want[:, lane]), (lane, f)
    nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]
    for i in range(3):
        pos = np.full((2,), 70 + i)
        pool = _bridge(jc)
        jl, jc = jm.forward(jp, {"tokens": jnp.asarray(nxt, jnp.int32)},
                            mode="decode", cache=jc, pos=jnp.asarray(pos))
        tl, new = tm.forward(tp, {"tokens": torch.from_numpy(nxt)},
                             mode="decode", cache=pool,
                             pos=torch.from_numpy(pos))
        assert new is pool
        for name, blk in jc["segments"].items():
            _assert_counts_close(pool["segments"][name]["routing"],
                                 blk["routing"])
        step = _per_position(tl, jl)
        assert all(step[lane] <= 5e-2 for lane in range(2)
                   if lane not in flipped), step
        nxt = _f32(jl)[:, -1, :VOCAB].argmax(-1)[:, None]


@pytest.mark.parametrize("arch", MOE)
def test_prefill_routing_counters_match_the_reference(arch):
    """The prefill cache's routing planes at the binding capacity: every
    bucket position's top-k counted, per layer (padding included, as the
    reference counts it), the reference's totals, and its counts but for
    the tokens a router near-tie moves (at most 5 %; measured 1.6 %)."""
    jm, tm, jp, tp = _setup(arch)
    toks = np.random.default_rng(8).integers(3, VOCAB, size=(2, 32))
    _, jc = jm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                            "n_valid": 20},
                       mode="prefill", cache=jm.init_cache(2, 64))
    _, tc = tm.forward(tp, {"tokens": torch.from_numpy(toks),
                            "n_valid": 20},
                       mode="prefill", cache=tm.init_cache(2, 64,
                                                           device="cpu"))
    for name, blk in jc["segments"].items():
        got = tc["segments"][name]["routing"]
        assert int(got.sum()) == 2 * 32 * jm.cfg.top_k * got.shape[0]
        _assert_counts_close(got, blk["routing"])


# ----------------------------------------------------------------------------
# The serving engine
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("cache_dtype", ["bf16", "q8_0"])
def test_moe_conformance_battery(cache_dtype):
    """The reference's battery for qwen3-moe-30b-a3b, with its capacity
    raised so that no token is dropped (as the reference's battery raises
    it: a slot-free full forward recomputing the sequence makes other
    capacity cuts than the engine's incremental path)."""
    arch = "qwen3-moe-30b-a3b"
    jm, tm, jp, tp = _setup(arch, capacity_factor=4.0)
    conformance_battery(jm, jp, tm, tp, cache_dtype)


def test_moe_routing_counters_reconcile():
    """The reference's ``test_moe_routing_counters_reconcile``: the
    counters count executed top-k assignments exactly, every prefill's
    whole bucket and every slot of every decode step, per MoE layer; the
    report is fetched off the tick, and the ledger drains."""
    from repro_torch.serving.engine import _bucket
    jm, tm, jp, tp = _setup("qwen3-moe-30b-a3b", capacity_factor=4.0)
    eng = _engine(tm, tp)
    sts = [eng.admit(_request(i, p)) for i, p in enumerate(PROMPTS)]
    _drain(eng)
    syncs = eng._host_syncs
    rep = eng.routing_report()
    assert eng._host_syncs == syncs
    assert (rep["n_experts"], rep["top_k"], rep["moe_layers"]) == (4, 2, 2)
    prefill = sum(min(_bucket(len(p)), eng.max_len) for p in PROMPTS)
    want = (prefill + eng.n_slots * eng._decode_steps) \
        * rep["moe_layers"] * rep["top_k"]
    assert rep["executed_assignments"] == want
    per_lane = np.asarray(rep["per_lane"])
    assert per_lane.sum() == want and (per_lane >= 0).all()
    assert sum(rep["per_expert"]) == want
    assert all(len(st.out) == 6 for st in sts) and eng.lanestate.drained
    dense = ServeEngine(*_setup("qwen3-4b")[1::2], device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        dense.routing_report()


def test_moe_engine_matches_reference_engine():
    """The port's and the reference's engines on the same requests at the
    config's binding capacity: the tokens up to a near-tie of the port's
    own logits row, the same number of executed assignments, and the
    per-lane counts but for the tokens a router near-tie moves."""
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServeEngine as JServeEngine
    jm, tm, jp, tp = _setup("qwen3-moe-30b-a3b")
    kw = dict(n_slots=3, max_len=64, decode_block=4)
    jeng = JServeEngine(jm, jp, **kw)
    jsts = [jeng.admit(JRequest(uid=i, tokens=list(p), max_new=6,
                                eos_id=-1)) for i, p in enumerate(PROMPTS)]
    while jeng.n_active:
        jeng.step()
    eng = _engine(tm, tp, keep_logits=True, **kw)
    sts = [eng.admit(_request(i, p, eos=-1)) for i, p in enumerate(PROMPTS)]
    _drain(eng)
    for st, jst in zip(sts, jsts):
        diff = [i for i, (g, w) in enumerate(zip(st.out, jst.out)) if g != w]
        if diff:
            row = st.logits[diff[0]].float()
            assert float(row[st.out[diff[0]]] - row[jst.out[diff[0]]]) < 0.15
    got, want = eng.routing_report(), jeng.routing_report()
    assert got["executed_assignments"] == want["executed_assignments"]
    _assert_counts_close(torch.tensor(got["per_lane"])[None],
                         np.asarray(want["per_lane"])[None])


def test_spec_k_refused_for_moe():
    """The reference's refusal: speculative decoding does not thread the
    routing counters through draft and verify."""
    _, tm, _, tp = _setup("qwen3-moe-30b-a3b")
    with pytest.raises(ValueError, match="MoE"):
        _engine(tm, tp, spec_k=4)
    assert build(t_reduced(t_get_config("qwen3-moe-30b-a3b"))) \
        .state_spec().state_kinds == ("self_kv", "routing")
