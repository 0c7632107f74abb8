"""The port's paged KV (``repro_torch.paging``, ``ServeEngine(paged=True)``
and the ``paged_decode_attention`` op) against the JAX package's and
against the port's own slot pool.

The rig is the reference's ``tests/test_paging.py`` rig: whisper-tiny-en
cut to d_model 64, 2 heads, 1+1 layers, vocab 256, pages of 8 positions,
with the reference's ``jax.random.key(0)`` weights bridged into the
port. A paged lane reads the same values through its page table that a
slot lane reads from its row, and with ``n_lp * P`` equal to the slot
pool's lengths the decode runs the same shapes, so the port's paged
engine is held to its slot pool bit for bit (tokens and the kept logits
rows). Against the reference's paged engine the greedy tokens must
match up to a near-tie of the reference's own logits (the idiom of
``tests/test_torch_serving.py``). The paging state is held to
``repro.paging`` call for call.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.kernels.paged_attention import paged_decode_attention_ref
from repro.models.model import build as j_build
from repro.paging import PageAllocError as JPageAllocError
from repro.paging import PagedKV as JPagedKV
from repro.serving.engine import AudioRequest as JAudioRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, reduced
from repro_torch.kernels.api import dispatch, dispatch_counters, \
    reset_dispatch_log
from repro_torch.models import attention as attn_mod
from repro_torch.models.model import build
from repro_torch.paging import PageAllocError, PagedKV, PageTable
from repro_torch.quantize import quantize_q4_0, quantize_q8_0
from repro_torch.serving.engine import (AudioRequest, RejectCode,
                                        RejectionError, ServeEngine,
                                        StreamingAudioRequest)

P = 8
MAX_LEN = 64
ENC_LEN = 16
TIE_MARGIN = 0.15   # tests/test_serving.py's bf16 margin
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=2, d_ff=128, vocab=256,
             enc_layers=1, n_layers=1)
PROMPTS = [[5, 6, 7, 8], [9, 10, 11], [3, 4, 5, 6, 7, 8, 9, 10, 2]]


@pytest.fixture(scope="module")
def rig():
    jm = j_build(dataclasses.replace(
        j_reduced(j_get_config("whisper-tiny-en")), **SMALL))
    tm = build(dataclasses.replace(reduced(get_config("whisper-tiny-en")),
                                   **SMALL))
    jp = jm.init_values(jax.random.key(0))
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _frames(s, seed=7, scale=0.5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((s, 64)).astype(np.float32) * scale


def _engine(rig, paged, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("enc_len", ENC_LEN)
    return ServeEngine(rig[1], rig[3], device="cpu", keep_logits=True,
                       paged=paged, page_size=P, **kw)


def _drain(eng):
    while eng.n_active:
        eng.step()


def _oneshot(eng, max_new=6, eos=-2):
    sts = [eng.admit(AudioRequest(uid=i, tokens=list(p), max_new=max_new,
                                  eos_id=eos,
                                  enc_frames=_frames(6 + 2 * i, seed=i)))
           for i, p in enumerate(PROMPTS)]
    _drain(eng)
    return sts


def _bit_equal(got, want):
    """Request states of a paged run against the slot run's: the same
    tokens, and the same kept logits rows bit for bit."""
    for g, w in zip(got, want):
        assert g.out == w.out, (g.req.uid, g.out, w.out)
        assert len(g.logits) == len(w.logits) == len(g.out)
        for a, b in zip(g.logits, w.logits):
            assert torch.equal(a, b), g.req.uid


def _drained(eng):
    assert eng.pages.self_pool.used_pages == 0
    assert eng.pages.cross_pool.used_pages == 0
    assert eng.lanestate.drained and not eng.pages.lanes
    assert eng.pages.self_table.device().eq(0).all()
    eng.pages.check()


# ------------------------------------------------------- paging state
def _state(kv):
    """Everything a PagedKV holds, as plain Python."""
    lanes = {s: dataclasses.asdict(ln) for s, ln in kv.lanes.items()}
    return (lanes, kv.report(),
            [kv.self_table.row(s) for s in range(kv.n_slots)],
            [kv.cross_table.row(s) for s in range(kv.n_slots)],
            list(kv.self_pool._ref), list(kv.self_pool._free),
            list(kv.cross_pool._ref), list(kv.cross_pool._free))


def _call(kv, name, args, kwargs, copies):
    """Call ``kv.name``: (True, its result as plain Python) or (False,
    the PageAllocError's request and free count)."""
    if name == "ensure_writable":
        kwargs = dict(kwargs, copier=lambda a, b: copies.append((a, b)))
    try:
        out = getattr(kv, name)(*args, **kwargs)
    except (PageAllocError, JPageAllocError) as e:
        return False, (e.pool, e.requested, e.free)
    return True, dataclasses.asdict(out) \
        if dataclasses.is_dataclass(out) else out


def _random_call(rng, ref, kinds):
    """A random call that the lanes in ``kinds`` (slot -> "oneshot" |
    "stream") make legal: (name, args, kwargs), or None."""
    free = [s for s in range(ref.n_slots) if s not in kinds]
    streams = [s for s, k in kinds.items() if k == "stream"]
    ops = (["free_lane", "ensure_writable"] if kinds else []) \
        + (["admit_lane", "admit_stream_lane"] if free else []) \
        + (["extend_cross", "alloc_self"] if streams else [])
    op = ops[rng.integers(len(ops))]
    if op == "admit_lane":
        prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], list(range(3, 20)), [4, 5]]
        return op, (int(rng.choice(free)), prompts[rng.integers(3)],
                    ["a", "b"][rng.integers(2)]), dict(
            max_new=int(rng.integers(1, 12)),
            enc_s=int(rng.choice([0, 5, 16, 24])))
    if op == "admit_stream_lane":
        return op, (int(rng.choice(free)),), {}
    if op in ("extend_cross", "alloc_self"):
        slot = int(rng.choice(streams))
        lane = ref.lanes[slot]
        if op == "alloc_self":
            return None if lane.self_pages else (op, (
                slot, int(rng.integers(1, 9)), int(rng.integers(1, 12))), {})
        off = lane.cross_len
        return None if off >= ref.enc_len else (op, (
            slot, off, int(rng.integers(1, ref.enc_len + 1 - off))), {})
    slot = int(rng.choice(list(kinds)))
    if op == "free_lane":
        return op, (slot,), {}
    kind = ["self", "cross"][rng.integers(2)]
    pages = getattr(ref.lanes[slot], f"{kind}_pages")
    return None if not pages else (
        op, (slot, int(rng.integers(len(pages)))), dict(kind=kind))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_kv_in_lockstep_with_the_reference(seed):
    """A seeded random sequence of admissions, stream lanes, self
    allocations, cross extensions, copy-on-write and frees goes through
    both packages' ``PagedKV`` (pools small enough to run out): each call
    returns the same, or raises the same ``PageAllocError``; after it
    both hold the same page ids, table rows, refcounts, free lists, lane
    records and reports, ``check()`` passes, and the port's device
    tables equal their host mirrors."""
    rng = np.random.default_rng(seed)
    kw = dict(n_slots=4, max_len=32, enc_len=24, page_size=P, n_pages=10,
              n_cross_pages=7)
    ref, port = JPagedKV(**kw), PagedKV(**kw)
    kinds, raised, calls = {}, 0, 0
    while calls < 80:
        call = _random_call(rng, ref, kinds)
        if call is None:
            continue
        calls += 1
        op, args, kwargs = call
        copies = ([], [])
        want = _call(ref, op, args, kwargs, copies[0])
        got = _call(port, op, args, kwargs, copies[1])
        assert got == want and copies[0] == copies[1], (op, args)
        raised += not want[0]
        if op == "free_lane":
            kinds.pop(args[0])
        elif op in ("admit_lane", "admit_stream_lane") and want[0]:
            kinds[args[0]] = "oneshot" if op == "admit_lane" else "stream"
        assert _state(port) == _state(ref), (op, args)
        for t in (port.self_table, port.cross_table):
            assert t.device().tolist() == [t.row(s) for s in range(4)]
        ref.check()
        port.check()
    assert raised > 0           # the pools ran out at least once


def test_device_table_keeps_its_storage():
    """Every mapping change writes the one device tensor in place (a
    captured tick reads it by address), which always equals the host
    mirror."""
    t = PageTable(3, 32, P)
    dev = t.device()
    ptr = dev.data_ptr()
    t.set_row(1, [4, 5])
    t.extend_row(1, 2, [7])
    t.set_entry(2, 3, 9)
    t.clear_row(2)
    v = t.version
    t.set_row(0, [1, 2, 3, 6])
    assert t.version == v + 1
    assert t.device() is dev and dev.data_ptr() == ptr
    assert dev.tolist() == [t.row(s) for s in range(3)] \
        == [[1, 2, 3, 6], [4, 5, 7, 0], [0, 0, 0, 0]]
    assert t.lookup(1, 17) == (7, 1)


# ----------------------------------------------- the paged_decode op
def _pool(tier, n_pages, hkv, d, rng):
    x = torch.from_numpy(rng.standard_normal((n_pages, P, hkv, d))
                         .astype(np.float32)).to(torch.bfloat16)
    if tier == "bf16":
        return x
    if tier == "q8_0":
        t = quantize_q8_0(x, axis=-1)
        return {"q": t.q, "s": t.scale}
    t = quantize_q4_0(x, axis=-1)
    return {"p": t.q, "s": t.scale}


def _jnp(tree):
    if isinstance(tree, dict):
        return {k: _jnp(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("tier", ["bf16", "q8_0", "q4_0"])
@pytest.mark.parametrize("nq", [1, 4])
def test_paged_decode_attention_matches_the_reference_op(tier, nq):
    """The op (its plain version, routed through ``dispatch``) against
    the reference's ``paged_decode_attention_ref`` on the same pool,
    table and lengths, GQA with 4 query heads on 2 KV heads, shared and
    scratch pages in the rows, (B,) lengths for one query and (B, Q) for
    the verify's four: within one bf16 rounding of the largest output.
    The spec is the reference's."""
    rng = np.random.default_rng(3)
    b, h, hkv, d, n_lp = 3, 4, 2, 64, 5
    kc, vc = (_pool(tier, 9, hkv, d, rng) for _ in range(2))
    table = torch.tensor([[3, 1, 4, 0, 0], [3, 1, 5, 6, 2], [7, 0, 0, 0, 0]])
    q = torch.from_numpy(rng.standard_normal((b, nq, h, d))
                         .astype(np.float32)).to(torch.bfloat16)
    lens = torch.tensor([19, 37, 1]) if nq == 1 else \
        torch.tensor([[17, 18, 19, 20], [34, 35, 36, 37], [1, 2, 3, 4]])
    reset_dispatch_log()
    got = dispatch("paged_decode_attention", q, kc, vc, table, lens)
    assert dict(dispatch_counters()) == {
        ("paged_decode_attention", "accel", "torch"): 1}
    want = paged_decode_attention_ref(
        _jnp(q), _jnp(kc), _jnp(vc), jnp.asarray(table.numpy(), jnp.int32),
        jnp.asarray(lens.numpy(), jnp.int32))
    want = torch.from_numpy(np.asarray(want, np.float32))
    assert got.shape == (b, nq, h, d) and got.dtype == torch.bfloat16
    err = float((got.float() - want).abs().max())
    assert err <= 2 ** -7 * float(want.abs().max()), err
    spec = get_op_spec(q, kc, vc, table, lens)
    assert (spec.m, spec.n, spec.k, spec.count, spec.tag) == \
        (nq, n_lp * P, d, 2 * b * h, "attn_qk")
    assert spec.dtype == tier


def get_op_spec(*args):
    from repro_torch.kernels.registry import get_op
    return get_op("paged_decode_attention").spec(*args)


def test_paged_write_clips_past_the_last_logical_page(rig):
    """Self-attention decode at the last position of a lane's row, and a
    4-query verify whose pos + j runs past its last logical page, write
    into the row's last page (the reference's clip) without an index
    error, and read the positions they wrote."""
    _, tm, _, tp = rig
    cfg = tm.cfg
    layer = {k: v[0] for k, v in tp["dec_layers"]["self_attn"].items()}
    pool = attn_mod.init_paged_kv_cache(cfg, 6, P)
    pool = {k: v[None] for k, v in pool.items()}
    table = torch.tensor([[1, 2], [3, 4]])
    x = torch.randn(2, 4, cfg.d_model).to(torch.bfloat16)
    for nq, pos in ((1, torch.tensor([15, 9])), (4, torch.tensor([14, 13]))):
        y, _ = attn_mod.attention(layer, x[:, :nq], cfg, mode="decode",
                                  cache=pool, pos=pos, layer_idx=0,
                                  page_table=table)
        assert y.shape == (2, nq, cfg.d_model)
        assert bool(torch.isfinite(y.float()).all())
    # lane 0's verify at 14..17: 14, 15 land on its last page (2) at 6,
    # 7; 16, 17 past the row, clipped onto page 2 at 0, 1. Lane 1's at
    # 13..16 land on page 4. No write reaches lane 1's page 3, the
    # scratch page or an unmapped page
    for page in (2, 4):
        assert pool["k"][0, page].abs().sum() > 0
    for page in (0, 3, 5):
        assert pool["k"][0, page].abs().sum() == 0


# ------------------------------------------------ engine against slots
@pytest.mark.parametrize("cache_dtype", ["bf16", "q8_0", "q4_0"])
def test_paged_oneshot_bit_equal_to_the_slot_pool(rig, cache_dtype):
    """One-shot lanes on pages: the slot pool's tokens and logits rows bit
    for bit, on every cache tier, with every paged decode call routed
    through ``paged_decode_attention``, and both pools drained after."""
    slot = _oneshot(_engine(rig, False, cache_dtype=cache_dtype))
    reset_dispatch_log()
    eng = _engine(rig, True, cache_dtype=cache_dtype)
    paged = _oneshot(eng)
    _bit_equal(paged, slot)
    counts = dispatch_counters()
    assert counts[("paged_decode_attention", "accel", "torch")] > 0
    assert not any(k[0].endswith("decode_attention")
                   and k[0] != "paged_decode_attention" for k in counts)
    _drained(eng)


def test_paged_stream_bit_equal_to_the_slot_pool(rig):
    """A stream whose cross pages grow chunk by chunk (chunks of 5 frames,
    so a chunk lands in a page another chunk began), decoding between
    the chunks, beside a one-shot lane: the slot pool's partial
    hypotheses, final tokens and logits rows bit for bit."""
    chunks = [_frames(5, seed=s) for s in (1, 2, 3)]
    res = {}
    for paged in (False, True):
        eng = _engine(rig, paged, cache_dtype="q8_0", decode_block=2)
        one = eng.admit(AudioRequest(uid=1, tokens=[3, 4], max_new=20,
                                     eos_id=-2, enc_frames=_frames(9)))
        st = eng.open_stream(StreamingAudioRequest(
            uid=0, tokens=[5, 6, 7], max_new=6, eos_id=-2, chunks=chunks))
        for c in chunks:
            eng.stream_feed(st, c)
            eng.step()
        if paged:
            assert eng.pages.lanes[st.slot].cross_len == 15
            assert len(eng.pages.lanes[st.slot].cross_pages) == 2
        eng.stream_finalize(st)
        _drain(eng)
        res[paged] = (st, one, eng)
    (st, one, eng), (sst, sone, _) = res[True], res[False]
    assert st.partials == sst.partials and len(st.partials) == 4
    _bit_equal([st, one], [sst, sone])
    _drained(eng)


def test_paged_eos_inside_a_fused_block_bit_equal(rig):
    """A lane that emits its EOS inside a fused 4-step block stops there
    on pages as in the slot pool."""
    fr = _frames(8, seed=0, scale=3.0)
    probe = _engine(rig, False, decode_block=4)
    ref = probe.admit(AudioRequest(uid=0, tokens=[5, 6, 7], max_new=8,
                                   eos_id=-2, enc_frames=fr))
    _drain(probe)
    eos = next(t for t in ref.out[1:] if t != ref.out[0])
    stop_at = ref.out.index(eos) + 1
    assert 1 < stop_at < 8
    outs = []
    for paged in (False, True):
        eng = _engine(rig, paged, decode_block=4)
        outs.append([eng.admit(AudioRequest(uid=1, tokens=[5, 6, 7],
                                            max_new=8, eos_id=eos,
                                            enc_frames=fr))])
        _drain(eng)
    _bit_equal(outs[1], outs[0])
    assert outs[1][0].out[-1] == eos and len(outs[1][0].out) == stop_at
    _drained(eng)


def test_paged_spec_matches_plain_paged_decode(rig):
    """``spec_k=4`` rounds with the Q4_0 draft on a q4_0 page pool: the
    tokens of plain paged decode, and the speculative slot pool's tokens
    and logits rows bit for bit; draft and verify writes land in each
    lane's own extent (``spec_k - 1`` more self pages), so the pools
    drain clean."""
    kw = dict(cache_dtype="q4_0", decode_block=4)
    plain = _oneshot(_engine(rig, True, **kw), max_new=8)
    spec_slot = _oneshot(_engine(rig, False, spec_k=4, **kw), max_new=8)
    eng = _engine(rig, True, spec_k=4, **kw)
    sts = [eng.admit(AudioRequest(uid=i, tokens=list(p), max_new=8,
                                  eos_id=-2,
                                  enc_frames=_frames(6 + 2 * i, seed=i)))
           for i, p in enumerate(PROMPTS)]
    # prompt + max_new + spec_k - 1 positions, in pages
    assert [len(eng.pages.lanes[st.slot].self_pages) for st in sts] \
        == [-(-(len(p) + 8 + 3) // P) for p in PROMPTS]
    _drain(eng)
    assert [st.out for st in sts] == [st.out for st in plain]
    _bit_equal(sts, spec_slot)
    assert eng._host_syncs == eng._ticks == eng._spec_rounds
    assert 0.0 < eng.acceptance_rate <= 1.0
    _drained(eng)


# ------------------------------------------- against the reference's
def _assert_greedy_matches(jm, jp, prompt, enc, got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        seq = list(prompt) + list(want[:i])
        logits, _ = jm.forward(jp, {"tokens": jnp.asarray([seq]),
                                    "enc_states": enc}, mode="train")
        lg = np.asarray(logits[0, -1, :256], np.float32)
        gap = float(lg[w] - lg[g])
        assert gap < TIE_MARGIN, (i, g, w, gap)
        return


@pytest.mark.parametrize("cache_dtype", ["bf16", "q8_0"])
def test_paged_engine_matches_the_reference_paged_engine(rig, cache_dtype):
    """The port's paged engine against the reference's on the same
    bridged weights and requests: greedy tokens equal up to a near-tie,
    and the same paging report once the requests are admitted."""
    jm, _, jp, _ = rig
    kw = dict(n_slots=4, max_len=MAX_LEN, enc_len=ENC_LEN,
              cache_dtype=cache_dtype, paged=True, page_size=P)
    jeng = JServeEngine(jm, jp, **kw)
    teng = _engine(rig, True, cache_dtype=cache_dtype)
    reqs = [(i, p, _frames(6 + 2 * i, seed=i)) for i, p in enumerate(PROMPTS)]
    jsts = [jeng.admit(JAudioRequest(uid=i, tokens=list(p), max_new=6,
                                     eos_id=-2, enc_frames=f))
            for i, p, f in reqs]
    tsts = [teng.admit(AudioRequest(uid=i, tokens=list(p), max_new=6,
                                    eos_id=-2, enc_frames=f))
            for i, p, f in reqs]
    assert teng.paging_report() == jeng.paging_report()
    _drain(jeng)
    _drain(teng)
    for (i, p, f), st, jst in zip(reqs, tsts, jsts):
        enc = jm.encode(jp, jnp.asarray(f)[None])
        _assert_greedy_matches(jm, jp, p, enc, st.out, jst.out)
    _drained(teng)


def test_paged_cache_report_equals_the_reference(rig):
    """``cache_report``'s paging block (occupancy, fragmentation, page
    bytes, resident bytes) and ``bytes_per_step`` equal the reference's,
    before and after an admission; an idle pool streams no cache bytes.
    ``page_headroom`` is the reference's too."""
    jm, _, jp, _ = rig
    kw = dict(n_slots=4, max_len=MAX_LEN, enc_len=ENC_LEN, paged=True,
              page_size=P, cache_dtype="q8_0")
    jeng = JServeEngine(jm, jp, **kw)
    teng = _engine(rig, True, cache_dtype="q8_0")
    assert teng.cache_report()["bytes_per_step"] == 0
    for eng, req in ((jeng, JAudioRequest), (teng, AudioRequest)):
        eng.admit(req(uid=0, tokens=[5, 6, 7], max_new=4, eos_id=-2,
                      enc_frames=_frames(8)))
    got, want = teng.cache_report(), jeng.cache_report()
    assert got["paging"] == want["paging"]
    assert got["bytes_per_step"] == want["bytes_per_step"] \
        == got["paging"]["resident_kv_bytes"] > 0
    assert got["paging"]["self"]["pages_in_use"] == 1      # ceil(7 / 8)
    assert teng.page_headroom() == jeng.page_headroom() < 1.0
    _drain(teng)
    assert teng.cache_report()["bytes_per_step"] == 0
    assert teng.page_headroom() == 1.0


# ------------------------------------- the reference's engine tests
def test_paged_pool_exhaustion_codes(rig):
    """Page demand above the whole pool is POOL_EXHAUSTED at validate; a
    transient shortage returns None from admit with the slot given back,
    and the request admits once pages drain."""
    eng = _engine(rig, True, n_pages=4, n_cross_pages=3)
    fr = _frames(8)
    rej = eng.validate(AudioRequest(uid=0, tokens=[1] * 9, max_new=16,
                                    eos_id=-1, enc_frames=fr))
    assert rej is not None and rej.code == RejectCode.POOL_EXHAUSTED
    st = eng.admit(AudioRequest(uid=1, tokens=[1, 2, 3], max_new=8,
                                eos_id=-1, enc_frames=fr))
    assert st is not None
    blocked = AudioRequest(uid=2, tokens=[4, 5, 6], max_new=8, eos_id=-1,
                           enc_frames=_frames(8, seed=9))
    assert eng.admit(blocked) is None
    assert len(eng.free) == 4 - 1
    assert not eng.lanestate.holds(eng.free[-1])
    _drain(eng)
    assert eng.admit(blocked) is not None
    _drain(eng)
    _drained(eng)


def test_paged_midstream_pool_exhaustion(rig):
    """A stream whose next chunk finds no cross page fails with
    POOL_EXHAUSTED, and ``abort`` drains its lane and its pages."""
    eng = _engine(rig, True, n_slots=2, max_len=32, n_pages=9,
                  n_cross_pages=3)
    resident = eng.admit(AudioRequest(uid=9, tokens=[1, 2],
                                      max_new=32 - 8, eos_id=-1,
                                      enc_frames=_frames(8, seed=5)))
    assert resident is not None
    req = StreamingAudioRequest(uid=0, tokens=[5, 6], max_new=4, eos_id=-2,
                                chunks=[_frames(8), _frames(8, seed=8)])
    st = eng.open_stream(req)
    eng.stream_feed(st, req.chunks[0])
    with pytest.raises(RejectionError) as ei:
        eng.stream_feed(st, req.chunks[1])
    assert ei.value.rejection.code == RejectCode.POOL_EXHAUSTED
    assert eng.lanestate.held(st.slot)["cross_kv"] == 8
    eng.abort(st)
    assert st.done and st.error_code == RejectCode.CANCELLED
    _drain(eng)
    _drained(eng)


def test_paged_prefix_refcount_matches_lanes(rig):
    """Four lanes with the same full prompt page and audio hold one
    physical anchor page and one cross block, each refcounted 4 times
    (prefix hits 3 of 4 in both stores); their outputs are equal, so the
    shared pages were not corrupted, and both pools drain to zero."""
    eng = _engine(rig, True)
    fr = _frames(8)
    anchor = list(range(3, 3 + P))
    sts = [eng.admit(AudioRequest(uid=i, tokens=list(anchor), max_new=4,
                                  eos_id=-2, enc_frames=fr))
           for i in range(4)]
    pages = {eng.pages.lanes[st.slot].self_pages[0] for st in sts}
    assert len(pages) == 1
    assert eng.pages.self_pool.refcount(pages.pop()) == 4
    rep = eng.paging_report()
    assert rep["prefix"]["self"]["hits"] == 3
    assert rep["prefix"]["cross"]["hits"] == 3
    assert rep["prefix"]["self"]["max_refcount"] == 4
    assert rep["resident_lanes"] == 4
    _drain(eng)
    assert all(st.out == sts[0].out for st in sts)
    _drained(eng)
