"""The port's captured decode tick, on the CPU: what the CUDA graph relies
on and what can be held without a card.

* The decode-state buffers and every leaf of the cache pool keep their
  storage across ticks, admissions and frees: the graph reads and writes
  them by address.
* The serving tree (``Model.prepare_serving``) gives outputs equal to the
  unprepared weights' bit for bit: the Whisper decode and verify logits
  (f32, bf16 and Q8_0 tables), the Q4_0 draft's head and step, and the
  xLSTM blocks at prefill and decode.
* ``api.recording`` / ``api.replay_record`` count a captured tick once
  per replay and the capture pass not at all.
* ``cuda_graph=True`` needs a CUDA device.
* The bf16 activations round per op, bit-equal to ``jax.nn.gelu`` and
  ``jax.nn.silu``.

The captured tick itself (tokens and logits against the eager tick, one
capture per tick size, one synchronising call a tick) is held on the
card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import api
from repro_torch.kernels.fp16_matmul import ops as mm_ops
from repro_torch.kernels.q8_matmul import ops as q8_ops
from repro_torch.models import layers
from repro_torch.models import xlstm as tx
from repro_torch.models.attention import quantize_kv_cache
from repro_torch.models.layers import layer_slice
from repro_torch.models.model import build
from repro_torch.quantize import quantize_tree
from repro_torch.serving.engine import (AudioRequest, Request, ServeEngine,
                                        _leaves)
from repro_torch.serving.scheduler import BatchScheduler

ENC = 16


def _init(arch: str, seed: int = 0):
    model = build(reduced(get_config(arch)))
    return model, model.init_values(torch.Generator().manual_seed(seed),
                                    device="cpu")


@pytest.fixture(scope="module")
def whisper():
    return _init("whisper-tiny-en")


@pytest.fixture(scope="module")
def xlstm():
    model, params = _init("xlstm-350m")
    return model, _cast(params, torch.bfloat16)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _frames(rng, n):
    return rng.standard_normal((n, 128)).astype(np.float32) * 0.5


# ----------------------------------------------------------------------------
# storage of the decode state and the pool
# ----------------------------------------------------------------------------

def _ptrs(eng) -> list:
    bufs = [eng._tokens, eng._pos, eng._lane_active, eng._lane_out,
            eng._enc_lens, eng._lane_eos, eng._lane_max]
    return [t.data_ptr() for t in bufs + list(_leaves(eng.cache))]


def _serve_with_churn(eng, requests):
    """Serve ``requests`` through ``BatchScheduler`` on a pool smaller
    than the load (admissions into freed slots mid-run, one abort),
    returning the storage addresses seen after every tick."""
    sched = BatchScheduler(eng, max_admit_per_tick=2)
    for r in requests:
        sched.submit(r)
    seen = [_ptrs(eng)]
    sched.tick()
    seen.append(_ptrs(eng))
    sched.abort(requests[0].uid)
    seen.append(_ptrs(eng))
    while not sched.drained:
        sched.tick()
        seen.append(_ptrs(eng))
    return sched, seen


@pytest.mark.parametrize("cache_dtype,spec_k", [("bf16", 0), ("q8_0", 0),
                                                ("q4_0", 0), ("q8_0", 4)])
def test_whisper_state_and_pool_keep_their_storage(whisper, cache_dtype,
                                                   spec_k):
    model, params = whisper
    rng = np.random.default_rng(3)
    eng = ServeEngine(model, params, n_slots=2, max_len=48, enc_len=ENC,
                      cache_dtype=cache_dtype, decode_block=4,
                      spec_k=spec_k, device="cpu")
    reqs = [AudioRequest(uid=i, tokens=[1, 5 + i], max_new=n, eos_id=-1,
                         enc_frames=_frames(rng, 8 + 2 * i))
            for i, n in enumerate((9, 3, 6, 5))]
    sched, seen = _serve_with_churn(eng, reqs)
    assert all(s == seen[0] for s in seen)
    assert sched.metrics.completed == 3 and eng.lanestate.drained
    assert eng.captures == eng.replays == 0


def test_xlstm_state_and_pool_keep_their_storage(xlstm):
    model, params = xlstm
    eng = ServeEngine(model, params, n_slots=2, max_len=64, decode_block=4,
                      device="cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, tokens=rng.integers(3, 500, size=n).tolist(),
                    max_new=m, eos_id=-1)
            for i, (n, m) in enumerate(((7, 9), (12, 3), (5, 6), (9, 5)))]
    sched, seen = _serve_with_churn(eng, reqs)
    assert all(s == seen[0] for s in seen)
    assert sched.metrics.completed == 3 and eng.lanestate.drained


def test_cuda_graph_needs_a_cuda_device(whisper):
    model, params = whisper
    with pytest.raises(ValueError, match="cuda_graph=True"):
        ServeEngine(model, params, n_slots=1, enc_len=ENC, device="cpu",
                    cuda_graph=True)
    for flag in (None, False):
        eng = ServeEngine(model, params, n_slots=1, enc_len=ENC,
                          device="cpu", cuda_graph=flag)
        assert eng.cuda_graph is False


# ----------------------------------------------------------------------------
# the serving tree
# ----------------------------------------------------------------------------

def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _whisper_decode(model, tree, cache_dtype: str):
    """Prefill one request, two decode steps and a 4-token verify on
    ``tree``: every logits tensor and the cache after them."""
    rng = np.random.default_rng(11)
    n = 5
    toks = torch.zeros((1, 32), dtype=torch.int64)
    toks[0, :n] = torch.as_tensor([1, 7, 9, 4, 2])
    enc = torch.from_numpy(_frames(rng, ENC))[None]
    logits, cache = model.forward(tree, {"tokens": toks, "enc_frames": enc},
                                  mode="prefill",
                                  cache=model.init_cache(1, 48, ENC))
    if cache_dtype != "bf16":
        cache = quantize_kv_cache(cache, cache_dtype)
    outs = [logits]
    batch = {"enc_lens": torch.tensor([ENC])}
    for j, q in enumerate(([[3]], [[8]], [[6, 1, 2, 5]])):
        batch["tokens"] = torch.tensor(q)
        logits, _ = model.forward(tree, batch, mode="decode", cache=cache,
                                  pos=torch.tensor([n + j]))
        outs.append(logits)
    return outs, cache


@pytest.mark.parametrize("weights,cache_dtype", [("f32", "bf16"),
                                                 ("bf16", "bf16"),
                                                 ("q8_0", "q8_0")])
def test_prepared_whisper_logits_equal_unprepared(whisper, weights,
                                                  cache_dtype):
    model, params = whisper
    params = {"f32": params, "bf16": _cast(params, torch.bfloat16),
              "q8_0": quantize_tree(params)}[weights]
    prep = model.prepare_serving(params)
    assert prep["embed"]["head_f32"].dtype == torch.float32
    assert "wqkv" in prep["dec_layers"]["self_attn"]
    assert "wqkv" not in params["dec_layers"]["self_attn"]  # as given
    want, want_cache = _whisper_decode(model, params, cache_dtype)
    got, got_cache = _whisper_decode(model, prep, cache_dtype)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _assert_trees_equal(got_cache, want_cache)


def test_prepared_q4_draft_head_and_step_equal_unprepared(whisper):
    model, params = whisper
    draft = quantize_tree(params, tier="q4_0")
    prep = model.prepare_serving(draft)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 1, 128)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(layers.logits_head(prep["embed"], x, 512),
                       layers.logits_head(draft["embed"], x, 512))
    want, want_cache = _whisper_decode(model, draft, "q4_0")
    got, got_cache = _whisper_decode(model, prep, "q4_0")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _assert_trees_equal(got_cache, want_cache)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_prepared_xlstm_blocks_equal_unprepared(xlstm, block):
    model, params = xlstm
    cfg = model.cfg
    key, fn, init, prep_fn = {
        "mlstm": ("block0", tx.mlstm_block, tx.init_mlstm_cache,
                  tx.prepare_mlstm),
        "slstm": ("block1", tx.slstm_block, tx.init_slstm_cache,
                  tx.prepare_slstm)}[block]
    p = layer_slice(params["segments"][key][block], 0)
    pp = layer_slice(model.prepare_serving(params)["segments"][key][block],
                     0)
    _assert_trees_equal(pp, prep_fn(p))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 20, 128)).astype(
        np.float32)).to(torch.bfloat16)
    x1 = torch.from_numpy(rng.standard_normal((2, 1, 128)).astype(
        np.float32)).to(torch.bfloat16)
    runs = []
    for tree in (p, pp):
        y, c = fn(tree, x, cfg, mode="prefill", cache=init(cfg, 2))
        y1, c1 = fn(tree, x1, cfg, mode="decode", cache=c)
        runs.append((y, c, y1, c1))
    for a, b in zip(*runs):
        _assert_trees_equal(a, b)


def test_prepared_xlstm_model_decode_equals_unprepared(xlstm):
    model, params = xlstm
    prep = model.prepare_serving(params)
    toks = torch.tensor([[5, 9, 33, 2, 8, 1]])
    outs = []
    for tree in (params, prep):
        logits, cache = model.forward(tree, {"tokens": toks},
                                      mode="prefill",
                                      cache=model.init_cache(1, 32))
        steps = [logits]
        for t in (4, 11):
            logits, cache = model.forward(tree, {"tokens": torch.tensor(
                [[t]])}, mode="decode", cache=cache)
            steps.append(logits)
        outs.append((steps, cache))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    _assert_trees_equal(outs[0][1], outs[1][1])


# ----------------------------------------------------------------------------
# replay accounting
# ----------------------------------------------------------------------------

@pytest.fixture
def clean_log(monkeypatch):
    for fn in (mm_ops.fp16_matmul, q8_ops.q8_matmul):
        monkeypatch.setattr(fn, "launches", 0)
    api.reset_dispatch_log()
    yield
    api.reset_dispatch_log()


def test_replay_record_adds_a_ticks_deltas_once_a_replay(clean_log):
    x, w = torch.ones((4, 8)), torch.ones((8, 16))
    api.dispatch("fp16_matmul", x, w)
    mm_ops.fp16_matmul.launches += 1
    counters0, trace0 = api.dispatch_counters(), api.dispatch_trace()
    launches0 = api.launch_counts()
    with api.recording() as rec:
        api.dispatch("fp16_matmul", x, w)
        api.dispatch("fp16_matmul", x, w)
        # what a wrapper counts where it launches its kernel on the card
        mm_ops.fp16_matmul.launches += 2
        q8_ops.q8_matmul.launches += 1
    # the capture pass counts nothing
    assert api.dispatch_counters() == counters0
    assert api.dispatch_trace() == trace0
    assert api.launch_counts() == launches0
    key = ("fp16_matmul", "accel", "torch")
    assert rec.counters == {key: 2} and len(rec.trace) == 2
    assert rec.launches == {"fp16_matmul": 2, "q8_matmul": 1}
    for n in (1, 2, 3):
        api.replay_record(rec)
        assert api.dispatch_counters()[key] == 1 + 2 * n
        assert len(api.dispatch_trace()) == 1 + 2 * n
        assert api.launch_counts()["fp16_matmul"] == 1 + 2 * n
        assert api.launch_counts()["q8_matmul"] == n


def test_recorded_tick_counts_what_an_eager_tick_does(whisper, clean_log):
    """A tick run under ``recording`` leaves the log as it was and records
    what the eager tick before it added; replaying the record twice
    gives the log of two eager ticks, and the same energy report."""
    model, params = whisper
    rng = np.random.default_rng(1)
    eng = ServeEngine(model, quantize_tree(params), n_slots=2, max_len=48,
                      enc_len=ENC, cache_dtype="q8_0", decode_block=2,
                      platform="h100-sxm", device="cpu")
    for i in range(2):
        eng.admit(AudioRequest(uid=i, tokens=[1], max_new=20, eos_id=-1,
                               enc_frames=_frames(rng, 10)))
    c0 = api.dispatch_counters()
    eng.step()
    eager = api.dispatch_counters() - c0
    c1, n1 = api.dispatch_counters(), len(api.dispatch_trace())
    with api.recording() as rec:
        eng.step()
    assert api.dispatch_counters() == c1
    assert len(api.dispatch_trace()) == n1
    assert rec.counters == eager and rec.launches == {}
    share = eng.energy_report()["accel_flops_share"]
    api.replay_record(rec)
    assert api.dispatch_counters() == c1 + eager
    assert eng.energy_report()["accel_flops_share"] == share


# ----------------------------------------------------------------------------
# bf16 activations, rounded per op as jax rounds them
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,jfn", [("gelu", jax.nn.gelu),
                                      ("silu", jax.nn.silu)])
def test_bf16_activation_is_bit_equal_to_jax(name, jfn):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 3).astype(np.float32)
    x[:8] = [0.0, -0.0, 1e-30, -1e-30, 20.0, -20.0, 5e4, -5e4]
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jfn(xj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))) \
        .to(torch.bfloat16)
    got = layers._act(name)(xt)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy().view(np.uint32),
                          want.view(np.uint32))
