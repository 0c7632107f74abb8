"""The port's parallel surface against the JAX package's, in this
process (and one subprocess for the reference's meshes):

* ``rules_for`` equal for every registered arch, train and serve, on the
  meshes {data 16, model 16}, {pod 2, data 16, model 16}, {data 2,
  model 2} and {data 4, model 1}; the reference reads a stand-in mesh
  (``tests/test_sharding_rules.py``'s ``_FakeMesh``), as the port can;
* ``spec_for`` equal over every leaf of ``state_axes``;
* ``param_axes``, ``param_shapes``, ``n_params``, ``n_active_params``,
  ``cache_specs`` and ``input_specs`` equal, full size and reduced;
* ``state_shardings``, ``batch_shardings`` and ``cache_shardings``,
  after ``enforce_divisibility``, equal the reference's specs on 2x2
  and 16x16 (the reference's from one subprocess with forced host
  devices; this process never sets ``XLA_FLAGS``);
* ``quantize_grad`` / ``dequantize_grad`` bit-equal, ``compression_ratio``
  equal;
* ``constrain`` returns its input itself without a context; a DTensor
  operand takes the dispatch's torch route on the CPU and under
  ``grad_safe_context``, and on the card outside it raises;
* ``make_production_mesh`` over a ``fake`` process group of 256 and 512
  ranks has the shape and axis names of the reference's (which the
  subprocess builds over 512 forced host devices);
* the split over ``model`` of a meshed serving step, shard by shard (a
  thread a shard, ``parallel.model_axis.run_shards``), at reduced
  qwen3-4b and whisper-tiny.en over 2 (heads form) and 4 (head_dim
  form) shards: the attention's prefill and decode step, the MLP, the
  embedding and the head against the unsplit layers, the row-parallel
  f32 sums within ``SPLIT_REL`` (1e-6) of the unsplit product before its
  one rounding; the MoE layer in the ``experts`` form (reduced
  qwen3-moe-30b-a3b over 2) and the ``expert_ff`` form (reduced
  mixtral-8x7b with 6 experts over 4) and a mamba block in the ``inner``
  form (reduced zamba2-7b over 2 and 4; a prefill and a decode step),
  their all-reduced f32 sums within ``SPLIT_REL`` of the unsplit
  product of the shards' own inputs, their outputs within one bf16
  rounding of the unsplit layer's, the routing counts and the mamba
  state equal; the reference's ``serve_row_tp`` (heads that do not
  divide ``model``) in the ``param_embed`` form over 4 shards (reduced
  gemma2-2b's attention, prefill and decode, and MLP, llava-next-34b's
  untied head, 6 heads and 2 KV heads; head_dim 32, and 18, which does
  not divide 4: the cache whole, ``wo`` column-parallel) and the xLSTM
  blocks (reduced xlstm-350m over 4: 4 heads in the mLSTM's ``inner``
  and the sLSTM's ``heads`` form, 2 heads in ``param_embed``; a prefill,
  then a decode step on its state), each row-parallel sum within
  ``SPLIT_REL`` of the exact product of the shards' operands, the
  outputs, caches and states within one bf16 rounding of the unsplit
  unit's; a ``serve_row_tp`` prefill context-parallel over 4 shards
  (gemma2-2b's global and local layers, whisper-tiny.en's encoder,
  decoder and cross-attention, S = 8, 7 and 3, both ``wo`` forms): each
  shard's flash attention on its block of the query positions at its
  ``q_offset``, the outputs within one bf16 rounding of the unsplit
  unit's, the caches its slice; ``sharded_argmax`` equals ``torch.argmax`` with maxima
  tied across shard edges; and which units a split takes, from the
  serve rules' placements of full-size configs on a ``fake`` group.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.configs import reduced as j_reduced
from repro.models.model import SHAPES
from repro.models.model import build as j_build
from repro.models.model import input_specs as j_input_specs
from repro.parallel import collectives as j_coll
from repro.parallel.sharding import rules_for as j_rules_for
from repro.parallel.sharding import spec_for as j_spec_for
from repro.train.step import state_axes as j_state_axes
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import build, input_specs, tree_paths
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import constrain, rules_for, spec_for
from repro_torch.train import step as t_step

ARCHS = list_archs()
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2}, {"data": 4, "model": 1})
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeMesh:
    """Duck-typed mesh: rules_for only reads .shape."""
    def __init__(self, **axes):
        self.shape = dict(axes)


def _j_paths(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _sd(x):
    """(shape, dtype name) of a jax ShapeDtypeStruct or a torch tensor."""
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal(arch):
    for mode in ("train", "serve"):
        for axes in MESHES:
            want = j_rules_for(j_get_config(arch), _FakeMesh(**axes), mode)
            got = rules_for(get_config(arch), _FakeMesh(**axes), mode)
            assert got == want, (mode, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_equal_over_state_axes(arch):
    jm, tm = j_build(j_get_config(arch)), build(get_config(arch))
    j_axes = _j_paths(j_state_axes(jm), lambda x: isinstance(x, tuple))
    t_axes = dict(tree_paths(t_step.state_axes(tm)))
    assert j_axes == t_axes
    for mode in ("train", "serve"):
        for axes in MESHES:
            rules = rules_for(get_config(arch), _FakeMesh(**axes), mode)
            for name, ax in t_axes.items():
                assert spec_for(ax, rules) == tuple(j_spec_for(ax, rules)), \
                    (name, mode, axes)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_input_surface_equal(arch):
    for red in (False, True):
        jc, tc = j_get_config(arch), get_config(arch)
        if red:
            jc, tc = j_reduced(jc), reduced(tc)
        jm, tm = j_build(jc), build(tc)
        assert _j_paths(jm.param_axes(), lambda x: isinstance(x, tuple)) \
            == dict(tree_paths(tm.param_axes()))
        for dtype in (None, "bfloat16"):
            want = {k: _sd(v) for k, v in _j_paths(jm.param_shapes(
                None if dtype is None else jnp.bfloat16)).items()}
            got = {k: _sd(v) for k, v in tree_paths(tm.param_shapes(
                None if dtype is None else torch.bfloat16))}
            assert got == want
        assert tm.n_params() == jm.n_params()
        assert tm.n_active_params() == jm.n_active_params()
        want = {k: _sd(v) for k, v in _j_paths(jm.cache_specs(2, 64, 48)).items()}
        got = {k: _sd(v) for k, v in tree_paths(tm.cache_specs(2, 64, 48))}
        assert got == want
        for shape in SHAPES:
            want = {k: _sd(v) for k, v in j_input_specs(jc, shape).items()}
            got = {k: _sd(v) for k, v in input_specs(tc, shape).items()}
            assert got == want, shape


# ----------------------------------------------------------------------------
# The sharded specs: the reference's from one forced-device subprocess
# ----------------------------------------------------------------------------

_REFERENCE_SPECS = """
import json, os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=512'
sys.path.insert(0, 'src')
import jax
from repro.configs import get_config, list_archs
from repro.models.model import build
from repro.parallel.sharding import rules_for
from repro.train import step as S

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): [list(e) if isinstance(e, tuple) else e
                                      for e in sh.spec]
            for path, sh in flat}

out = {}
for arch in list_archs():
    cfg = get_config(arch)
    model = build(cfg)
    for label, shape in (("2x2", (2, 2)), ("16x16", (16, 16))):
        mesh = jax.make_mesh(shape, ("data", "model"))
        train = rules_for(cfg, mesh, "train")
        serve = rules_for(cfg, mesh, "serve")
        out[f"{arch}|{label}"] = {
            "state": specs(S.state_shardings(model, mesh, train)),
            "batch": {s: specs(S.batch_shardings(cfg, s, mesh, train))
                      for s in ("train_4k", "prefill_32k", "decode_32k")},
            "cache": specs(S.cache_shardings(model, 8, 160, mesh, serve,
                                             enc_len=1500))}
from repro.launch.mesh import make_production_mesh
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    out[f"production|{multi_pod}"] = [list(mesh.shape.values()),
                                      list(mesh.shape.keys())]
print("SPECS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_specs():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", _REFERENCE_SPECS],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(l for l in r.stdout.splitlines() if l.startswith("SPECS"))
    return json.loads(line[len("SPECS"):])


def _t_specs(tree):
    return {k: [list(e) if isinstance(e, tuple) else e for e in sh.spec]
            for k, sh in tree_paths(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_specs_equal(reference_specs, arch):
    cfg = get_config(arch)
    model = build(cfg)
    for label, (d, m) in (("2x2", (2, 2)), ("16x16", (16, 16))):
        want = reference_specs[f"{arch}|{label}"]
        mesh = _FakeMesh(data=d, model=m)
        train = rules_for(cfg, mesh, "train")
        serve = rules_for(cfg, mesh, "serve")
        assert _t_specs(t_step.state_shardings(model, mesh, train)) \
            == want["state"], label
        for shape, spec in want["batch"].items():
            assert _t_specs(t_step.batch_shardings(cfg, shape, mesh, train)) \
                == spec, (label, shape)
        assert _t_specs(t_step.cache_shardings(model, 8, 160, mesh, serve,
                                               enc_len=1500)) \
            == want["cache"], label


# ----------------------------------------------------------------------------
# Gradient compression
# ----------------------------------------------------------------------------

def _grad(n, zero_chunk=False, seed=0):
    g = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if zero_chunk:
        g[1024:2048] = 0.0
    return g


@pytest.mark.parametrize("n,zero_chunk", [(4096, False), (5000, False),
                                          (5000, True), (7, False)])
def test_quantize_grad_bit_equal(n, zero_chunk):
    g = _grad(n, zero_chunk)
    jq, js = j_coll.quantize_grad(jnp.asarray(g))
    tq, ts = collectives.quantize_grad(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = j_coll.dequantize_grad(jq, js, (n,))
    td = collectives.dequantize_grad(tq, ts, (n,))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if zero_chunk:
        assert float(ts[1]) == 0.0 and not tq[1].any()


def test_compression_ratio_equal():
    for shapes in ([(256,)], [(4, 256), (1000,)], [(3, 1024, 5)]):
        jt = {str(i): jnp.zeros(s) for i, s in enumerate(shapes)}
        tt = {str(i): torch.zeros(s) for i, s in enumerate(shapes)}
        assert collectives.compression_ratio(tt) == \
            j_coll.compression_ratio(jt)


# ----------------------------------------------------------------------------
# constrain, the dispatch and the production mesh
# ----------------------------------------------------------------------------

def test_constrain_is_free_without_a_mesh():
    from repro_torch.parallel.sharding import logical_context
    x = torch.ones(2, 3, 4)
    assert constrain(x, "batch", "q_seq", "embed") is x
    rules = rules_for(get_config("qwen3-4b"), _FakeMesh(data=2, model=2))
    with logical_context(_FakeMesh(data=2, model=2), rules):
        assert constrain(x, "batch", "q_seq", "embed") is x


def test_dtensor_operand_takes_the_torch_route():
    """A DTensor operand on the CPU binds the plain version and says so
    in the counters (a one-rank ``fake`` group)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import api
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        x = DTensor.from_local(torch.ones(4, 8), mesh, [Replicate()])
        w = DTensor.from_local(torch.ones(8, 16, dtype=torch.bfloat16),
                               mesh, [Replicate()])
        api.reset_dispatch_log()
        # even a route forced onto the kernel binds the plain version
        with api.use_context(api.DispatchContext(force_backend="cuda")):
            y = api.dispatch("fp16_matmul", x, w, out_dtype=torch.float32)
        assert type(y).__name__ == "DTensor"
        assert torch.equal(y.full_tensor(), torch.full((4, 16), 8.0))
        assert dict(api.dispatch_counters()) == {
            ("fp16_matmul", "forced", "torch"): 1}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ctx_kw,backend", [
    ({}, None), ({"force_backend": "cuda"}, None),
    ({"force_backend": "torch"}, None),
    ({"grad_safe": True}, "torch"),
    ({"force_backend": "cuda", "grad_safe": True}, "torch"),
    ({"allow_plain_on_cuda": True}, "torch")])
def test_dtensor_operand_on_the_card(ctx_kw, backend):
    """On the card a DTensor operand binds the torch implementation only
    under ``grad_safe`` (or for a comparison with the plain version);
    any other route raises, as a plain route on the card does, and no
    kernel is handed a DTensor (None: raises)."""
    from repro_torch.kernels import api
    x = torch.ones(4, 8)
    w = torch.ones(8, 16, dtype=torch.bfloat16)
    spec = api.get_op("fp16_matmul").spec(x, w, out_dtype=torch.float32)
    ctx = api.DispatchContext(**ctx_kw)
    if backend is None:
        with pytest.raises(ValueError, match="DTensor operand on the card"):
            api.decide("fp16_matmul", spec, ctx, on_cuda=True, dtensor=True)
    else:
        assert api.decide("fp16_matmul", spec, ctx, on_cuda=True,
                          dtensor=True)[1] == backend


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_over_a_fake_group(reference_specs, multi_pod):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as t_mesh
    want_shape, want_names = reference_specs[f"production|{multi_pod}"]
    n = int(np.prod(want_shape))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        mesh = t_mesh.make_production_mesh(multi_pod=multi_pod)
        assert list(mesh.mesh.shape) == want_shape
        assert list(mesh.mesh_dim_names) == want_names
        assert t_mesh.mesh_chips(mesh) == n
        assert t_mesh.mesh_label(mesh) == "x".join(map(str, want_shape))
        assert rules_for(get_config("qwen3-4b"), mesh) == j_rules_for(
            j_get_config("qwen3-4b"),
            _FakeMesh(**dict(zip(want_names, want_shape))))
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# The split over ``model``, shard by shard (no ranks: one thread a shard)
# ----------------------------------------------------------------------------

#: a split layer's f32 sum against the unsplit layer's f32 output before
#: its one rounding, over the largest magnitude
SPLIT_REL = 1e-6
SPLIT_ARCHS = ("qwen3-4b", "whisper-tiny-en")
SPLIT_ROWS, SPLIT_SEQ, SPLIT_CACHE = 2, 8, 12


def _split_setup(arch):
    """(cfg, float params, a layer's attention and MLP units, bf16 x)."""
    from repro_torch.models.layers import layer_slice
    cfg = reduced(get_config(arch))
    params = build(cfg).init_values(torch.Generator().manual_seed(3), "cpu")
    if cfg.enc_dec:
        layer = layer_slice(params["dec_layers"], 0)
        attn = layer["self_attn"]
    else:
        layer = layer_slice(params["segments"], 0)["block0"]
        attn = layer["attn"]
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(
        (SPLIT_ROWS, SPLIT_SEQ, cfg.d_model)).astype(np.float32))
    return cfg, params, attn, layer["mlp"], x.to(torch.bfloat16)


def _form(cfg, tp: int) -> str:
    """The attention form ``unit_form`` gives the serve rules at ``tp``."""
    return "heads" if cfg.n_kv_heads % tp == 0 else "head_dim"


def _shards(tp: int, fn) -> list:
    """``fn(axis)`` for each of ``tp`` shards in its thread, under a
    ``gather_context`` with the shard's model axis."""
    from repro_torch.models.layers import gather_context
    from repro_torch.parallel.model_axis import run_shards

    def one(axis):
        with torch.no_grad(), gather_context(model=axis):
            return fn(axis)
    return run_shards(tp, one)


def _near(got, want, what, rel=SPLIT_REL):
    gap = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    assert gap <= rel * top, (what, gap, top)


@pytest.fixture
def unsplit_wo(monkeypatch):
    """The unsplit attention's output projection, recording its f32
    product before the one rounding (the same bits once rounded)."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import mm_out
    seen = []

    def project(p, out):
        y = mm_out(out, p["wo"], out_dtype=torch.float32)
        seen.append(y)
        return y.to(torch.bfloat16)
    monkeypatch.setattr(A, "_project_out", project)
    return seen


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_split_attention_prefill_sums_to_the_unsplit(arch, tp, unsplit_wo,
                                                      monkeypatch):
    """The prefill (causal, rope where the decoder-only family has it) on
    each shard's heads: the shards' f32 ``wo`` partials summed equal the
    unsplit product before its rounding, and each shard's new cache is
    its slice of the unsplit one (its KV heads, or its head_dim slice)."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import model_dim, split_unit
    cfg, _, attn, _, x = _split_setup(arch)
    rope = not cfg.enc_dec
    want, want_c = A.attention(attn, x, cfg, mode="prefill", use_rope=rope)
    want_f32 = unsplit_wo[-1]
    monkeypatch.undo()
    form = _form(cfg, tp)

    def one(axis):
        p = split_unit(attn, axis, form)
        y, c = A.attention(p, x, cfg, mode="prefill", use_rope=rope)
        return y, c, axis.reduced[-1]
    outs = _shards(tp, one)
    split = 2 if form == "heads" else 3
    for r, (y, c, summed) in enumerate(outs):
        _near(summed, want_f32, f"shard {r} sum")
        _near(y, want, f"shard {r} output", rel=2 ** -7)
        for key in ("k", "v"):
            assert model_dim(c[key]) == split
            _near(c[key], want_c[key].chunk(tp, split)[r], f"cache {key}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_split_attention_decode_sums_to_the_unsplit(arch, tp, unsplit_wo,
                                                     monkeypatch):
    """One decode step of two queries a lane over a 12-position cache
    split as the serve rules split it: by KV heads (each shard reads its
    heads), or by head_dim (the query of every head gathered, the scores
    summed over the shards in f32, P.V on the slice, an all-to-all back
    to the heads). The f32 ``wo`` sums equal the unsplit product before
    its rounding, and the new rows land in each shard's slice."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import split_unit
    cfg, _, attn, _, x = _split_setup(arch)
    rope = not cfg.enc_dec
    rng = np.random.default_rng(12)
    shape = (1, SPLIT_ROWS, SPLIT_CACHE, cfg.n_kv_heads, cfg.head_dim)
    pool = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for k in ("k", "v")}
    pos = torch.tensor([5, 9])
    xq = x[:, :2]
    whole = {k: v.clone() for k, v in pool.items()}
    want, _ = A.attention(attn, xq, cfg, mode="decode", cache=whole,
                          pos=pos, layer_idx=0, use_rope=rope)
    want_f32 = unsplit_wo[-1]
    monkeypatch.undo()
    form = _form(cfg, tp)
    split = 3 if form == "heads" else 4

    def one(axis):
        p = split_unit(attn, axis, form)
        mine = {k: v.chunk(tp, split)[axis.rank].clone()
                for k, v in pool.items()}
        y, _ = A.attention(p, xq, cfg, mode="decode", cache=mine, pos=pos,
                           layer_idx=0, use_rope=rope)
        return y, mine, axis.reduced[-1]
    for r, (y, mine, summed) in enumerate(_shards(tp, one)):
        _near(summed, want_f32, f"shard {r} sum")
        _near(y, want, f"shard {r} output", rel=2 ** -7)
        for key in ("k", "v"):
            _near(mine[key], whole[key].chunk(tp, split)[r], f"cache {key}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_split_mlp_sums_to_the_unsplit(arch, tp):
    """``up`` (and ``gate``) column-parallel, the activation on the
    shard's columns, ``down`` row-parallel: the f32 partials summed equal
    the unsplit ``down`` product before its rounding."""
    from repro_torch.models.layers import _act, mlp, mm, split_unit
    cfg, _, _, unit, x = _split_setup(arch)
    up = mm(x, unit["up"])
    h = _act(cfg.act)(mm(x, unit["gate"])) * up if "gate" in unit \
        else _act(cfg.act)(up)
    want_f32 = mm(h, unit["down"], out_dtype=torch.float32)
    assert torch.equal(want_f32.to(torch.bfloat16), mlp(unit, x, cfg.act))

    def one(axis):
        y = mlp(split_unit(unit, axis, "ff"), x, cfg.act)
        return y, axis.reduced[-1]
    for r, (y, summed) in enumerate(_shards(tp, one)):
        _near(summed, want_f32, f"shard {r} sum")
        _near(y, want_f32, f"shard {r} output", rel=2 ** -7)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", SPLIT_ARCHS)
def test_split_embedding_and_head_equal_the_unsplit(arch, tp):
    """The vocab-parallel embedding equals the unsplit one bit for bit
    (one nonzero term an element); the head's vocabulary columns, shard
    by shard in rank order, equal the unsplit logits (the padding ids'
    mask offset by ``vocab_offset``), and ``sharded_argmax`` their
    argmax."""
    from repro_torch.models.layers import (embed, logits_head, model_dim,
                                           sharded_argmax, split_unit)
    cfg, params, _, _, x = _split_setup(arch)
    rng = np.random.default_rng(13)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (
        SPLIT_ROWS, SPLIT_SEQ)).astype(np.int32))
    head = params.get("lm_head")
    want_x = embed(params["embed"], tokens)
    want = logits_head(params["embed"], x, cfg.vocab,
                       softcap=cfg.final_softcap, head=head)

    def one(axis):
        tbl = split_unit(params["embed"], axis, "vocab")
        h = None if head is None else split_unit(head, axis, "vocab_cols")
        y = logits_head(tbl, x, cfg.vocab, softcap=cfg.final_softcap,
                        head=h)
        assert model_dim(y) == 2
        return embed(tbl, tokens), y, sharded_argmax(y[:, -1])
    outs = _shards(tp, one)
    for got_x, _, ids in outs:
        assert torch.equal(got_x, want_x)
        assert torch.equal(ids, torch.argmax(want[:, -1], -1).to(
            torch.int32))
    _near(torch.cat([y for _, y, _ in outs], -1), want, "logits")


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_sharded_argmax_takes_the_first_of_tied_maxima(tp):
    """Maxima planted on both sides of shard edges, and a row whose
    every value ties: the lowest global index wins, as ``torch.argmax``
    returns it."""
    from repro_torch.models.layers import sharded_argmax
    rng = np.random.default_rng(14)
    n = 64
    logits = torch.from_numpy(rng.standard_normal((6, n)).astype(
        np.float32))
    w = n // tp
    logits[0, [w - 1, w]] = 9.0          # across the first edge
    logits[1, [w, 2 * w - 1]] = 9.0      # within one shard
    logits[2, [n - 1, w - 1]] = 9.0      # the first and last shards
    logits[3] = 1.0                      # every value ties
    logits[4, [n - w, n - 1]] = 9.0      # the last shard alone
    want = torch.argmax(logits, -1).to(torch.int32)
    outs = _shards(tp, lambda axis: sharded_argmax(
        logits.chunk(tp, -1)[axis.rank]))
    for got in outs:
        assert torch.equal(got, want), (got, want)


def _recorded(monkeypatch, module, name) -> list:
    """``module.name`` wrapped to record its arguments under the calling
    shard's rank (-1 outside a split): {rank: [args, ...]}."""
    from repro_torch.models.layers import model_axis
    real, seen = getattr(module, name), {}

    def spy(*args, **kwargs):
        axis = model_axis()
        seen.setdefault(-1 if axis is None else axis.rank, []).append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return seen


def _moe_setup(form):
    """(cfg, one MoE layer's float params, bf16 x, tp) of ``form``:
    reduced qwen3-moe-30b-a3b (4 experts over 2: ``experts``), or reduced
    mixtral-8x7b with 6 experts, which do not divide 4 (``expert_ff``)."""
    import dataclasses
    from repro_torch.models.layers import layer_slice
    if form == "experts":
        cfg, tp = reduced(get_config("qwen3-moe-30b-a3b")), 2
    else:
        cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                                  n_experts=6)
        tp = 4
    params = build(cfg).init_values(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal(
        (SPLIT_ROWS, SPLIT_SEQ, cfg.d_model)).astype(np.float32))
    return (cfg, layer_slice(params["segments"], 0)["block0"]["moe"],
            x.to(torch.bfloat16), tp)


@pytest.mark.parametrize("form", ["experts", "expert_ff"])
def test_split_moe_sums_to_the_unsplit(form, monkeypatch):
    """The MoE layer on each shard, the routing computed whole: in the
    ``experts`` form each shard runs its experts and all-reduces its f32
    partial of the combine; in the ``expert_ff`` form every expert runs
    on the shard's FFN columns and the ``down`` product's f32 partial is
    all-reduced. Each all-reduced sum lies within ``SPLIT_REL`` of the
    unsplit product of the shards' own inputs (the combine of every
    shard's entries; ``down`` over every shard's columns), the outputs
    within one bf16 rounding of the unsplit layer's, and the routing
    counts equal the unsplit ones."""
    from repro_torch.models import moe
    from repro_torch.models.layers import split_unit
    cfg, unit, x, tp = _moe_setup(form)
    counts = torch.zeros((SPLIT_ROWS, cfg.n_experts), dtype=torch.int32)
    want, want_c = moe.moe_ffn(unit, x, cfg, route_counts=counts)
    seen = _recorded(monkeypatch, moe,
                     "_combine" if form == "experts" else "_partial_down")
    outs = _shards(tp, lambda axis: (
        moe.moe_ffn(split_unit(unit, axis, form), x, cfg,
                    route_counts=counts), axis.reduced[-1]))
    parts = [seen[r][-1] for r in range(tp)]
    if form == "experts":
        # each shard's (tokens taken, weighted outputs) of its experts
        b, d = SPLIT_ROWS, cfg.d_model
        sel = torch.cat([a[0] for a in parts], 1)
        y_e = torch.cat([a[1].reshape(b, a[0].shape[1], -1, d)
                         for a in parts], 1)
        exact = moe._combine(sel, y_e.reshape(b, -1, d), parts[0][2])
    else:
        exact = torch.matmul(torch.cat([a[0] for a in parts], -1).double(),
                             torch.cat([a[1] for a in parts], 1).double())
    for r, ((y, c), summed) in enumerate(outs):
        _near(summed, exact, f"shard {r} sum")
        _near(y, want, f"shard {r} output", rel=2 ** -7)
        assert torch.equal(c, want_c)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_split_mamba_sums_to_the_unsplit(mode, monkeypatch):
    """A mamba block of reduced zamba2-7b (8 SSM heads of 32) on each of
    2 and 4 shards' ``inner`` channels and heads: the prefill (chunked
    SSD), or a decode step on the unsplit prefill's state (``conv``
    whole, ``h`` the shard's heads). The gated norm's mean square is one
    f32 all-reduce; ``wo``'s all-reduced f32 sum lies within
    ``SPLIT_REL`` of the unsplit product of the shards' own inputs, the
    output within one bf16 rounding of the unsplit block's, the shard's
    new ``h`` its heads of the unsplit state and the new conv tail the
    whole unsplit one, each within one bf16 rounding."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import layer_slice, model_dim, split_unit
    cfg = reduced(get_config("zamba2-7b"))
    params = build(cfg).init_values(torch.Generator().manual_seed(3), "cpu",
                                    dtype=torch.bfloat16)
    unit = layer_slice(params["segments"], 0)["block0"]["mamba"]
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal(
        (SPLIT_ROWS, SPLIT_SEQ, cfg.d_model)).astype(np.float32)) \
        .to(torch.bfloat16)
    _, state = ssm.mamba_block(unit, x, cfg, mode="prefill")
    if mode == "decode":
        x = x[:, :1] * 0.5
    run = lambda p, cache: ssm.mamba_block(p, x, cfg, mode=mode,  # noqa: E731
                                           cache=cache)
    want, want_c = run(unit, None if mode == "prefill" else
                       {k: v.clone() for k, v in state.items()})
    seen = _recorded(monkeypatch, ssm, "_wo")
    for tp in (2, 4):
        seen.clear()

        def one(axis, tp=tp):
            cache = None if mode == "prefill" else {
                "conv": state["conv"].clone(),
                "h": state["h"].chunk(tp, 1)[axis.rank].clone()}
            y, c = run(split_unit(unit, axis, "inner"), cache)
            return y, c, axis.reduced[-1]
        outs = _shards(tp, one)
        parts = [seen[r][-1] for r in range(tp)]
        exact = torch.matmul(torch.cat([a[0] for a in parts], -1).double(),
                             torch.cat([a[1] for a in parts], 0).double())
        for r, (y, c, summed) in enumerate(outs):
            _near(summed, exact.reshape(summed.shape),
                  f"tp {tp} shard {r} sum")
            _near(y, want, f"tp {tp} shard {r} output", rel=2 ** -7)
            assert model_dim(c["h"]) == 1
            _near(c["h"], want_c["h"].chunk(tp, 1)[r], "state h",
                  rel=2 ** -7)
            _near(c["conv"], want_c["conv"], "conv tail", rel=2 ** -7)


def _row_sums(monkeypatch, module, name="row_parallel_mm") -> dict:
    """``module.name`` (a row-parallel product: ``layers.row_parallel_mm``
    as a module imports it, or ``xlstm._row_mm``) wrapped to keep, under
    the calling shard's rank, its operands as the product casts them and
    the sum its all-reduce made: {rank: [(x, w, sum), ...]}. Each module
    wrapped in a list shares one record."""
    from repro_torch.models import layers as L
    seen = {}
    for m in module if isinstance(module, list) else [module]:
        real = getattr(m, name)

        def spy(x, w, dtype=torch.bfloat16, compute_dtype=None, real=real):
            kw = {} if compute_dtype is None else {
                "compute_dtype": compute_dtype}
            out = real(x, w, dtype, **kw)
            axis = L.model_axis()
            cd = compute_dtype or dtype
            keep = cd == torch.float32 and w.dtype == torch.bfloat16
            seen.setdefault(axis.rank, []).append(
                (x.to(cd), w if keep else w.to(cd), axis.reduced[-1]))
            return out
        monkeypatch.setattr(m, name, spy)
    return seen


def _sums_exact(seen: dict, tp: int) -> int:
    """Every shard's all-reduced sum of each ``row_parallel_mm`` call
    (``_row_sums``) within ``SPLIT_REL`` of the exact (f64) product of
    the shards' operands side by side. Returns the calls a shard made."""
    calls = len(seen[0])
    assert calls and all(len(seen[r]) == calls for r in range(tp))
    for j in range(calls):
        exact = sum(x.double().reshape(-1, x.shape[-1])
                    @ w.double().reshape(w.shape[0], -1)
                    for x, w, _ in (seen[r][j] for r in range(tp)))
        for r in range(tp):
            _near(seen[r][j][2].reshape(exact.shape), exact,
                  f"call {j} shard {r} sum")
    return calls


#: serve_row_tp, shard by shard: reduced gemma2-2b (softcap, local
#: window) and llava-next-34b (its untied head) with 6 heads and 2 KV
#: heads, which do not divide 4; head_dim 32 divides 4 (the cache and
#: ``wo`` split head_dim), 18 does not (the cache whole, ``wo`` on
#: d_model, column-parallel)
ROW_TP, ROW_TP_HEADS = 4, (6, 2)


def _row_tp_setup(arch, d_head):
    import dataclasses
    from repro_torch.models.layers import layer_slice
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              n_heads=ROW_TP_HEADS[0],
                              n_kv_heads=ROW_TP_HEADS[1], d_head=d_head)
    params = build(cfg).init_values(torch.Generator().manual_seed(3), "cpu",
                                    dtype=torch.bfloat16)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal(
        (SPLIT_ROWS, SPLIT_SEQ, cfg.d_model)).astype(np.float32))
    seg = layer_slice(params["segments"], 0)
    return cfg, params, seg["block1" if cfg.local_global else "block0"], \
        x.to(torch.bfloat16)


@pytest.mark.parametrize("unit,d_head", [
    ("attention-prefill", 32), ("attention-decode", 32), ("mlp", 32),
    ("head", 32), ("attention-prefill", 18), ("attention-decode", 18)],
    ids=["attention-prefill", "attention-decode", "mlp", "head",
         "attention-prefill-whole_cache", "attention-decode-whole_cache"])
def test_split_row_tp_sums_to_the_unsplit(unit, d_head, monkeypatch):
    """The reference's ``serve_row_tp`` (heads that do not divide
    ``model``), the ``param_embed`` form over 4 shards: every product
    row-parallel on the shard's d_model slice (or its head_dim slice of
    the attention's output, the MLP's columns of its activation), each
    all-reduced f32 sum within ``SPLIT_REL`` of the exact product of the
    shards' operands; the outputs within one bf16 rounding of the
    unsplit unit's. The attention (gemma2-2b's global layer: softcap 50)
    runs every head on every shard; a prefill's new cache is the
    shard's head_dim slice of the unsplit one, or the whole cache where
    head_dim does not divide 4 (``wo`` column-parallel, its output
    all-gathered); a decode step of two queries a lane over a
    12-position cache sums the scores of the shard's slice over the
    shards, or reads the whole cache, and writes its new rows there. The
    untied head (llava-next-34b) gives whole f32 logits, their argmax
    the unsplit one's."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    arch = "llava-next-34b" if unit == "head" else "gemma2-2b"
    cfg, params, layer, x = _row_tp_setup(arch, d_head)
    split_d = d_head % ROW_TP == 0
    seen = _row_sums(monkeypatch, [A, L])
    kind, _, mode = unit.partition("-")
    if kind == "attention":
        attn = layer["attn"]
        pool, pos = None, torch.tensor([5, 9])
        if mode == "decode":
            rng = np.random.default_rng(12)
            shape = (1, SPLIT_ROWS, SPLIT_CACHE, cfg.n_kv_heads, d_head)
            pool = {k: torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(torch.bfloat16) for k in ("k", "v")}
            x = x[:, :2]

        def run(p, cache):
            if mode == "prefill":
                return A.attention(p, x, cfg, mode="prefill", use_rope=True)
            return A.attention(p, x, cfg, mode="decode", cache=cache,
                               pos=pos, layer_idx=0, use_rope=True)[0], cache
        whole = None if pool is None else {k: v.clone()
                                           for k, v in pool.items()}
        want, want_c = run(attn, whole)

        def one(axis):
            mine = None if pool is None else {
                k: (v.chunk(ROW_TP, 4)[axis.rank] if split_d else v).clone()
                for k, v in pool.items()}
            p = L.split_unit(attn, axis, "param_embed")
            assert L.model_dim(p["wo"]) == (1 if split_d else 2)
            return run(p, mine)
        outs = _shards(ROW_TP, one)
        for r, (y, c) in enumerate(outs):
            _near(y, want, f"shard {r} output", rel=2 ** -7)
            for key in ("k", "v"):
                dim = 3 if mode == "prefill" else 4
                mine = want_c[key].chunk(ROW_TP, dim)[r] if split_d \
                    else want_c[key]
                assert (L.model_dim(c[key]) == 3) == (
                    split_d and mode == "prefill")
                _near(c[key], mine, f"shard {r} cache {key}", rel=2 ** -7)
    elif kind == "mlp":
        want = L.mlp(layer["mlp"], x, cfg.act)
        outs = _shards(ROW_TP, lambda axis: L.mlp(
            L.split_unit(layer["mlp"], axis, "param_embed"), x, cfg.act))
        for r, y in enumerate(outs):
            _near(y, want, f"shard {r} output", rel=2 ** -7)
    else:
        head = params["lm_head"]
        want = L.logits_head(params["embed"], x, cfg.vocab, head=head)

        def one(axis):
            h = L.split_unit(head, axis, "param_embed")
            assert L.model_dim(h) == 0
            y = L.logits_head(params["embed"], x, cfg.vocab, head=h)
            assert L.model_dim(y) is None
            return y
        for r, y in enumerate(_shards(ROW_TP, one)):
            _near(y, want, f"shard {r} logits")
            assert torch.equal(y.argmax(-1), want.argmax(-1))
    # Q/K/V's one product and wo's (row-parallel where it lies on
    # head_dim), the MLP's up, gate and down, the head
    assert _sums_exact(seen, ROW_TP) == {
        "attention": 1 + split_d, "mlp": 3, "head": 1}[kind]


#: context parallelism at a ``serve_row_tp`` prefill: unit -> (arch, the
#: layer stack, the attention's key, kind, mode, cross-attention);
#: gemma2-2b's local layer with its window cut to CP_WINDOW so it bites
#: at these lengths; whisper-tiny.en's encoder self-attention (``train``
#: mode, as ``encode`` calls it), decoder prefill and cross-attention
#: over CP_FRAMES encoder states
CP_UNITS = {
    "gemma2-global": ("gemma2-2b", "segments", "block1", "global",
                      "prefill", False),
    "gemma2-local": ("gemma2-2b", "segments", "block0", "local",
                     "prefill", False),
    "whisper-encoder": ("whisper-tiny-en", "enc_layers", "attn", "bidir",
                        "train", False),
    "whisper-decoder": ("whisper-tiny-en", "dec_layers", "self_attn",
                        "global", "prefill", False),
    "whisper-cross": ("whisper-tiny-en", "dec_layers", "cross_attn",
                      "bidir", "prefill", True),
}
CP_WINDOW, CP_FRAMES = 3, 10


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard
    library when loaded)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("d_head", [32, 18], ids=["wo_head_dim",
                                                  "wo_d_model"])
@pytest.mark.parametrize("s", [8, 7, 3])
@pytest.mark.parametrize("unit", list(CP_UNITS))
def test_context_parallel_prefill_equals_the_unsplit(unit, s, d_head):
    """The reference's context parallelism at a ``serve_row_tp`` prefill
    (``q_seq`` on ``model``), over 4 shards: shard r attends its block of
    ceil(S / 4) query positions (a short block zero-padded, the last
    past S), every head over the whole K and V, through one
    ``flash_attention`` call at ``q_offset`` r * ceil(S / 4); the blocks
    meet again by one all-to-all (``wo`` on head_dim) or all-gather
    (``wo`` on d_model). Each shard's output lies within one bf16
    rounding of the unsplit unit's, and its new cache is its head_dim
    slice of the unsplit one's, or the whole cache."""
    import dataclasses
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    arch, stack, key, kind, mode, cross = CP_UNITS[unit]
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              n_heads=ROW_TP_HEADS[0],
                              n_kv_heads=ROW_TP_HEADS[1], d_head=d_head)
    if kind == "local":
        cfg = dataclasses.replace(cfg, local_window=CP_WINDOW)
    params = build(cfg).init_values(torch.Generator().manual_seed(3), "cpu",
                                    dtype=torch.bfloat16)
    attn = L.layer_slice(params[stack], 0)[key]
    if stack == "segments":
        attn = attn["attn"]
    rng = np.random.default_rng(19)
    x, enc = (torch.from_numpy(rng.standard_normal(
        (SPLIT_ROWS, n, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
        for n in (s, CP_FRAMES))

    def run(p):
        return A.attention(p, x, cfg, kind=kind, mode=mode,
                           x_kv=enc if cross else None,
                           use_rope=stack == "segments")
    # chip_smoke.py's spy on the layer's dispatch: {rank: [(rows,
    # q_offset), ...]}, rank -1 for the unsplit call
    with _chip_smoke()._query_blocks() as calls:
        want, want_c = run(attn)
        outs = _shards(ROW_TP, lambda axis: run(
            L.split_unit(attn, axis, "param_embed")))
    blk = -(-s // ROW_TP)
    assert calls == {-1: [(s, 0)],
                     **{r: [(blk, r * blk)] for r in range(ROW_TP)}}, calls
    split_d = d_head % ROW_TP == 0
    for r, (y, c) in enumerate(outs):
        _near(y, want, f"shard {r} output", rel=2 ** -7)
        if mode == "train":
            assert c is None and want_c is None
            continue
        for k in ("k", "v"):
            assert L.model_dim(c[k]) == (3 if split_d else None)
            mine = want_c[k].chunk(ROW_TP, 3)[r] if split_d else want_c[k]
            _near(c[k], mine, f"shard {r} cache {k}", rel=2 ** -7)


def _xlstm_setup(heads):
    """(cfg, the first segment's mLSTM and sLSTM blocks' float params,
    bf16 x) of reduced xlstm-350m with ``heads`` heads."""
    import dataclasses
    from repro_torch.models.layers import layer_slice
    cfg = dataclasses.replace(reduced(get_config("xlstm-350m")),
                              n_heads=heads, n_kv_heads=heads)
    params = build(cfg).init_values(torch.Generator().manual_seed(3), "cpu")
    seg = layer_slice(params["segments"], 0)
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.standard_normal(
        (SPLIT_ROWS, SPLIT_SEQ, cfg.d_model)).astype(np.float32))
    return (cfg, {"mlstm": seg["block0"]["mlstm"],
                  "slstm": seg["block1"]["slstm"]}, x.to(torch.bfloat16))


@pytest.mark.parametrize("unit,form", [
    ("mlstm", "inner"), ("mlstm", "param_embed"), ("slstm", "heads"),
    ("slstm", "param_embed")],
    ids=["mlstm-heads", "mlstm-row_tp", "slstm-heads", "slstm-row_tp"])
def test_split_xlstm_sums_to_the_unsplit(unit, form, monkeypatch):
    """An xLSTM block of reduced xlstm-350m over 4 shards: with 4 heads
    (one a shard) in its heads form (the mLSTM's ``inner``: its inner
    channels and heads, Q/K/V and ``w_down`` row-parallel, the out-norm's
    mean square one f32 all-reduce; the sLSTM's ``heads``: its heads'
    gate weights sliced locally, the hidden states all-gathered, the
    FFN's columns), with 2 heads (which do not divide 4) in the
    ``param_embed`` form (every product row-parallel on d_model or the
    inner dim, the recurrence whole). A prefill, then a decode step on
    the state the shard's prefill left: each all-reduced f32 sum within
    ``SPLIT_REL`` of the exact product of the shards' operands, the
    outputs within one bf16 rounding of the unsplit block's, the state
    (the shard's heads of it, or whole) within one bf16 rounding of the
    unsplit state."""
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm
    heads = form != "param_embed"
    cfg, blocks, x = _xlstm_setup(4 if heads else 2)
    block = (xlstm.mlstm_block if unit == "mlstm" else xlstm.slstm_block)
    init = (xlstm.init_mlstm_cache if unit == "mlstm"
            else xlstm.init_slstm_cache)
    p = blocks[unit]
    xd = x[:, :1] * 0.5

    def run(q):
        y, state = block(q, x, cfg, mode="prefill",
                         cache=init(cfg, SPLIT_ROWS))
        yd, state = block(q, xd, cfg, mode="decode", cache=state)
        return y, yd, state
    want = run(p)
    seen = _row_sums(monkeypatch, xlstm, "_row_mm")
    outs = _shards(ROW_TP, lambda axis: run(L.split_unit(p, axis, form)))
    for r, (y, yd, state) in enumerate(outs):
        _near(y, want[0], f"shard {r} prefill output", rel=2 ** -7)
        _near(yd, want[1], f"shard {r} decode output", rel=2 ** -7)
        for key, t in state.items():
            ref = want[2][key]
            # the sLSTM's m lies on head_dim (its cache axes name
            # (batch, heads) for a (b, h, hd) leaf, as the reference's)
            dim = (2 if (unit, key) == ("slstm", "m") else 1) if heads \
                else None
            assert L.model_dim(t) == dim, key
            if dim is not None:
                ref = ref.chunk(ROW_TP, dim)[r]
            _near(t, ref, f"shard {r} state {key}", rel=2 ** -7)
    # the mLSTM: w_up and w_gate (row_tp), Q/K/V, the gates' wi / wf,
    # w_down; the sLSTM: the gates' wx and w_up (row_tp), w_down; a
    # prefill and a decode step each
    calls = {("mlstm", True): 3, ("mlstm", False): 5,
             ("slstm", True): 1, ("slstm", False): 3}[(unit, heads)]
    assert _sums_exact(seen, ROW_TP) == 2 * calls


#: a whole model's logits split shard by shard against the unsplit ones,
#: over the largest: test_torch_distributed.py's SPLIT_TOL, with its
#: argument (a row-parallel sum that lies at a bf16 rounding boundary
#: rounds the other way, and later layers carry it)
STEPS_REL = 1e-2
TIE = 0.25


@pytest.mark.parametrize("tp,form", [(2, "heads"), (4, "head_dim")])
def test_whole_steps_run_shard_by_shard(tp, form):
    """Reduced qwen3-4b's unmeshed prefill and 2 decode steps on whole
    bf16 weights, shard by shard (``run_shards`` with ``forms``: each
    unit split in the form named, as a 1 x ``tp`` mesh splits it), fed
    the unsplit run's greedy ids: every unit split in its form, each
    step's logits (gathered over the shards) within ``STEPS_REL`` of the
    unsplit ones' largest, the greedy ids equal but at near-ties."""
    from repro_torch.models import layers as L
    from repro_torch.parallel.model_axis import run_shards
    cfg = reduced(get_config("qwen3-4b"))
    model = build(cfg)
    params = model.init_values(torch.Generator().manual_seed(3), "cpu",
                               dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (SPLIT_ROWS, SPLIT_SEQ)).astype(np.int32))}
    forms = {"attention": form, "mlp": "ff", "embed": "vocab",
             "head": "vocab_cols"}

    def steps(p, ids=None, axis=None):
        decode = t_step.make_decode_step(model)
        last, cache = t_step.make_prefill_step(model)(p, batch)
        out, fed = [last], []
        for t in range(2):
            nxt = (torch.argmax(last[:, :cfg.vocab], -1).to(torch.int32)
                   [:, None] if ids is None else ids[t])
            fed.append(nxt)
            last, cache = decode(p, cache, nxt, SPLIT_SEQ + t)
            out.append(last)
        if axis is not None:
            out = [axis.all_gather(x, dim=-1) for x in out]
        return out, fed

    with torch.no_grad():
        want, ids = steps(params)

    def one(axis):
        with torch.no_grad(), L.gather_context(model=axis):
            return steps(L.layer_params(params, model.param_axes()), ids,
                         axis)[0]
    L.reset_split_counts()
    got = run_shards(tp, one, forms)[0]
    assert set(L.split_counts()) == set(forms.items())
    for t, (g, w) in enumerate(zip(got, want)):
        g, w = g[:, :cfg.vocab].float(), w[:, :cfg.vocab].float()
        _near(g, w, f"step {t} logits", STEPS_REL)
        for r in torch.nonzero(g.argmax(-1) != w.argmax(-1)).flatten():
            gap = float(w[r].max() - w[r, g[r].argmax()])
            assert gap < TIE, (t, int(r), gap)


def _split_first_layer(cfg, tp: int, **kw) -> tuple:
    """The first layer of ``cfg`` as a split over ``model`` of ``tp``
    ranks hands it to rank 0, from the DTensor placements of the serve
    rules on a 1 x ``tp`` ``fake`` group (fake tensors): (``split_counts``,
    ``whole_leaf_counts``, the layer)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import fake_tensors, fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel.model_axis import ModelAxis
    from repro_torch.parallel.sharding import (enforce_divisibility,
                                               place_tree, tree_shardings)
    model = build(cfg)
    fm = FakeTensorMode()
    with fake_world(tp):
        mesh = make_mesh((1, tp), ("data", "model"), "cpu")
        rules = rules_for(model.cfg, mesh, mode="serve")
        params = place_tree(
            fake_tensors(model.param_shapes(torch.bfloat16), fm, "cpu"),
            enforce_divisibility(tree_shardings(model.param_axes(), mesh,
                                                rules),
                                 model.param_shapes()))
        L.reset_split_counts()
        with fm, L.gather_context(model=ModelAxis(tp, 0), **kw):
            tree = L.layer_params(params, model.param_axes())
            stack = "dec_layers" if model.cfg.enc_dec else "segments"
            layer = L.gather_layer(L.layer_slice(tree[stack], 0))
        return dict(L.split_counts()), dict(L.whole_leaf_counts()), layer


def _row_tp_codeqwen():
    import dataclasses
    return dataclasses.replace(reduced(get_config("codeqwen1.5-7b")),
                               n_heads=6, n_kv_heads=2)


#: the leaves of a unit in the ``param_embed`` form that a split gathers
#: whole over ``model``: Q, K and V are whole after their row-parallel
#: sum, so their biases and qk-norm are needed whole, and so is an
#: mLSTM block's ``out_norm`` (deliberate difference 41)
ROW_TP_WHOLE = {"bq", "bk", "bv", "q_norm", "k_norm", "out_norm"}


@pytest.mark.parametrize("cfg,tp,form", [
    pytest.param(lambda: reduced(get_config("codeqwen1.5-7b")), 4,
                 "head_dim", id="codeqwen1.5-7b-reduced-bias-4"),
    pytest.param(lambda: get_config("qwen3-4b"), 16, "head_dim",
                 id="qwen3-4b-16"),
    pytest.param(lambda: get_config("qwen3-moe-30b-a3b"), 16, "head_dim",
                 id="qwen3-moe-30b-a3b-16"),
    pytest.param(lambda: get_config("mixtral-8x7b"), 16, "head_dim",
                 id="mixtral-8x7b-16"),
    pytest.param(_row_tp_codeqwen, 4, "param_embed",
                 id="codeqwen1.5-7b-reduced-row_tp-4"),
    pytest.param(lambda: get_config("gemma2-2b"), 16, "param_embed",
                 id="gemma2-2b-16"),
    pytest.param(lambda: get_config("xlstm-350m"), 16, "param_embed",
                 id="xlstm-350m-16")])
def test_split_hands_kv_weights_as_head_dim_slices(cfg, tp, form):
    """In the ``head_dim`` form (the KV heads do not divide ``model``,
    head_dim does) the split hands a rank its head_dim slice of ``wk``
    and ``wv`` (``model_dim`` 2) and of ``bk`` and ``bv`` (``model_dim``
    1; reduced codeqwen1.5-7b has QKV biases), as the reference's serve
    rules place them, and gathers none of them whole
    (``whole_leaf_counts``: only the qk-norm weights, head_dim bytes). In
    the ``param_embed`` form it gathers whole only the biases, the
    qk-norm and the mLSTM's ``out_norm`` (``ROW_TP_WHOLE``)."""
    from repro_torch.models.layers import model_dim
    cfg = cfg()
    splits, whole, layer = _split_first_layer(cfg, tp)
    assert any(f == form for _, f in splits), splits
    assert not any(f == "whole" for _, f in splits), splits
    leaves = {k for _, k in whole}
    if form == "param_embed":
        assert leaves <= ROW_TP_WHOLE, whole
        return
    assert not leaves & {"wk", "wv", "bk", "bv"}, whole
    assert leaves <= {"q_norm", "k_norm"}, whole
    attn = layer["block0"]["attn"]
    hk, d = cfg.n_kv_heads, cfg.head_dim // tp
    for key in ("wk", "wv"):
        assert tuple(attn[key].shape) == (cfg.d_model, hk, d)
        assert model_dim(attn[key]) == 2
    assert ("bk" in attn) == cfg.attn_bias
    for key in ("bk", "bv") if cfg.attn_bias else ():
        assert tuple(attn[key].shape) == (hk, d)
        assert model_dim(attn[key]) == 1


def test_unit_forms_follow_the_placements():
    """Which units a split takes, from the DTensor placements of the
    serve rules on a ``fake`` group (full-size configs on fake tensors):
    qwen3-4b on 16 ranks of ``model`` takes the head_dim form (its 8 KV
    heads do not divide 16), its MLP, embedding and head split; whisper-
    tiny.en on 4 (6 heads on 4: the serve rules shard d_model, the
    reference's ``serve_row_tp``), gemma2-2b and llava-next-34b on 16
    take the ``param_embed`` form for their attention, MLP, untied head
    and the Whisper frontend and decoder positions, whisper-tiny.en on 2
    the heads form; xlstm-350m's 4 heads on 4 take the mLSTM's ``inner``
    and the sLSTM's ``heads`` form, on 16 the ``param_embed`` form;
    mixtral-8x7b's 8 experts on 16 take the ``expert_ff`` form and
    qwen3-moe-30b-a3b's 128 the ``experts`` form, zamba2-7b's mamba blocks
    the ``inner`` form on 16 (112 SSM heads) and whole on 32, where its
    heads do not divide ``model``; a quantized cache keeps the attention
    whole. ``split_counts`` names each fallback."""
    def counts(arch, tp, **kw):
        return _split_first_layer(get_config(arch), tp, **kw)[0]

    assert counts("qwen3-4b", 16) == {
        ("embed", "vocab"): 1, ("head", "vocab_cols"): 1,
        ("attention", "head_dim"): 1, ("mlp", "ff"): 1}
    assert counts("qwen3-4b", 16, split_attention=False) == {
        ("embed", "vocab"): 1, ("head", "vocab_cols"): 1,
        ("attention", "whole"): 1, ("mlp", "ff"): 1}
    assert counts("whisper-tiny-en", 4) == {
        ("embed", "vocab"): 1, ("attention", "param_embed"): 2,
        ("mlp", "param_embed"): 1, ("frontend", "param_embed"): 1,
        ("dec_pos", "param_embed"): 1}
    assert counts("whisper-tiny-en", 2) == {
        ("embed", "vocab"): 1, ("attention", "heads"): 2, ("mlp", "ff"): 1}
    assert counts("gemma2-2b", 16) == {
        ("embed", "vocab"): 1, ("attention", "param_embed"): 2,
        ("mlp", "param_embed"): 2}
    assert counts("llava-next-34b", 16) == {
        ("embed", "vocab"): 1, ("head", "param_embed"): 1,
        ("attention", "param_embed"): 1, ("mlp", "param_embed"): 1}
    assert counts("llava-next-34b", 16, split_attention=False)[
        ("attention", "whole")] == 1
    assert counts("xlstm-350m", 4) == {
        ("embed", "vocab"): 1, ("head", "vocab_cols"): 1,
        ("mlstm", "inner"): 1, ("slstm", "heads"): 1}
    assert counts("xlstm-350m", 16) == {
        ("embed", "vocab"): 1, ("head", "param_embed"): 1,
        ("mlstm", "param_embed"): 1, ("slstm", "param_embed"): 1}
    assert counts("mixtral-8x7b", 16) == {
        ("embed", "vocab"): 1, ("head", "vocab_cols"): 1,
        ("attention", "head_dim"): 1, ("moe", "expert_ff"): 1}
    assert counts("qwen3-moe-30b-a3b", 16) == {
        ("embed", "vocab"): 1, ("head", "vocab_cols"): 1,
        ("attention", "head_dim"): 1, ("moe", "experts"): 1}
    assert counts("zamba2-7b", 16) == {
        ("embed", "vocab"): 1, ("head", "vocab_cols"): 1,
        ("attention", "heads"): 1, ("mlp", "ff"): 1, ("mamba", "inner"): 5}
    assert counts("zamba2-7b", 32)[("mamba", "whole")] == 5
