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
  subprocess builds over 512 forced host devices).
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
