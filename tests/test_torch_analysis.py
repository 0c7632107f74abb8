"""The port's cost analysis (``repro_torch.analysis``) and baseline switch
(``repro_torch.flags``) against the JAX package's, on the CPU:

* ``model_flops`` equals the reference's for every arch and step kind;
* ``roofline_from_cost``'s three terms and dominant term on ``h100-sxm``
  (the twin of ``tests/test_hlo_analysis.py``'s roofline test, whose
  platform is the TPU), and ``Roofline.row`` the reference's keys;
* the FLOPs ``analysis.cost.measure`` traces for the plain train step and
  the prefill step of two reduced families (qwen3-4b, whisper-tiny.en)
  against ``repro.analysis.hlo.analyze_jit`` of the reference's own step
  on one device. The matrix products and attention agree exactly: the
  port's count (``FlopCounterMode``'s formulas; a kernel call at its
  spec's 2 m n k count) equals the HLO's ``dot`` FLOPs. The totals sit
  in [``FLOPS_LO``, 1]: the reference's analyzer also charges one FLOP
  per element of each fused elementwise op, which ``FlopCounterMode``
  does not count (0.86-0.99 at these shapes);
* a kernel call is one node of the trace, costed by its spec, and a
  trace launches nothing;
* ``flags.BASELINE`` reads ``REPRO_BASELINE`` as the reference's does,
  and nothing of the port reads it: ``moe_ffn`` stays grouped (the global
  dispatch is ``grouped=False``) and ``rules_for`` keeps the reference's
  default rules.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis.hlo import HloCost, analyze_jit
from repro.analysis.roofline import model_flops as j_model_flops
from repro.analysis.roofline import roofline_from_hlocost
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.model import build as j_build
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import step as j_step
from repro_torch import flags
from repro_torch.analysis import Cost, model_flops, roofline_from_cost
from repro_torch.analysis.cost import measure
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.kernels import api, registry
from repro_torch.launch.dryrun import fake_tensors, trace_train
from repro_torch.models import moe
from repro_torch.models.model import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as t_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_LO = 0.8
B, SEQ = 2, 64


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    model = build(cfg)
    n, na = model.n_params(), model.n_active_params()
    for kind in ("train", "prefill", "decode"):
        for tokens in (1, 128, 256 * 4096, 32 * 32768):
            assert model_flops(cfg, n, na, tokens, kind) == \
                j_model_flops(jcfg, n, na, tokens, kind)


def test_roofline_terms_and_dominance():
    cost = Cost(flops=1e12, bytes=1e10, collectives={"all-reduce": 1e8},
                collective_counts={"all-reduce": 1})
    rl = roofline_from_cost(cost, arch="x", shape="y", mesh="16x16",
                            chips=256, model_flops=2e14)
    assert rl.platform == "h100-sxm"
    assert rl.compute_s == pytest.approx(1e12 / 989e12)
    assert rl.memory_s == pytest.approx(1e10 / 3.35e12)
    assert rl.collective_s == pytest.approx(1e8 / 450e9)
    assert rl.dominant == "memory"
    assert rl.bound_s == rl.memory_s
    assert rl.hlo_flops == pytest.approx(1e12 * 256)
    assert rl.useful_flops_ratio == pytest.approx(2e14 / (1e12 * 256))
    assert rl.roofline_fraction == pytest.approx(
        2e14 / (256 * 989e12) / rl.memory_s)
    ref = roofline_from_hlocost(
        HloCost(flops=1e12, bytes=1e10, collective_bytes=1e8,
                collectives={"all-reduce": 1e8}, collective_counts={},
                unknown_trip_loops=[], unknown_customcalls=[]),
        arch="x", shape="y", mesh="16x16", chips=256, model_flops=2e14)
    assert rl.row().keys() == ref.row().keys()


def _batch(cfg, kind: str) -> dict:
    out = {"tokens": np.zeros((B, SEQ), np.int32)}
    if kind == "train":
        out["targets"] = np.zeros((B, SEQ), np.int32)
    if cfg.enc_dec:
        out["enc_frames"] = np.zeros((B, SEQ, cfg.d_model), np.float32)
    return out


def _reference_cost(arch: str, kind: str, batch: dict) -> HloCost:
    jm = j_build(j_reduced(j_get_config(arch)))
    specs = {k: jax.ShapeDtypeStruct(
        v.shape, jnp.int32 if v.dtype == np.int32 else jnp.bfloat16)
        for k, v in batch.items()}
    if kind == "train":
        state = jax.eval_shape(lambda k: j_step.init_train_state(jm, k),
                               jax.random.key(0))
        return analyze_jit(j_step.make_train_step(jm, JAdamWConfig()),
                           state, specs)
    params = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.bfloat16 if s.dtype == jnp.float32 else s.dtype),
        jax.eval_shape(jm.init_values, jax.random.key(0)))
    return analyze_jit(j_step.make_prefill_step(jm), params, specs)


def _port_cost(arch: str, kind: str, batch: dict) -> Cost:
    model = build(reduced(get_config(arch)))
    tb = {k: torch.from_numpy(v).to(
        torch.int32 if v.dtype == np.int32 else torch.bfloat16)
        for k, v in batch.items()}
    if kind == "train":
        return trace_train(model, AdamWConfig(), device="cpu", batch=tb)
    fm = FakeTensorMode()
    params = fake_tensors(model.param_shapes(torch.bfloat16), fm, "cpu")
    with fm:
        _, cost = measure(t_step.make_prefill_step(model), params,
                          fake_tensors(tb, fm, "cpu"))
    return cost


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny-en"])
def test_traced_flops_against_the_reference_hlo(arch, kind):
    batch = _batch(reduced(get_config(arch)), kind)
    ref = _reference_cost(arch, kind, batch)
    before = api.launch_counts()
    cost = _port_cost(arch, kind, batch)
    assert api.launch_counts() == before
    assert cost.flops == pytest.approx(ref.flops_by_op["dot"], rel=1e-12)
    assert FLOPS_LO <= cost.flops / ref.flops <= 1.0, (cost.flops, ref.flops)
    assert cost.bytes > 0 and cost.peak_bytes > 0
    if kind == "prefill":
        # every product and attention of the prefill but the 3-D (QKV)
        # projections is a kernel call, one node costed by its spec
        assert set(cost.kernels) == {"fp16_matmul", "flash_attention"}
        kernel_flops = sum(v for k, v in cost.flops_by_op.items()
                           if k.startswith("kernel:"))
        assert set(cost.flops_by_op) - {"kernel:fp16_matmul",
                                        "kernel:flash_attention"} == {"mm"}
        assert 0 < kernel_flops < cost.flops
        # the plain attention's own ops run unseen inside its node
        assert not {"bmm", "amax", "where"} & set(cost.bytes_by_op)


def test_kernel_node_is_costed_by_its_spec():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)) \
        .to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32)) \
        .to(torch.bfloat16)
    fm = FakeTensorMode()
    fake = fake_tensors({"x": x, "w": w}, fm, "cpu")
    fx, fw = fake["x"], fake["w"]
    with fm:
        out, cost = measure(api.dispatch, "fp16_matmul", fx, fw,
                            out_dtype=torch.float32)
    spec = registry.get_op("fp16_matmul").spec(x, w)
    assert tuple(out.shape) == (8, 32)
    assert cost.kernels == {"fp16_matmul": 1}
    assert cost.flops == spec.flops == 2 * 8 * 64 * 32
    assert cost.bytes == x.nbytes + w.nbytes + 8 * 32 * 4
    assert [r[1] for r in cost.top_instructions()] == ["kernel:fp16_matmul"]


def test_baseline_selects_the_global_moe_dispatch(monkeypatch):
    """The reference's baseline MoE form is ``grouped=False``; the flag
    leaves ``moe_ffn``'s default, the grouped form, alone."""
    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    grouped = moe.moe_ffn(p, x, cfg, grouped=True)
    global_ = moe.moe_ffn(p, x, cfg, grouped=False)
    assert not torch.equal(grouped, global_)
    assert torch.equal(moe.moe_ffn(p, x, cfg), grouped)
    monkeypatch.setattr(flags, "BASELINE", True)
    assert torch.equal(moe.moe_ffn(p, x, cfg), grouped)


_BASELINE_RULES = """
from repro_torch import flags
from repro_torch.configs import get_config, list_archs
from repro_torch.parallel.sharding import rules_for
from repro import flags as j_flags
from repro.configs import get_config as j_get_config
from repro.parallel.sharding import rules_for as j_rules_for

class Mesh:
    shape = {"data": 16, "model": 16}

assert flags.BASELINE and j_flags.BASELINE
j_flags.BASELINE = False
for arch in list_archs():
    for mode in ("train", "serve"):
        got = rules_for(get_config(arch), Mesh(), mode)
        assert got == j_rules_for(j_get_config(arch), Mesh(), mode), arch
r = rules_for(get_config("qwen3-4b"), Mesh(), "serve")
print(r["cache_seq"], r["head_dim"])
"""


def test_baseline_rules_equal_the_reference_in_a_subprocess():
    """Under ``REPRO_BASELINE=1`` both packages read the flag, and the
    port's rules stay the reference's default ones (the port keeps no
    baseline branch)."""
    env = dict(os.environ, REPRO_BASELINE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _BASELINE_RULES],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # qwen3-4b's 8 KV heads do not divide 16: the default rules shard
    # the serving cache on its head dim, not its sequence
    assert out.stdout.split() == ["None", "model"]
    assert not flags.BASELINE
