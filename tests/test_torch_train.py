"""The port's train step against the JAX package's, on the CPU, at the
reduced configurations (d_model 128, heads of 32, vocab 512) with the
reference's parameters carried across by the bridge and the reference's
``batch_for_step`` batches (2 x 32).

Loss and gradients, for the seven families: the reference side is
``value_and_grad(_loss_fn)`` (jitted), the port's
``train.step.value_and_grad``. Both train forwards run the bf16
products on non-kernel bindings (the reference's XLA under its
``grad_safe_context``, the port's differentiable torch ones under its
own); the port's plain flash attention keeps P in f32 where XLA rounds
it to bf16, so the two differ by bf16 roundings. Tolerances, with the
values measured on this CPU:

* loss within ``LOSS_RTOL`` = 1e-3 relative (measured 6e-6 to 2.7e-4,
  gemma2-2b the largest);
* ``global_norm(grads)`` within ``GNORM_RTOL`` = 1e-2 relative (2e-5 to
  5.5e-3; zamba2-7b's mamba blocks the largest, xlstm-350m 3e-3);
* every leaf carrying at least ``LEAF_SHARE`` = 1e-3 of the reference's
  gradient norm has cosine similarity >= ``COS_MIN`` = 0.99 to the
  reference's leaf (lowest measured 0.9927, zamba2-7b's ``dt_bias`` of
  block 3; whisper-tiny.en, qwen3-4b, gemma2-2b, the MoE and llava
  >= 0.9997); a leaf below that share is too small for its direction
  to be measured against bf16 noise (zamba2-7b's block-4 ``A_log``,
  8 values at 7.7e-4 of the norm, has cosine 0.984; xlstm-350m's sLSTM
  input-gate bias has a gradient of 4.4e-9, i.e. 2e-10 of the norm, in
  the reference and 5.3e-9 in the port), so there the difference must
  stay within ``LEAF_SHARE`` of the global norm.

One whole train step (AdamW, lr 1e-3, no warmup) against the
reference's ``make_train_step``: the loss, gradient norm and lr within
the tolerances above (lr 1e-6), the step counter equal, and every
parameter within 2 * lr (+1e-7 for the f32 rounding of the two updates)
of the reference's: Adam's first step moves each element by about
+-lr, so a gradient element near zero whose sign differs between the
two moves it 2 * lr apart (1.9555e-3 of 1.9560e-3 measured). The
moments within ``MOMENT_RTOL`` = 0.05 in relative norm (0.007-0.017
measured).

The step's semantics: ``n_micro=2`` equals ``n_micro=1`` on the same
batch (the loss within f32 summation order, the gradients within the
bf16 roundings of their weight products: ``MICRO_RTOL``), ``remat`` gives gradients equal to
those without it bit for bit, the grad-safe route records the
reference's ``(op, decision)`` pairs with ``xla`` read as ``torch`` (and
xlstm-350m's ``slstm_scan``, which the port's sLSTM block dispatches
where the reference's runs an inline scan), the
f32 ``fp16_matmul`` binding is one autograd node, and the launcher runs.
"""

import contextlib
import dataclasses
import io
import math
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import batch_for_step
from repro.kernels import api as j_api
from repro.models.model import build as j_build
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import step as j_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.workload import KernelSpec
from repro_torch.kernels import api
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build
from repro_torch.optim.adamw import AdamWConfig, global_norm, init_state, \
    leaves
from repro_torch.train import step as t_step

FAMILIES = ("whisper-tiny-en", "qwen3-4b", "gemma2-2b", "qwen3-moe-30b-a3b",
            "xlstm-350m", "zamba2-7b", "llava-next-34b")
LOSS_RTOL = 1e-3
GNORM_RTOL = 1e-2
COS_MIN = 0.99
LEAF_SHARE = 1e-3
MOMENT_RTOL = 0.05
# n_micro=2 against n_micro=1: the loss within f32 order (1e-6; 7e-8
# measured). A bf16 product's weight gradient is rounded to bf16 once
# per backward, so two microbatches sum two such roundings where one
# batch has one: the gradients differ by bf16 noise, 2.0e-3 (whisper)
# and 2.4e-3 (qwen3) in relative norm and the gradient norm by 1.4e-5
# and 9.3e-6, both measured; the reference's microbatches round alike
MICRO_RTOL = 1e-2
MICRO_GNORM_RTOL = 1e-4
SEQ, BATCH = 32, 2
_SETUP: dict = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: with torch's intra-op threads one per core
    in every test worker, they wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch, **replace):
    """(reference model, port model, reference params, bridged params,
    a reference batch) of the reduced ``arch``."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _SETUP:
        cfg = dataclasses.replace(reduced(get_config(arch)), **replace)
        tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **replace)
        jm, tm = j_build(cfg), build(tcfg)
        jp = jm.init_values(jax.random.key(1))
        _SETUP[key] = (jm, tm, jp, _bridge(jp),
                       batch_for_step(cfg, SEQ, BATCH, seed=0, step=0))
    return _SETUP[key]


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_the_reference(arch):
    jm, tm, jp, tp, b = _setup(arch)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_step._loss_fn(jm, p, b), has_aux=True))(jp, b)
    tl, tg = t_step.value_and_grad(tm, tp, _tb(b))
    assert math.isclose(float(tl), float(jl), rel_tol=LOSS_RTOL), \
        (float(tl), float(jl))

    want, got = _np_leaves(jg), [x.float().numpy() for x in leaves(tg)]
    assert [w.shape for w in want] == [g.shape for g in got]
    jnorm = float(np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2))
                              for w in want)))
    assert math.isclose(float(global_norm(tg)), jnorm,
                        rel_tol=GNORM_RTOL), (float(global_norm(tg)), jnorm)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, w, g in zip(names, want, got):
        nw = float(np.linalg.norm(w))
        if nw >= LEAF_SHARE * jnorm:
            cos = float(np.sum(w * g) / (nw * np.linalg.norm(g)))
            assert cos >= COS_MIN, (name, cos)
        else:
            assert float(np.linalg.norm(g - w)) <= LEAF_SHARE * jnorm, name


@pytest.mark.parametrize("arch", ("whisper-tiny-en", "qwen3-4b"))
def test_one_train_step_matches_the_reference(arch):
    jm, tm, jp, tp, b = _setup(arch)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jstate = {"params": jp, "opt": j_step.adamw.init_state(jp)}
    jstate, jmet = jax.jit(j_step.make_train_step(jm, JAdamWConfig(**kw)))(
        jstate, b)
    tp = _bridge(jp)        # a fresh copy: the port's step works in place
    tstate = {"params": tp, "opt": init_state(tp)}
    tstate, tmet = t_step.make_train_step(tm, AdamWConfig(**kw))(tstate, b)

    assert set(tmet) == {"loss", "grad_norm", "lr"}
    for k, tol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL),
                   ("lr", 1e-6)):
        assert tmet[k].dim() == 0
        assert math.isclose(float(tmet[k]), float(jmet[k]), rel_tol=tol), k
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    bound = 2 * float(jmet["lr"]) + 1e-7
    for w, g in zip(_np_leaves(jstate["params"]),
                    leaves(tstate["params"])):
        assert float(np.abs(g.float().numpy() - w).max()) <= bound
    for key in ("m", "v"):
        w = np.concatenate([x.ravel() for x in
                            _np_leaves(jstate["opt"][key])])
        g = np.concatenate([x.float().numpy().ravel()
                            for x in leaves(tstate["opt"][key])])
        assert np.linalg.norm(g - w) <= MOMENT_RTOL * np.linalg.norm(w), key


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ("whisper-tiny-en", "qwen3-4b"))
def test_n_micro_2_equals_n_micro_1(arch):
    _, tm, _, tp, b = _setup(arch)
    b = batch_for_step(reduced(get_config(arch)), SEQ, 4, seed=0, step=3)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    outs = []
    for n in (1, 2):
        state = {"params": _clone(tp), "opt": init_state(tp)}
        outs.append(t_step.make_train_step(tm, cfg, n_micro=n)(state, b))
    (s1, m1), (s2, m2) = outs
    # the mean of the two halves' token means is the whole batch's mean
    # when both halves count the same tokens (no ignored targets here)
    assert math.isclose(float(m2["loss"]), float(m1["loss"]), rel_tol=1e-6)
    assert math.isclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                        rel_tol=MICRO_GNORM_RTOL)
    a = torch.cat([x.ravel() for x in leaves(s1["opt"]["m"])])
    c = torch.cat([x.ravel() for x in leaves(s2["opt"]["m"])])
    assert float((c - a).norm()) <= MICRO_RTOL * float(a.norm())
    bound = 2 * float(m1["lr"]) + 1e-7
    for a, c in zip(leaves(s1["params"]), leaves(s2["params"])):
        assert float((c - a).abs().max()) <= bound


def test_n_micro_must_split_the_batch():
    _, tm, _, tp, b = _setup("qwen3-4b")
    step = t_step.make_train_step(tm, AdamWConfig(), n_micro=3)
    with pytest.raises(ValueError, match="microbatches"):
        step({"params": tp, "opt": init_state(tp)}, b)


@pytest.mark.parametrize("arch", ("whisper-tiny-en", "qwen3-4b",
                                  "xlstm-350m", "zamba2-7b"))
def test_remat_gradients_equal_without_it(arch):
    _, tm, _, tp, b = _setup(arch)
    tmr = build(dataclasses.replace(tm.cfg, remat=True))
    assert not tm.cfg.remat
    l0, g0 = t_step.value_and_grad(tm, tp, _tb(b))
    l1, g1 = t_step.value_and_grad(tmr, tp, _tb(b))
    assert torch.equal(l0, l1)
    for a, c in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, c)


def test_remat_leaves_prefill_alone():
    """Prefill under a remat config runs no checkpoint (and the logits
    equal the config without it's)."""
    _, tm, _, tp, b = _setup("qwen3-4b")
    tmr = build(dataclasses.replace(tm.cfg, remat=True))
    batch = {"tokens": torch.from_numpy(b["tokens"])}
    prefill = t_step.make_prefill_step(tmr)
    with torch.no_grad():
        l1, _ = prefill(tp, batch)
        l0, _ = t_step.make_prefill_step(tm)(tp, batch)
    assert torch.equal(l0, l1)


@pytest.mark.parametrize("arch", ("whisper-tiny-en", "qwen3-4b",
                                  "xlstm-350m"))
def test_grad_safe_route_records_the_references_pairs(arch):
    jm, tm, jp, tp, b = _setup(arch)
    j_api.reset_dispatch_log()
    jax.eval_shape(lambda p: j_step._loss_fn(jm, p, b)[0], jp)
    want = {(op, dec, "torch" if be == "xla" else be)
            for (op, dec, be) in j_api.dispatch_counters()}
    api.reset_dispatch_log()
    t_step.value_and_grad(tm, tp, _tb(b))
    got = set(api.dispatch_counters())
    assert all(r.tag == "grad_safe" for r in api.dispatch_trace())
    if arch == "xlstm-350m":
        # the port's sLSTM block runs its recurrence through the
        # slstm_scan op, where the reference's model runs an inline
        # lax.scan that dispatches nothing (models/xlstm.py)
        got.remove(("slstm_scan", "accel", "torch"))
    assert got == want


def test_decide_under_the_grad_safe_context():
    spec = KernelSpec("fp16_matmul", m=8, n=64, k=64, dtype="f16")
    assert api.decide("fp16_matmul", spec, on_cuda=True) == ("accel",
                                                              "cuda")
    with api.use_context(api.grad_safe_context()):
        assert api.decide("fp16_matmul", spec, on_cuda=True) == \
            ("accel", "torch")
    # the law's decision is kept: over a budget of 1 KB the call is HOST
    with api.use_context(api.grad_safe_context(
            api.DispatchContext(vmem_budget=1024))):
        assert api.decide("fp16_matmul", spec, on_cuda=True) == \
            ("host", "torch")
    forced = api.grad_safe_context(api.DispatchContext(force_backend="cuda"))
    assert forced.force_backend is None and forced.grad_safe
    # outside the context the plain route on CUDA tensors still raises
    with pytest.raises(ValueError, match="plain version on the card"):
        api.decide("fp16_matmul", spec, on_cuda=True,
                   ctx=api.DispatchContext(force_backend="torch"))


def _grad_nodes(t) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return len(seen)


def test_f32_fp16_matmul_binding_is_one_product():
    """The untied f32 head's product (K = 256) under the grad-safe route:
    a single matmul node, where the plain ``_rowwise_f32`` makes 3 * K."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 256, generator=gen, requires_grad=True)
    w = torch.randn(256, 512, generator=gen, requires_grad=True)
    with api.use_context(api.grad_safe_context()):
        y = api.dispatch("fp16_matmul", x, w, out_dtype=torch.float32)
    # the matmul, the view of x it makes and the two leaves' accumulators
    assert _grad_nodes(y) <= 5
    plain = api.dispatch("fp16_matmul", x, w, out_dtype=torch.float32)
    assert _grad_nodes(plain) > 3 * 256
    torch.testing.assert_close(y, plain, rtol=1e-5, atol=1e-5)
    # bf16 operands: one bf16 product, no f32 copy of either
    with api.use_context(api.grad_safe_context()):
        yb = api.dispatch("fp16_matmul", x.to(torch.bfloat16),
                          w.to(torch.bfloat16), out_dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16
    assert "MmBackward" in type(yb.grad_fn).__name__ or \
        "MmBackward" in str(yb.grad_fn.next_functions)


def test_prefill_and_decode_steps_match_the_reference():
    jm, tm, jp, tp, b = _setup("qwen3-4b")
    tokens = b["tokens"][:, :16]
    jl, jc = j_step.make_prefill_step(jm)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl, tc = t_step.make_prefill_step(tm)(
            tp, {"tokens": torch.from_numpy(tokens)})
    w = np.asarray(jl, np.float32)
    assert np.abs(tl.numpy() - w).max() <= 0.03 * np.abs(w).max()
    nxt = np.argmax(w, -1).astype(np.int32)[:, None]
    jd, _ = j_step.make_decode_step(jm)(jp, jc, jnp.asarray(nxt), 16)
    with torch.no_grad():
        td, _ = t_step.make_decode_step(tm)(tp, tc, torch.from_numpy(nxt),
                                            torch.tensor(16))
        tok, _ = t_step.make_decode_step(tm, sample=True)(
            tp, tc, torch.from_numpy(nxt), torch.tensor(16))
    w = np.asarray(jd, np.float32)
    assert np.abs(td.numpy() - w).max() <= 0.03 * np.abs(w).max()
    assert tok.dtype == torch.int32 and tok.shape == (BATCH,)


def test_cross_entropy_ignores_masked_targets():
    logits = torch.randn(2, 3, 7, generator=torch.Generator().manual_seed(0))
    tgt = torch.tensor([[1, -1, 3], [-1, -1, -1]])
    want = j_step.cross_entropy(jnp.asarray(logits.numpy()),
                                jnp.asarray(tgt.numpy()))
    got = t_step.cross_entropy(logits, tgt)
    assert math.isclose(float(got), float(want), rel_tol=1e-6)
    assert float(t_step.cross_entropy(logits, torch.full((2, 3), -1))) == 0


# ----------------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------------

def test_launcher_trains_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_cli.main(["--arch", "qwen3-4b", "--reduced", "--device",
                              "cpu", "--steps", "4", "--batch", "2",
                              "--seq", "32", "--ckpt", str(tmp_path)])
    text = out.getvalue()
    assert "step     1  loss" in text and "done: 4 steps" in text, text
    assert res.final_step == 4 and all(np.isfinite(res.losses))
    assert (tmp_path / "step-000000004" / "manifest.json").exists()


def test_launcher_never_resumes_a_run_it_was_not_pointed_at(monkeypatch,
                                                            tmp_path):
    """Without ``--ckpt`` each run checkpoints into a new directory under
    the temporary directory and trains from its own init."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    runs = []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = train_cli.main(["--arch", "qwen3-4b", "--reduced",
                                  "--device", "cpu", "--steps", "2",
                                  "--batch", "2", "--seq", "16"])
        line = next(x for x in out.getvalue().splitlines()
                    if x.startswith("checkpoints: "))
        runs.append((line.split(": ", 1)[1], res))
    (dir_a, res_a), (dir_b, res_b) = runs
    assert dir_a != dir_b
    assert os.path.dirname(dir_a) == os.path.dirname(dir_b) == str(tmp_path)
    assert len(res_a.losses) == len(res_b.losses) == 2
    assert res_a.losses == res_b.losses


def test_launcher_needs_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1",
                        "--ckpt", str(tmp_path)])


@pytest.mark.parametrize("flag", [["--mesh", "2x2"], ["--devices", "4"],
                                  ["--compress-grads"]])
def test_launcher_refuses_multi_device_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu"]
                       + flag)
    assert e.value.code != 0
    assert "parallel" in capsys.readouterr().err
