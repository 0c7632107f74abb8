"""The port's parallel layer on four ``gloo`` ranks of this CPU, one
process group for the module (spawned once; each case runs on every
rank and reports per rank), against the port's single-device step and
the JAX package's numbers:

* the 2x2 ``("data", "model")`` sharded train step of the seven
  families (reduced) equals the single-device step: its gradients, leaf
  by leaf, within 1e-2 of the leaf's largest (two and a half bf16 ulps:
  the forwards compute in bf16, so a gradient element's last rounding
  moves with the split of the rows) plus 1e-7, and the gradient norm
  within rtol 1e-4; after the step, within the reference's own bounds
  (``tests/test_distributed.py``): the loss within rtol 2e-4, the
  parameters within rtol 2e-2, atol 2e-4. (At the reference's
  learning rate the first step moves a parameter by ~1e-5, under the
  parameter bound: the gradient check is the one that sees a wrong
  gradient.);
* the sharded step gathers one layer at a time: with ``remat`` on
  (qwen3-4b and whisper-tiny.en, reduced, 4 layers), the bytes of
  gathered parameter data alive at once, read from the storages'
  lifetimes, stay within the largest layer's gathered bytes plus the
  leaves outside the stacks, and a planted whole-tree gather breaks
  that bound;
* the meshed prefill + decode of qwen3-4b gives the unmeshed logits
  within 1e-5 of the largest;
* ``compressed_psum``'s mean is within 1e-6 of the mean over ranks of
  the reference's ``dequantize_grad(quantize_grad(g_r + e_r))``, and each
  rank's new residual equals the reference's;
* the compressed step tracks the exact one over 5 steps (the
  reference's bounds: loss within 0.05 each step, relative parameter
  drift < 5e-3), its gradient norm within rtol 2e-3 of the exact one's
  each step; and one step with no warmup moves the parameters the way
  the exact step does (the cosine of the two updates above 0.95);
* a checkpoint saved from a 2x2 mesh restores onto 4x1 bit for bit with
  the placements of ``data`` 4, and the reference's single-device
  checkpoint restores onto a 2x2 mesh with equal leaves;
* the GPipe pipeline over a ``("pipe",)`` mesh of 4 (L 8, D 16, 6
  microbatches of tanh layers) equals the sequential forward at 2e-5,
  and each rank's stage gradient its slice of the single-process
  gradient at 1e-5;
* ``constrain`` redistributes a DTensor activation under a context;
* a preemption that one rank sees stops every rank at the same step.

The launcher then trains gemma2-2b on ``--devices 4 --mesh 2x2`` (its
own four ranks) and a rerun resumes.
"""

import datetime
import json
import os
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
FAMILIES = ("whisper-tiny-en", "qwen3-4b", "gemma2-2b", "qwen3-moe-30b-a3b",
            "xlstm-350m", "zamba2-7b", "llava-next-34b")
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 2e-2, 2e-4
GRAD_TOL, GRAD_ATOL, GRAD_NORM_RTOL = 1e-2, 1e-7, 1e-4
SERVE_TOL = 1e-5
PSUM_TOL = 1e-6
COMPRESSED_LOSS, COMPRESSED_DRIFT = 0.05, 5e-3
COMPRESSED_NORM_RTOL, COMPRESSED_COSINE = 2e-3, 0.95
PIPE_FWD_RTOL, PIPE_GRAD_RTOL = 2e-5, 1e-5
# the module's ranks take ~25 s here; a hung collective fails the module
# at this wall rather than running into the suite's limit
RANKS_DEADLINE_S = 300
GATHER_ARCHS = ("qwen3-4b", "whisper-tiny-en")
CASES = ([f"sharded_step[{a}]" for a in FAMILIES]
         + [f"layer_gather_peak[{a}]" for a in GATHER_ARCHS]
         + ["meshed_serving", "compressed_psum", "compressed_step",
            "elastic_restore", "reference_checkpoint_onto_mesh",
            "pipeline", "constrain", "preemption_agreed"])


# ----------------------------------------------------------------------------
# The cases, run on every rank
# ----------------------------------------------------------------------------

def _port(arch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build
    return build(reduced(get_config(arch)))


def _state(model, seed=0):
    from repro_torch.train import step as S
    return S.init_train_state(model, torch.Generator().manual_seed(seed),
                              "cpu")


def _mesh(shape, names):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, names)


def case_sharded_step(arch, work):
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.parallel.sharding import place_tree, rules_for
    from repro_torch.train import step as S
    model = _port(arch)
    opt = AdamWConfig(lr=1e-3, total_steps=10)
    batch = batch_for_step(model.cfg, 32, 4, seed=0, step=0)
    want_loss, want_g = S.value_and_grad(
        model, _state(model)["params"],
        {k: torch.as_tensor(v) for k, v in batch.items()})
    ref, ref_m = S.make_train_step(model, opt)(_state(model), batch)
    mesh = _mesh((2, 2), ("data", "model"))
    rules = rules_for(model.cfg, mesh, mode="train")
    state = place_tree(_state(model), S.state_shardings(model, mesh, rules))
    assert any(p.is_shard() for x in leaves(state["params"])
               for p in x.placements)

    loss, grads = S.sharded_value_and_grad(
        model, state["params"], S.local_rows(batch, mesh, "cpu"), mesh,
        model.param_axes())
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    for i, (a, b) in enumerate(zip(leaves(grads), leaves(want_g))):
        assert type(a).__name__ == "DTensor"
        a, b = a.full_tensor().float(), b.float()
        gap, top = float((a - b).abs().max()), float(b.abs().max())
        assert gap <= GRAD_TOL * top + GRAD_ATOL, (i, tuple(b.shape), gap,
                                                    top)

    step = S.make_train_step(model, opt, mesh=mesh, rules=rules)
    state, m = step(state, S.shard_batch(batch, mesh))
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]),
                               rtol=GRAD_NORM_RTOL)
    for a, b in zip(leaves(state["params"]), leaves(ref["params"])):
        assert type(a).__name__ == "DTensor"
        np.testing.assert_allclose(a.full_tensor().float().numpy(),
                                   b.float().numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


class GatheredBytes:
    """The bytes of gathered parameter data alive at once, read from the
    storages' lifetimes: a storage is gathered data when an all-gather
    made it, or when a ``cat`` made it from views of one such storage
    (DTensor's reassembly of a gather along a dim other than 0); views
    share their storage. Each is alive from the op that made it until
    its storage is freed (a weakref finalizer). The sum is read at every
    op that takes data other than gathered data (the layers'
    computations, the backward), when a gather's staging buffers are
    gone: the peak of what the computations see gathered at once."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return outer._op(func, types, args, kwargs or {})

        self.mode = Mode()
        self.alive = {}
        self.peak = 0

    def _op(self, func, types, args, kwargs):
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
               for t in types):
            return NotImplemented   # seen again on the local tensors
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return out              # DTensor's sharding propagation
        ins = {self._key(t) for t in tree_leaves((args, kwargs))
               if type(t) is torch.Tensor}
        if func.__name__.startswith("all_gather") or (
                func is torch.ops.aten.cat.default and len(ins) == 1
                and ins <= self.alive.keys()):
            for t in tree_leaves(out):
                self._track(t)
        elif not ins <= self.alive.keys() or not ins:
            self.peak = max(self.peak, sum(self.alive.values()))
        return out

    @staticmethod
    def _key(t):
        return t.untyped_storage().data_ptr()

    def _track(self, t):
        import weakref
        st = t.untyped_storage()
        key = self._key(t)
        if key not in self.alive:
            self.alive[key] = st.nbytes()
            weakref.finalize(st, self.alive.pop, key, None)


def _gather_bound(model):
    """(the largest layer's f32 parameter bytes, the bytes of the
    parameters outside the layer stacks)."""
    from repro_torch.models.model import tree_paths
    layers, rest = {}, 0
    for path, s in tree_paths(model.param_specs()):
        n = int(np.prod(s.shape)) * 4
        if s.axes[:1] == ("layers",):
            stack = path.split("/")[0]
            layers[stack] = layers.get(stack, 0) + n // s.shape[0]
        else:
            rest += n
    return max(layers.values()), rest


def case_layer_gather_peak(arch, work):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.models.layers import gathered
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.sharding import place_tree, rules_for
    from repro_torch.train import step as S
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True,
                              n_layers=4)
    model = build(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    rules = rules_for(cfg, mesh, mode="train")
    state = place_tree(_state(model), S.state_shardings(model, mesh, rules))
    rows = S.local_rows(batch_for_step(cfg, 32, 4, seed=0, step=0), mesh,
                        "cpu")
    layer, rest = _gather_bound(model)

    def peak():
        seen = GatheredBytes()
        with seen.mode:
            S.sharded_value_and_grad(model, state["params"], rows, mesh,
                                     model.param_axes())
        return seen.peak

    got = peak()
    assert 0 < got <= layer + rest, (got, layer, rest)
    whole = S.layer_params
    S.layer_params = lambda params, axes, gp=None: tree_map(
        lambda p: gathered(p, gp), params)
    try:
        planted = peak()
    finally:
        S.layer_params = whole
    assert planted > layer + rest, (planted, layer, rest)


def case_meshed_serving(work):
    from repro_torch.optim.adamw import leaves, tree_map
    from repro_torch.parallel.sharding import (enforce_divisibility,
                                               place_tree, rules_for,
                                               tree_shardings)
    from repro_torch.train import step as S
    model = _port("qwen3-4b")
    params = model.init_values(torch.Generator().manual_seed(3), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, model.cfg.vocab, (4, 16)).astype(np.int32))
    nxt = torch.full((4, 1), 7, dtype=torch.int32)
    logits0, cache = S.make_prefill_step(model)(params, {"tokens": tokens})
    want, _ = S.make_decode_step(model)(params, cache, nxt, 16)

    mesh = _mesh((2, 2), ("data", "model"))
    rules = rules_for(model.cfg, mesh, mode="serve")
    sh = enforce_divisibility(tree_shardings(model.param_axes(), mesh, rules),
                              model.param_shapes())
    placed = place_tree(tree_map(lambda p: p.clone(), params), sh)
    logits1, dcache = S.make_prefill_step(model, mesh=mesh, rules=rules)(
        placed, {"tokens": tokens})
    assert any(type(c).__name__ == "DTensor" and
               any(p.is_shard() for p in c.placements)
               for c in leaves(dcache))
    got, dcache = S.make_decode_step(model, mesh=mesh, rules=rules)(
        placed, dcache, nxt, 16)
    for a, b in ((logits1, logits0), (got, want)):
        a, b = a.float().numpy(), b.float().numpy()
        assert np.abs(a - b).max() <= SERVE_TOL * np.abs(b).max(), \
            np.abs(a - b).max()


def case_compressed_psum(work):
    from repro_torch.parallel.collectives import compressed_psum
    ref = np.load(os.path.join(work, "psum.npz"))
    rank = dist.get_rank()
    mesh = _mesh((WORLD,), ("data",))
    g = torch.from_numpy(ref["g"][rank])
    e = torch.from_numpy(ref["e"][rank])
    mean, new_err = compressed_psum([g], [e.clone()], mesh, ("data",))
    np.testing.assert_allclose(mean[0].numpy(), ref["mean"], rtol=0,
                               atol=PSUM_TOL)
    np.testing.assert_array_equal(new_err[0].numpy(), ref["err"][rank])


def case_compressed_step(work):
    from repro_torch.data.synthetic import batch_for_step
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.train import step as S
    model = _port("qwen3-4b")
    opt = AdamWConfig(lr=1e-3, total_steps=50)
    mesh = _mesh((WORLD,), ("data",))
    exact = S.make_train_step(model, opt)
    comp = S.make_compressed_train_step(model, opt, mesh)
    se = _state(model)
    sc = S.init_compressed_state(model, torch.Generator().manual_seed(0),
                                 mesh, "cpu")
    for t in range(5):
        batch = batch_for_step(model.cfg, 32, 8, seed=0, step=t)
        se, me = exact(se, batch)
        sc, mc = comp(sc, batch)
        assert abs(float(me["loss"]) - float(mc["loss"])) \
            < COMPRESSED_LOSS, (t, float(me["loss"]), float(mc["loss"]))
        np.testing.assert_allclose(float(mc["grad_norm"]),
                                   float(me["grad_norm"]),
                                   rtol=COMPRESSED_NORM_RTOL)
    num = den = 0.0
    for a, b in zip(leaves(sc["params"]), leaves(se["params"])):
        num += float(torch.sum((a.float() - b.float()) ** 2))
        den += float(torch.sum(b.float() ** 2))
    assert (num / den) ** 0.5 < COMPRESSED_DRIFT, (num / den) ** 0.5
    assert any(float(e.to_local().abs().max()) > 0
               for e in leaves(sc["err"]))

    # one step with no warmup: Adam's first update is about lr times the
    # gradient's sign, so the two updates point the same way only if the
    # compressed mean carries the exact mean's signs
    opt0 = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=50)
    se = _state(model)
    sc = S.init_compressed_state(model, torch.Generator().manual_seed(0),
                                 mesh, "cpu")
    p0 = [p.clone() for p in leaves(se["params"])]
    batch = batch_for_step(model.cfg, 32, 8, seed=0, step=0)
    se, _ = S.make_train_step(model, opt0)(se, batch)
    sc, _ = S.make_compressed_train_step(model, opt0, mesh)(sc, batch)
    ue = torch.cat([(p - q).reshape(-1) for p, q in
                    zip(leaves(se["params"]), p0)])
    uc = torch.cat([(p - q).reshape(-1) for p, q in
                    zip(leaves(sc["params"]), p0)])
    cos = float(torch.dot(ue, uc) / (ue.norm() * uc.norm()))
    assert cos > COMPRESSED_COSINE, cos


def case_elastic_restore(work):
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel.sharding import place_tree, rules_for
    from repro_torch.train import step as S
    model = _port("qwen3-4b")
    state = _state(model)
    mesh1 = _mesh((2, 2), ("data", "model"))
    sh1 = S.state_shardings(model, mesh1, rules_for(model.cfg, mesh1))
    state1 = place_tree(_state(model), sh1)
    d = os.path.join(work, "elastic")
    mgr = CheckpointManager(d)
    mgr.save(11, state1)
    mgr.wait()
    mesh2 = _mesh((4, 1), ("data", "model"))
    sh2 = S.state_shardings(model, mesh2, rules_for(model.cfg, mesh2))
    restored, step = mgr.restore(state, shardings=sh2)
    assert step == 11
    for a, b in zip(leaves(restored), leaves(state)):
        assert torch.equal(a.full_tensor(), b)
    leaf = restored["params"]["embed"]["table"]
    assert leaf.device_mesh.mesh_dim_names == ("data", "model")
    assert leaf.device_mesh.size(0) == 4
    assert [str(p) for p in leaf.placements] == \
        [str(p) for p in sh2["params"]["embed"]["table"].placements]
    assert any(p.is_shard() for p in leaf.placements)


def case_reference_checkpoint_onto_mesh(work):
    from repro_torch.checkpoint.store import restore_checkpoint
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.train import step as S
    model = _port("qwen3-4b")
    like = _state(model, seed=5)
    mesh = _mesh((2, 2), ("data", "model"))
    sh = S.state_shardings(model, mesh, rules_for(model.cfg, mesh))
    root = os.path.join(work, "reference-ckpt")
    plain, step = restore_checkpoint(root, like)
    placed, step2 = restore_checkpoint(root, like, shardings=sh)
    assert step == step2 == 3
    for a, b, s in zip(leaves(placed), leaves(plain), leaves(sh)):
        assert torch.equal(a.full_tensor(), b)
        assert tuple(a.placements) == s.placements


def case_pipeline(work):
    from repro_torch.parallel.pipeline import make_pipelined_fn
    mesh = _mesh((WORLD,), ("pipe",))
    L, D = 8, 16
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy((rng.standard_normal((L, D, D)) * 0.1)
                          .astype(np.float32))
    mbs = torch.from_numpy(rng.standard_normal((6, 4, D)).astype(np.float32))

    def layer_fn(lp, h):
        return torch.tanh(h @ lp)

    w = w0.clone().requires_grad_(True)
    out = make_pipelined_fn(layer_fn, mesh, n_stages=WORLD)(w, mbs)
    (g,) = torch.autograd.grad(torch.sum(out ** 2), [w])

    wr = w0.clone().requires_grad_(True)
    x = mbs
    for i in range(L):
        x = layer_fn(wr[i], x)
    (gr,) = torch.autograd.grad(torch.sum(x ** 2), [wr])
    np.testing.assert_allclose(out.detach().numpy(), x.detach().numpy(),
                               rtol=PIPE_FWD_RTOL, atol=1e-6)
    stage = dist.get_rank()
    per = L // WORLD
    mine = slice(stage * per, (stage + 1) * per)
    np.testing.assert_allclose(g[mine].numpy(), gr[mine].numpy(),
                               rtol=PIPE_GRAD_RTOL, atol=1e-6)
    assert float(g[mine].abs().max()) > 0
    rest = torch.ones(L, dtype=torch.bool)
    rest[mine] = False
    assert float(g[rest].abs().max()) == 0.0


def case_constrain(work):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel.sharding import (constrain, logical_context,
                                               place, rules_for, Sharding)
    model = _port("qwen3-4b")
    mesh = _mesh((2, 2), ("data", "model"))
    rules = rules_for(model.cfg, mesh, mode="train")
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    dx = place(x, Sharding(mesh, (None, None, None)))
    plain = torch.ones(3)
    assert constrain(dx, "batch", "q_seq", "embed") is dx   # no context
    with logical_context(mesh, rules):
        assert constrain(plain, "batch") is plain
        y = constrain(dx, "batch", "q_seq", "embed")
        assert tuple(y.placements) == (Shard(0), Replicate())
        assert torch.equal(y.full_tensor(), x)
        z = constrain(dx[:, :5], "batch", "q_seq", "embed")   # 5 rows
        assert tuple(z.placements) == (Shard(0), Replicate())


def case_preemption_agreed(work):
    """A preemption seen by rank 1 alone stops every rank after the same
    step (the loop agrees on the flag), each rank's state saved there."""
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.train.loop import LoopConfig, TrainLoop

    class Data:
        def global_batch_at(self, step):
            return {"x": np.ones(2, np.float32)}

    def step_fn(state, batch):
        state["w"].add_(1.0)
        return state, {"loss": torch.tensor(1.0)}

    ckpt = CheckpointManager(os.path.join(work, "preempt"))
    loop = TrainLoop(step_fn, Data(), ckpt, LoopConfig(total_steps=10,
                                                       save_every=100))
    if dist.get_rank() == 1:
        loop.on_step = lambda step, loss: step == 3 and loop.request_preempt()
    state, res = loop.run({"w": torch.zeros(())})
    assert res.preempted and res.final_step == 3, res
    assert float(state["w"]) == 3.0
    assert ckpt.latest_step() == 3


def _run_case(name, work):
    if name.startswith("sharded_step["):
        return case_sharded_step(name[len("sharded_step["):-1], work)
    if name.startswith("layer_gather_peak["):
        return case_layer_gather_peak(name[len("layer_gather_peak["):-1],
                                      work)
    return globals()[f"case_{name}"](work)


def _worker(rank, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        for name in CASES:
            try:
                _run_case(name, work)
                out[name] = "ok"
            except Exception:
                out[name] = traceback.format_exc()
            dist.barrier()
    finally:
        with open(os.path.join(work, f"result-{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# The reference's numbers, made here (the ranks import no JAX)
# ----------------------------------------------------------------------------

def _reference_inputs(work):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.store import save_checkpoint
    from repro.configs import get_config, reduced
    from repro.models.model import build
    from repro.parallel.collectives import dequantize_grad, quantize_grad
    from repro.train import step as j_step

    rng = np.random.default_rng(7)
    n = 5000                                     # not a multiple of 1024
    g = rng.standard_normal((WORLD, n)).astype(np.float32)
    g[:, 1024:2048] = 0.0                        # an all-zero chunk
    e = (rng.standard_normal((WORLD, n)) * 1e-3).astype(np.float32)
    e[:, 1024:2048] = 0.0
    deq = []
    for r in range(WORLD):
        q, s = quantize_grad(jnp.asarray(g[r] + e[r]))
        deq.append(np.asarray(dequantize_grad(q, s, (n,))))
    deq = np.stack(deq)
    np.savez(os.path.join(work, "psum.npz"), g=g, e=e,
             mean=deq.mean(axis=0), err=(g + e) - deq)

    model = build(reduced(get_config("qwen3-4b")))
    state = j_step.init_train_state(model, jax.random.key(0))
    save_checkpoint(os.path.join(work, "reference-ckpt"), 3,
                    jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def ranks():
    """Every case's result on every rank: {case: [rank 0's, ...]}."""
    with tempfile.TemporaryDirectory() as work:
        _reference_inputs(work)
        ctx = mp.start_processes(_worker, args=(work,), nprocs=WORLD,
                                 start_method="spawn", join=False)
        deadline = time.monotonic() + RANKS_DEADLINE_S
        while not ctx.join(timeout=5, grace_period=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the ranks ran past {RANKS_DEADLINE_S} s")
        res = []
        for r in range(WORLD):
            with open(os.path.join(work, f"result-{r}.json")) as f:
                res.append(json.load(f))
    return {name: [r.get(name, "not run") for r in res] for name in CASES}


@pytest.mark.parametrize("case", CASES)
def test_on_four_gloo_ranks(ranks, case):
    bad = [f"rank {r}:\n{msg}" for r, msg in enumerate(ranks[case])
           if msg != "ok"]
    assert not bad, "\n".join(bad)


def test_launcher_trains_on_a_2x2_mesh_and_resumes(tmp_path, capfd):
    from repro_torch.launch import train as train_cli
    argv = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
            "--devices", "4", "--mesh", "2x2", "--batch", "4", "--seq",
            "32", "--ckpt", str(tmp_path), "--save-every", "3"]
    first = train_cli.main(argv + ["--steps", "6"])
    assert first.final_step == 6 and len(first.losses) == 6
    assert all(np.isfinite(first.losses))
    again = train_cli.main(argv + ["--steps", "8"])
    assert again.final_step == 8 and len(again.losses) == 2
    out = capfd.readouterr().out
    assert "step     1" in out and "done: 8 steps" in out
