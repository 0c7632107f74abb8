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
* the 2x2 meshed prefill and 3 decode steps of the seven families
  (reduced; llava-next-34b's image prefill too), which split the
  attention heads, the MLP's columns, the vocabulary, the MoE experts
  and the mamba blocks' inner channels over ``model``,
  give the unmeshed logits within ``SPLIT_TOL`` of the largest (the
  row-parallel sums round apart; ``SERVE_TOL``, 1e-5, where ``model`` is
  one rank) and their greedy ids but at near-ties; the cache stays
  DTensors in its ``cache_shardings`` placements, the decode steps write
  it in place (its storages unchanged), and each rank's local shard
  equals its block of the unmeshed cache (float leaves within the same
  tolerance of the largest, the MoE routing counts exactly), after the
  prefill and after the last step; the same for qwen3-4b on a (1, 4)
  mesh, where the cache shards head_dim and the attention splits the
  query heads alone;
* a 2x2 meshed decode step gathers no cache over ``model`` (qwen3-4b and
  whisper-tiny.en, reduced, 4 layers: their KV heads divide it, and a
  split attention reads its shard), where a planted whole-cache gather
  holds more than a layer at once; a 2x2 meshed prefill and decode step
  gather no parameter leaf and no cache leaf over ``model``, where the
  whole-layer gather of every leaf on ``model`` is seen when the split is
  off (qwen3-4b, whisper-tiny.en, qwen3-moe-30b-a3b's experts, zamba2-
  7b's mamba blocks, whose ``conv`` state leaf alone a decode step
  gathers a layer at a time);
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
* a preemption that one rank sees stops every rank at the same step;
* ``launch.serve_mesh``'s ranks (``serve_meshes``) serve reduced
  qwen3-4b on 1x4 and 2x2 against one device (the named test below).

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
# a meshed serving step with ``model`` > 1 splits the attention heads, the
# MLP's columns and the vocabulary (PERF.md, §6): each row-parallel
# product (the attention's ``wo``, the MLP's ``down``) sums its ranks' f32
# partials in another order than one product does and rounds the sum to
# bf16 once. The f32 sums agree within ~1e-7 relative (the shard-by-shard
# tests in test_torch_parallel.py hold them within 1e-6 of the largest);
# an element whose f32 value lies that close to a bf16 rounding boundary
# rounds the other way, one bf16 ulp (2**-8 relative), and later layers
# carry it. So the logits and the cache agree within two and a half bf16
# ulps of the largest value, GRAD_TOL's bound; measured: 4.4e-3 (whisper-
# tiny.en's prefill logits, one row of four; the other rows bit-equal).
# SERVE_TOL still binds where ``model`` is 1. The greedy ids must agree
# but at a near-tie (``TIE_MARGIN`` of the unmeshed logits)
SPLIT_TOL = 1e-2
TIE_MARGIN = 0.25
PSUM_TOL = 1e-6
COMPRESSED_LOSS, COMPRESSED_DRIFT = 0.05, 5e-3
COMPRESSED_NORM_RTOL, COMPRESSED_COSINE = 2e-3, 0.95
PIPE_FWD_RTOL, PIPE_GRAD_RTOL = 2e-5, 1e-5
# the module's ranks take ~25 s here; a hung collective fails the module
# at this wall rather than running into the suite's limit
RANKS_DEADLINE_S = 300
GATHER_ARCHS = ("qwen3-4b", "whisper-tiny-en")
SPLIT_ARCHS = GATHER_ARCHS + ("qwen3-moe-30b-a3b", "zamba2-7b")
CASES = ([f"sharded_step[{a}]" for a in FAMILIES]
         + [f"layer_gather_peak[{a}]" for a in GATHER_ARCHS]
         + [f"meshed_serving[{a}]" for a in FAMILIES]
         + ["meshed_serving_head_dim"]
         + [f"meshed_decode_peak[{a}]" for a in GATHER_ARCHS]
         + [f"meshed_split_bytes[{a}]" for a in SPLIT_ARCHS]
         + ["compressed_psum", "compressed_step",
            "elastic_restore", "reference_checkpoint_onto_mesh",
            "pipeline", "constrain", "preemption_agreed"])
#: what the ranks run: CASES, then the launcher's part, which
#: ``test_serve_launcher_holds_the_meshed_steps_on_four_ranks`` reads
RUN = CASES + ["serve_launcher"]


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
    its storage is freed (a weakref finalizer). Gathered data that a
    ``cat`` or a further all-gather reads (a leaf sharded over two mesh
    axes is gathered one axis at a time) is staging, read by nothing
    else, and counts no more once that op made its output: gloo's work
    object holds an operand until a moment of its own, later on a loaded
    machine. The sum is read at every op that takes data other than
    gathered data (the layers' computations, the backward): the peak of
    what the computations see gathered at once."""

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
        gather = func.__name__.startswith("all_gather")
        staging = ins and ins <= self.alive.keys() and (
            gather or func is torch.ops.aten.cat.default and len(ins) == 1)
        if gather or staging:
            for t in tree_leaves(out):
                self._track(t)
            for key in ins if staging else ():
                self.alive.pop(key, None)
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
    whole = S.layer_params
    S.layer_params = lambda params, axes, gp=None: tree_map(
        lambda p: gathered(p, gp), params)
    try:
        planted = peak()
    finally:
        S.layer_params = whole
    # asserted after every collective of the case: a bound that one rank
    # alone breaks fails the case, and leaves no rank in a collective
    assert 0 < got <= layer + rest, (got, layer, rest)
    assert planted > layer + rest, (planted, layer, rest)


SERVE_ROWS, SERVE_PROMPT, SERVE_FRAMES, SERVE_STEPS = 4, 16, 32, 3


def _serve_prompt(cfg, seed, image=False):
    """A prefill batch of ``SERVE_ROWS`` prompts (numpy, seeded): token
    ids, and the frames an encoder-decoder model encodes or, with
    ``image``, the patch embeddings a VLM puts before the ids."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_ROWS, SERVE_PROMPT)).astype(np.int32))}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (SERVE_ROWS, SERVE_FRAMES, cfg.d_model)).astype(np.float32))
    if image:
        batch["img_embed"] = torch.from_numpy(rng.standard_normal(
            (SERVE_ROWS, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _close(got, want, what, tol=SERVE_TOL):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got, want = got.float().numpy(), want.float().numpy()
    gap = np.abs(got - want).max()
    assert gap <= tol * np.abs(want).max(), (what, gap, np.abs(want).max())


def _ids_agree(got, want, what):
    """The greedy ids of the logits rows ``got`` equal ``want``'s but
    where ``want``'s two candidates lie within ``TIE_MARGIN``."""
    gi, wi = got.argmax(-1), want.argmax(-1)
    for r in torch.nonzero(gi != wi).flatten().tolist():
        gap = float(want[r, wi[r]] - want[r, gi[r]])
        assert gap < TIE_MARGIN, (what, r, int(gi[r]), int(wi[r]), gap)


def _serve_tol(mesh) -> float:
    """``SERVE_TOL`` on a mesh whose ``model`` axis is one rank, else
    ``SPLIT_TOL``: the split's row-parallel sums round apart."""
    names = mesh.mesh_dim_names
    return SERVE_TOL if mesh.size(names.index("model")) == 1 else SPLIT_TOL


def _serve_placed(model, params, mesh, mode="serve"):
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.sharding import (enforce_divisibility,
                                               place_tree, rules_for,
                                               tree_shardings)
    rules = rules_for(model.cfg, mesh, mode=mode)
    sh = enforce_divisibility(tree_shardings(model.param_axes(), mesh, rules),
                              model.param_shapes())
    return place_tree(tree_map(lambda p: p.clone(), params), sh), rules


def _cache_matches(got, want, shardings, tol=SERVE_TOL):
    """Every leaf of the meshed cache ``got`` is a DTensor in its
    ``cache_shardings`` placements, and its local shard equals this
    rank's block of the unmeshed cache ``want``: integer leaves (the MoE
    routing counts) exactly, float ones within ``tol`` of the leaf's
    largest value."""
    from repro_torch.models.model import tree_paths
    from repro_torch.parallel.sharding import place
    for (path, g), (_, w), (_, sh) in zip(tree_paths(got), tree_paths(want),
                                          tree_paths(shardings)):
        assert type(g).__name__ == "DTensor", path
        assert tuple(g.placements) == sh.placements, (path, g.placements)
        assert tuple(g.shape) == tuple(w.shape), (path, g.shape, w.shape)
        mine = place(w, sh).to_local()
        if w.dtype.is_floating_point:
            _close(g.to_local(), mine, path, tol)
        else:
            assert torch.equal(g.to_local(), mine), path


def _storages(cache):
    from repro_torch.optim.adamw import leaves
    return [x.to_local().untyped_storage().data_ptr() for x in leaves(cache)]


def _meshed_serving(model, mesh, rules_mode="serve", image=False):
    """The meshed prefill of a seeded batch, then ``SERVE_STEPS`` decode
    steps, against the unmeshed steps (``_serve_prompt``): the logits
    within ``_serve_tol`` and their greedy ids equal but at near-ties,
    the cache in its shardings and equal to the unmeshed one's blocks
    after the prefill and after the last step, its storages unchanged by
    every step. ``image``: the VLM's prefill with patch embeddings,
    compared without decode steps (the image fills the cache's decode
    headroom)."""
    from repro_torch.train import step as S
    cfg = model.cfg
    tol = _serve_tol(mesh)
    params = model.init_values(torch.Generator().manual_seed(3), "cpu")
    batch = _serve_prompt(cfg, 4, image)
    want_l, want_c = S.make_prefill_step(model)(params, batch)
    placed, rules = _serve_placed(model, params, mesh, rules_mode)
    got_l, cache = S.make_prefill_step(model, mesh=mesh, rules=rules)(
        placed, batch)
    # the logits of the vocabulary's ids (the padding ids' are -1e9)
    v = cfg.vocab
    _close(got_l[:, :v], want_l[:, :v], "prefill logits", tol)
    _ids_agree(got_l[:, :v], want_l[:, :v], "prefill ids")
    length = S.prefill_cache_len(SERVE_PROMPT)
    sh = S.cache_shardings(model, SERVE_ROWS, length, mesh, rules)
    _cache_matches(cache, want_c, sh, tol)
    if image:
        return
    before = _storages(cache)
    decode = S.make_decode_step(model, mesh=mesh, rules=rules)
    rng = np.random.default_rng(5)
    for t in range(SERVE_STEPS):
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_ROWS, 1))
                               .astype(np.int32))
        pos = SERVE_PROMPT + t
        want, want_c = S.make_decode_step(model)(params, want_c, nxt, pos)
        got, out = decode(placed, cache, nxt, pos)
        assert out is cache
        _close(got[:, :v], want[:, :v], f"decode step {t} logits", tol)
        _ids_agree(got[:, :v], want[:, :v], f"decode step {t} ids")
        assert _storages(cache) == before, f"decode step {t} copied"
    _cache_matches(cache, want_c, sh, tol)


def case_meshed_serving(arch, work):
    """The 2x2 meshed prefill and decode steps of ``arch`` against the
    unmeshed ones (``_meshed_serving``); llava-next-34b's image prefill
    too."""
    model = _port(arch)
    mesh = _mesh((2, 2), ("data", "model"))
    if model.cfg.vlm:
        _meshed_serving(model, mesh, image=True)
    _meshed_serving(model, mesh)


def case_meshed_serving_head_dim(work):
    """qwen3-4b on a (1, 4) mesh: its 2 KV heads do not divide ``model``,
    so the cache shards head_dim (``rules_for``'s serve rule), which a
    decode step gathers and writes a layer at a time."""
    from repro_torch.parallel.sharding import rules_for
    model = _port("qwen3-4b")
    mesh = _mesh((1, 4), ("data", "model"))
    rules = rules_for(model.cfg, mesh, mode="serve")
    assert rules["kv_heads"] is None and rules["head_dim"] == "model"
    _meshed_serving(model, mesh)


class GatheredCacheBytes(GatheredBytes):
    """``GatheredBytes`` of the cache alone: an all-gather whose operand
    is a view of one of ``storages`` (the cache's local shards) or of
    gathered cache data makes gathered cache data, and so does a ``cat``
    of one such gather's views (the gather then staging)."""

    def __init__(self, storages):
        super().__init__()
        self.storages = set(storages)

    def _op(self, func, types, args, kwargs):
        from torch.utils._pytree import tree_leaves
        ins = {self._key(t) for t in tree_leaves((args, kwargs))
               if type(t) is torch.Tensor}
        if func.__name__.startswith("all_gather") \
                and not ins & (self.storages | self.alive.keys()):
            return func(*args, **kwargs)   # a parameter's gather
        return super()._op(func, types, args, kwargs)


def _layer_cache_bytes(model, rows, length):
    """The largest layer's cache bytes (every block of a segment, or a
    Whisper layer's self and cross planes) for ``rows`` of the batch."""
    from repro_torch.models.model import tree_paths
    per = {}
    for path, s in tree_paths(model.cache_specs(SERVE_ROWS, length)):
        stack = path.split("/")[0]
        per[stack] = per.get(stack, 0) + \
            s.numel() * s.element_size() // s.shape[0] * rows // SERVE_ROWS
    return max(per.values())


def case_meshed_decode_peak(arch, work):
    """A 2x2 meshed decode step of ``arch`` (reduced, 4 layers) gathers
    no cache over ``model``: its attention is split by KV heads (2 on a
    ``model`` of 2), so each block reads its shard of the cache, and the
    bytes of gathered cache data alive at once, read from the storages'
    lifetimes, are 0 (the bound before the split was one layer's cache
    for the rank's rows, gathered over ``model``); the whole-cache gather it replaced
    (each leaf gathered whole, every layer and row) breaks that old
    bound too."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import encdec, layers, transformer
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import tree_map
    from repro_torch.train import step as S
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=4)
    model = build(cfg)
    mesh = _mesh((2, 2), ("data", "model"))
    params = model.init_values(torch.Generator().manual_seed(3), "cpu")
    placed, rules = _serve_placed(model, params, mesh)
    _, cache = S.make_prefill_step(model, mesh=mesh, rules=rules)(
        placed, _serve_prompt(cfg, 4))
    decode = S.make_decode_step(model, mesh=mesh, rules=rules)
    nxt = torch.full((SERVE_ROWS, 1), 7, dtype=torch.int32)
    layer = _layer_cache_bytes(model, SERVE_ROWS // 2,
                               S.prefill_cache_len(SERVE_PROMPT))

    def peak():
        seen = GatheredCacheBytes(_storages(cache))
        with seen.mode:
            decode(placed, cache, nxt, SERVE_PROMPT)
        return seen.peak

    got = peak()

    def whole(pool, i, keep_model=False):
        rows = layers.meshed_rows()
        m = rows.model

        def one(t):
            x = rows.take(t.full_tensor()[i])
            p = t.placements[m]
            if keep_model and p.is_shard():   # the split block's shard
                x = x.chunk(mesh.size(m), p.dim - 1)[
                    mesh.get_coordinate()[m]]
            return x[None]
        return tree_map(one, pool), 0

    saved = transformer.gather_cache_layer, encdec.gather_cache_layer
    transformer.gather_cache_layer = encdec.gather_cache_layer = whole
    try:
        planted = peak()
    finally:
        transformer.gather_cache_layer, encdec.gather_cache_layer = saved
    assert got == 0, (got, layer)    # after every collective of the case
    assert planted > layer, (planted, layer)


class GatheredLeaves:
    """The paths of the parameter and cache leaves whose local shards an
    all-gather over the process group ``group`` (by name) takes as its
    operand (DTensor's gather of a leaf reads its local shard, which
    shares the leaf's storage), seen on the local tensors under a
    dispatch mode."""

    def __init__(self, named: dict, group: str):
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return outer._op(func, types, args, kwargs or {})

        self.mode, self.named, self.seen = Mode(), named, set()
        self.group = group

    def _op(self, func, types, args, kwargs):
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        if any(issubclass(t, (DTensor, AsyncCollectiveTensor))
               for t in types):
            return NotImplemented
        if func.__name__.startswith("all_gather") \
                and self.group in tree_leaves((args, kwargs)):
            for t in tree_leaves((args, kwargs)):
                if type(t) is torch.Tensor:
                    key = t.untyped_storage().data_ptr()
                    if key in self.named:
                        self.seen.add(self.named[key])
        return func(*args, **kwargs)


def case_meshed_split_bytes(arch, work):
    """A 2x2 meshed prefill and decode step of ``arch`` (reduced: its
    heads, KV heads, MLP columns, vocabulary, experts and SSM heads
    divide ``model``) gather no parameter and no cache leaf over
    ``model``: every leaf the serve rules place on ``model`` belongs to
    a unit the split takes (attention, MLP, embedding, head, MoE experts,
    mamba block), a split attention reads its shard of the cache and a
    split mamba block its state's heads. The one exception is a mamba
    block's ``conv`` leaf, which the decode step gathers a layer at a
    time (its chunks over ``model`` do not line up with a rank's
    channels: ``models/ssm.py``). The same steps with the split off (the
    whole-layer gather) gather every parameter leaf placed on ``model``
    and, decoding, every cache leaf placed on it."""
    from repro_torch.models.model import tree_paths
    from repro_torch.train import step as S
    model = _port(arch)
    mesh = _mesh((2, 2), ("data", "model"))
    m = mesh.mesh_dim_names.index("model")
    group = mesh.get_group(m).group_name
    params = model.init_values(torch.Generator().manual_seed(3), "cpu")
    placed, rules = _serve_placed(model, params, mesh)
    on_model = {path for path, t in tree_paths(placed)
                if t.placements[m].is_shard()}
    assert on_model

    def run():
        prefill = S.make_prefill_step(model, mesh=mesh, rules=rules)
        named = {t.to_local().untyped_storage().data_ptr(): path
                 for path, t in tree_paths(placed)}
        seen = GatheredLeaves(named, group)
        with seen.mode:
            _, cache = prefill(placed, _serve_prompt(model.cfg, 4))
        got_p = set(seen.seen)
        cache_paths = {p for p, t in tree_paths(cache)
                       if t.placements[m].is_shard()}
        seen = GatheredLeaves({
            t.to_local().untyped_storage().data_ptr(): "cache/" + path
            for path, t in tree_paths(cache)}, group)
        seen.named.update(named)
        with seen.mode:
            S.make_decode_step(model, mesh=mesh, rules=rules)(
                placed, cache, torch.full((SERVE_ROWS, 1), 7,
                                          dtype=torch.int32), SERVE_PROMPT)
        return got_p, seen.seen, cache_paths

    split_p, split_d, cache_paths = run()
    whole = S._model_axis
    S._model_axis = lambda mesh: None
    try:
        prefill_p, decode_p, _ = run()
    finally:
        S._model_axis = whole
    conv = {"cache/" + p for p in cache_paths if p.endswith("/ssm/conv")}
    assert (model.cfg.family == "hybrid") == bool(conv)
    assert not split_p and split_d == conv, (split_p, split_d ^ conv)
    assert prefill_p == on_model, on_model ^ prefill_p
    assert {p for p in decode_p if p.startswith("cache/")} == \
        {"cache/" + p for p in cache_paths}


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


def case_serve_launcher(work):
    """``launch.serve_mesh``'s ranks (reduced qwen3-4b, 16 ids, 2 decode
    steps): on 1x4 the attention takes the head_dim form, on 2x2 the
    heads form; rank 0 holds each mesh's prefill and decode logits to the
    unmeshed ones' within ``SPLIT_TOL`` of the largest, a differing
    greedy id to a margin under ``TIE_MARGIN``, and the ms a step of
    both to be measured."""
    from repro_torch.launch import serve_mesh
    rec = serve_mesh.serve_meshes("qwen3-4b", True, [(1, 4), (2, 2)], 16,
                                  2, "cpu")
    if dist.get_rank() != 0:
        return
    assert rec["meshes"]["1x4"]["splits"]["attention:head_dim"] > 0
    assert rec["meshes"]["2x2"]["splits"]["attention:heads"] > 0
    for one in rec["meshes"].values():
        assert len(one["logits_gap"]) == 3
        assert max(one["logits_gap"]) <= SPLIT_TOL, one
        assert all(m < TIE_MARGIN for *_, m in one["near_tie_flips"]), one
        assert one["step_ms"] > 0 and one["plain_step_ms"] > 0


def _run_case(name, work):
    if "[" in name:
        case, arg = name[:-1].split("[")
        return globals()[f"case_{case}"](arg, work)
    return globals()[f"case_{name}"](work)


def _worker(rank, work):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    out = {}
    try:
        for name in RUN:
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
    return {name: [r.get(name, "not run") for r in res] for name in RUN}


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


def test_serve_launcher_holds_the_meshed_steps_on_four_ranks(ranks):
    """``launch.serve_mesh``'s ranks on the module's four gloo ranks
    (``case_serve_launcher``)."""
    bad = [f"rank {r}:\n{msg}" for r, msg in
           enumerate(ranks["serve_launcher"]) if msg != "ok"]
    assert not bad, "\n".join(bad)
