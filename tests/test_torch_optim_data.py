"""The port's synthetic data and AdamW against the JAX package.

``repro_torch.data.synthetic.batch_for_step`` must give the reference's
batches bit for bit (every layout, several steps, shards and seeds), and
the reference's own data tests hold for it. ``repro_torch.optim.adamw``
must match the reference's schedule and ``apply_updates`` over 1-3 steps
on a tree of 1-D and 2-D leaves, with the clip active and inactive,
within 1e-6 relative (f32 rounding order only: both compute the same
expressions; the port's global norm sums each leaf's ``vector_norm``
squared where the reference sums the squares); the reference's
optimiser properties (``tests/test_optim_properties.py``) hold for it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.data.synthetic import batch_for_step as j_batch_for_step
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.data.synthetic import SyntheticDataset, batch_for_step
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     global_norm, init_state, leaves,
                                     schedule)

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

LAYOUTS = ("qwen3-4b", "whisper-tiny-en", "llava-next-34b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops: with torch's intra-op threads one per core
    in every test worker, they wait on each other's spinning threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name="qwen3-4b"):
    return t_reduced(t_get_config(name))


# ----------------------------------------------------------------------------
# Data: bit-equal to the reference
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LAYOUTS)
@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (0, 7, 0, 1), (3, 2, 1, 2),
                          (11, 1000, 3, 4)])
def test_batch_bit_equal_to_the_reference(arch, seed, step, shard,
                                          n_shards):
    want = j_batch_for_step(reduced(get_config(arch)), 64, 4, seed=seed,
                            step=step, shard=shard, n_shards=n_shards)
    got = batch_for_step(_cfg(arch), 64, 4, seed=seed, step=step,
                         shard=shard, n_shards=n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


# the reference's tests/test_data.py, on the port's pipeline

def test_deterministic_across_instances():
    ds1 = SyntheticDataset(_cfg(), 32, 8, seed=7, n_shards=2)
    ds2 = SyntheticDataset(_cfg(), 32, 8, seed=7, n_shards=2)
    b1, b2 = ds1.global_batch_at(5), ds2.global_batch_at(5)
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])


def test_steps_differ():
    ds = SyntheticDataset(_cfg(), 32, 4, seed=0)
    assert not np.array_equal(ds.global_batch_at(0)["tokens"],
                              ds.global_batch_at(1)["tokens"])


def test_seeds_differ():
    a = batch_for_step(_cfg(), 32, 4, seed=0, step=0)
    b = batch_for_step(_cfg(), 32, 4, seed=1, step=0)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_shards_disjoint_and_stable():
    ds = SyntheticDataset(_cfg(), 16, 8, seed=3, n_shards=4)
    shards = [ds.shard_batch_at(2, s) for s in range(4)]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not np.array_equal(shards[i]["tokens"],
                                      shards[j]["tokens"])
    again = ds.shard_batch_at(2, 1)
    np.testing.assert_array_equal(again["tokens"], shards[1]["tokens"])


def test_elastic_reshard_preserves_global_batch():
    """The same (seed, step, shard plan) gives the same global batch in a
    restarted job."""
    g1 = SyntheticDataset(_cfg(), 16, 8, seed=3, n_shards=4) \
        .global_batch_at(0)
    g2 = SyntheticDataset(_cfg(), 16, 8, seed=3, n_shards=4) \
        .global_batch_at(0)
    for k in g1:
        np.testing.assert_array_equal(g1[k], g2[k])


def test_targets_are_shifted_tokens():
    b = batch_for_step(_cfg(), 16, 2, seed=0, step=0)
    assert b["tokens"].shape == b["targets"].shape
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_vocab_range():
    cfg = _cfg()
    b = batch_for_step(cfg, 64, 4, seed=0, step=0)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < cfg.vocab


def test_encdec_batch_layout():
    cfg = _cfg("whisper-base")
    b = batch_for_step(cfg, 32, 2, seed=0, step=0)
    assert b["enc_frames"].shape == (2, 16, cfg.d_model)
    assert b["tokens"].shape == (2, 16)


def test_vlm_batch_masks_image_prefix():
    cfg = _cfg("llava-next-34b")
    b = batch_for_step(cfg, 32, 2, seed=0, step=0)
    n_img = cfg.n_img_tokens
    assert b["img_embed"].shape[1] == n_img
    assert (b["targets"][:, :n_img] == -1).all()
    assert b["targets"].shape[1] == 32


def test_bad_shard_config_raises():
    with pytest.raises(AssertionError):
        SyntheticDataset(_cfg(), 16, 8, n_shards=3)


# ----------------------------------------------------------------------------
# AdamW against the reference
# ----------------------------------------------------------------------------

def test_schedule_equals_the_reference():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = j_adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for t in range(0, 111):
        got = schedule(cfg, torch.tensor(t, dtype=torch.int32))
        want = float(j_adamw.schedule(jcfg, jnp.asarray(t, jnp.int32)))
        assert got.dtype == torch.float32
        assert math.isclose(float(got), want, rel_tol=1e-6, abs_tol=1e-12), \
            (t, float(got), want)


def _tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((8, 6)) * scale).astype(np.float32),
            "b": (rng.standard_normal((6,)) * scale).astype(np.float32),
            "blk": {"k": (rng.standard_normal((3, 4, 5)) * scale)
                    .astype(np.float32),
                    "n": (rng.standard_normal((5,)) * scale)
                    .astype(np.float32)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _assert_tree_close(got, want, rtol=1e-6, atol=1e-9):
    g = [t.numpy() for t in leaves(got)]
    w = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("grad_scale,clip", [(0.01, 1.0), (10.0, 1.0),
                                             (1.0, None)],
                         ids=["clip-inactive", "clip-active", "no-clip"])
def test_apply_updates_matches_the_reference(grad_scale, clip):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    cfg, jcfg = AdamWConfig(**kw), j_adamw.AdamWConfig(**kw)
    p0 = _tree(rng)
    tp = _torch_tree(p0)
    ts = init_state(tp)
    jp = jax.tree.map(jnp.asarray, p0)
    js = j_adamw.init_state(jp)
    for _ in range(3):
        g = _tree(rng, grad_scale)
        tp, ts, tm = apply_updates(tp, _torch_tree(g), ts, cfg)
        jp, js, jm = j_adamw.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        _assert_tree_close(tp, jp)
        _assert_tree_close(ts["m"], js["m"])
        _assert_tree_close(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert tm[k].dim() == 0 and tm[k].dtype == torch.float32
            assert math.isclose(float(tm[k]), float(jm[k]), rel_tol=1e-6), k
    if clip is not None:
        active = float(jm["grad_norm"]) > clip
        assert active == (grad_scale > 1.0)


def test_apply_updates_in_place_and_keeps_dtypes():
    """The state is updated in place (the reference launcher's donation)
    and a bf16 leaf stays bf16."""
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16), "b": torch.ones(4)}
    st_ = init_state(p)
    ids = [id(t) for t in leaves(p)] + [id(st_["step"])]
    g = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16),
         "b": torch.full((4,), 0.5)}
    p2, st2, _ = apply_updates(p, g, st_, AdamWConfig(lr=0.1,
                                                      warmup_steps=0))
    assert [id(t) for t in leaves(p2)] + [id(st2["step"])] == ids
    assert p2["w"].dtype == torch.bfloat16 and float(p2["w"][0, 0]) < 1
    assert st2["m"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(g["b"].numpy(), np.full(4, 0.5))


# the reference's tests/test_optim_properties.py, on the port's AdamW

def _params(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 4), generator=gen),
            "b": torch.randn((4,), generator=gen)}


def _sq(tree) -> float:
    return sum(float(torch.sum(x.double() ** 2)) for x in leaves(tree))


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 5), st.floats(1e-5, 1e-2))
def test_update_moves_against_gradient(seed, lr):
    """One AdamW step on f(p)=0.5||p||^2 reduces the loss."""
    cfg = AdamWConfig(lr=lr, warmup_steps=0, total_steps=100,
                      weight_decay=0.0, clip_norm=None)
    p = _params(seed)
    before = _sq(p)
    g = {k: v.clone() for k, v in p.items()}   # grad of 0.5||p||^2 is p
    new_p, _, _ = apply_updates(p, g, init_state(p), cfg)
    assert _sq(new_p) < before


@settings(max_examples=25, deadline=None)
@given(st.floats(0.1, 10.0))
def test_clip_bounds_effective_norm(scale):
    """With clip_norm=1, the applied gradient has norm <= 1 (+eps)."""
    g = {k: v * scale for k, v in _params(0).items()}
    gnorm = float(global_norm(g))
    expected_scale = min(1.0, 1.0 / (gnorm + 1e-9))
    clipped = {k: v * expected_scale for k, v in g.items()}
    assert float(global_norm(clipped)) <= 1.0 + 1e-5


def test_schedule_shape():
    """Warmup ramps to lr, cosine decays to min_lr_ratio*lr."""
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(schedule(cfg, torch.tensor(t))) for t in range(0, 101, 5)]
    assert lrs[0] < lrs[1] < lrs[2]                 # warmup
    assert abs(lrs[2] - 1e-3) < 1e-4                # peak ~ lr
    assert all(a >= b - 1e-12 for a, b in zip(lrs[2:], lrs[3:]))  # decay
    assert abs(lrs[-1] - 1e-4) < 2e-5               # floor


def test_moments_shapes_and_step_counter():
    p = _params(1)
    g = {k: v.clone() for k, v in p.items()}
    _, st2, m = apply_updates(p, g, init_state(p), AdamWConfig())
    assert int(st2["step"]) == 1
    for a, b in zip(leaves(st2["m"]), leaves(p)):
        assert a.shape == b.shape
    assert float(m["grad_norm"]) > 0
