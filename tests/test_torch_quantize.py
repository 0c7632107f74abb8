"""The port's Q8_0 and Q4_0 formats against the JAX package's, and the
bridge.

Codes and f16 scales must be bit-identical (the same f32 arithmetic,
round-half-to-even in both frameworks), so these checks use exact
equality, never a tolerance.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import quantize as jq
from repro.models.model import build
from repro_torch import quantize as tq
from repro_torch.bridge import params_from_numpy, params_to_numpy


def _assert_same_q8(j, t):
    np.testing.assert_array_equal(np.asarray(j.q), t.q.numpy())
    np.testing.assert_array_equal(np.asarray(j.scale).view(np.uint16),
                                  t.scale.numpy().view(np.uint16))


def _both(x: np.ndarray, axis: int):
    j = jq.quantize_q8_0(jnp.asarray(x), axis=axis)
    t = tq.quantize_q8_0(torch.from_numpy(x), axis=axis)
    _assert_same_q8(j, t)
    return j, t


@pytest.mark.parametrize("shape,axis,scale", [
    ((64, 96), -1, 1.0), ((96, 40), 0, 1e-3), ((3, 64, 5), 1, 50.0),
    ((2, 4, 32), -1, 1e4), ((128, 33), 0, 1e-6)])
def test_q8_codes_and_scales_bit_identical(shape, axis, scale):
    x = (np.random.default_rng(sum(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    j, t = _both(x, axis)
    # the dequantized planes agree bit for bit as well
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize_q8_0(j, axis=axis)),
        tq.dequantize_q8_0(t, axis=axis).numpy())


def test_q8_exact_half_ties_round_to_even():
    # amax 127 gives d = 1 (exact in f16) and amax 63.5 gives d = 0.5, so
    # x / d lands exactly on k + 0.5: both frameworks round half to even
    ties = np.arange(-15, 16, dtype=np.float32) + 0.5
    blk1 = np.concatenate([[127.0], ties[:31]]).astype(np.float32)
    blk2 = np.concatenate([[63.5], ties[:31] * 0.5]).astype(np.float32)
    x = np.stack([blk1, blk2])
    _, t = _both(x, -1)
    assert t.scale.tolist() == [[1.0], [0.5]]
    want = np.round(ties[:31])            # numpy rounds half to even too
    np.testing.assert_array_equal(t.q[0, 1:].numpy(), want)
    np.testing.assert_array_equal(t.q[1, 1:].numpy(), want)
    assert (np.abs(want) % 2 == 0).all()


def test_q8_all_zero_blocks():
    x = np.zeros((3, 64), np.float32)
    x[1, 40] = -2.5                   # one live block beside zero blocks
    _, t = _both(x, -1)
    assert t.scale[0].abs().sum() == 0 and t.q[0].abs().sum() == 0
    assert t.scale[1, 0] == 0 and t.q[1, 40] == -127


def _reduced_params():
    cfg = reduced(get_config("whisper-tiny-en"))
    return build(cfg).init_values(jax.random.key(3))


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def test_quantize_tree_matches_reference_structure_and_bits():
    jp = _reduced_params()
    jt = jq.quantize_tree(jp)
    tt = tq.quantize_tree(params_from_numpy(jax.tree.map(np.asarray, jp)))
    jleaves = dict(_walk(jt))
    tleaves = dict(_walk(tt))
    assert jleaves.keys() == tleaves.keys()
    n_q8 = 0
    for path, jl in jleaves.items():
        tl = tleaves[path]
        assert isinstance(jl, jq.Q8Tensor) == isinstance(tl, tq.Q8Tensor), \
            path
        if isinstance(jl, jq.Q8Tensor):
            n_q8 += 1
            _assert_same_q8(jl, tl)
        else:
            np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    # frontend, embed, dec_pos, and wo / up / down of every stacked block
    assert n_q8 == 3 + 3 + 4


def test_bridge_round_trip_is_lossless():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((2, 64, 3)).astype(np.float32)
    bf16 = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    q8 = jq.quantize_q8_0(jnp.asarray(rng.standard_normal((64, 9)),
                                      jnp.float32), axis=0)
    tree = {"a": f32, "nested": {"b": bf16, "c": np.arange(4, dtype=np.int8)},
            "w": jax.tree.map(np.asarray, q8)}
    t = params_from_numpy(tree)
    assert t["nested"]["b"].dtype == torch.bfloat16
    assert isinstance(t["w"], tq.Q8Tensor)
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["a"], f32)
    assert back["nested"]["b"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["nested"]["b"].view(np.uint16),
                                  bf16.view(np.uint16))
    np.testing.assert_array_equal(back["nested"]["c"], tree["nested"]["c"])
    np.testing.assert_array_equal(back["w"][0], np.asarray(q8.q))
    np.testing.assert_array_equal(back["w"][1].view(np.uint16),
                                  np.asarray(q8.scale).view(np.uint16))


def test_quantize_tree_refuses_unported_tier():
    # q4_0 is ported (the speculative draft's tier); an unknown tier is
    # refused as the reference refuses it
    t = tq.quantize_tree({"w": torch.ones(64, 64)}, tier="q4_0")
    assert isinstance(t["w"], tq.Q4Tensor) and t["w"].q.shape == (32, 64)
    with pytest.raises(ValueError, match="q2_k"):
        tq.quantize_tree({"w": torch.zeros(64, 64)}, tier="q2_k")


# ------------------------------------------------------------------ Q4_0


def _assert_same_q4(j, t):
    assert t.q.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(j.q), t.q.numpy())
    np.testing.assert_array_equal(np.asarray(j.scale).view(np.uint16),
                                  t.scale.numpy().view(np.uint16))


@pytest.mark.parametrize("shape,axis,scale", [
    ((64, 96), 0, 1.0),          # (K, N) weight: packed along K
    ((6, 64, 40), -2, 1e-3),     # (h, dh, n) output projection
    ((96, 24), -2, 50.0),        # vocab table: packed along the rows
    ((2, 5, 3, 64), -1, 1e4),    # KV cache: packed along head_dim
    ((128, 33), 0, 1e-6)])
def test_q4_codes_and_scales_bit_identical(shape, axis, scale):
    x = (np.random.default_rng(sum(shape) + 1).standard_normal(shape)
         * scale).astype(np.float32)
    j = jq.quantize_q4_0(jnp.asarray(x), axis=axis)
    t = tq.quantize_q4_0(torch.from_numpy(x), axis=axis)
    _assert_same_q4(j, t)
    np.testing.assert_array_equal(
        np.asarray(jq.dequantize_q4_0(j, axis=axis)),
        tq.dequantize_q4_0(t, axis=axis).numpy())


@pytest.mark.parametrize("axis", [0, -2, -1])
def test_pack_and_unpack_q4_bit_identical(axis):
    # every code of [-8, 7], the low nibble holding the even index
    codes = np.random.default_rng(axis + 9).integers(
        -8, 8, (32, 6, 64)).astype(np.int8)
    j = np.asarray(jq.pack_q4(jnp.asarray(codes), axis=axis))
    t = tq.pack_q4(torch.from_numpy(codes), axis=axis)
    np.testing.assert_array_equal(j, t.numpy())
    np.testing.assert_array_equal(tq.unpack_q4(t, axis=axis).numpy(), codes)
    first = np.moveaxis(codes, axis, -1)[..., :2].astype(np.int32) + 8
    np.testing.assert_array_equal(np.moveaxis(t.numpy(), axis, -1)[..., 0],
                                  first[..., 0] | (first[..., 1] << 4))


def test_q4_exact_half_ties_round_to_even():
    # amax 7 gives d = 1 and amax 3.5 gives d = 0.5 (exact in f16), so
    # x / d lands exactly on k + 0.5: both frameworks round half to even
    ties = np.arange(-7, 7, dtype=np.float32) + 0.5          # 14 values
    blk1 = np.concatenate([[7.0], ties, ties[::-1], [0.0, 0.0, 0.0]])
    blk2 = np.concatenate([[3.5], ties * 0.5, ties[::-1] * 0.5,
                           [0.0, 0.0, 0.0]])
    x = np.stack([blk1, blk2]).astype(np.float32)
    j = jq.quantize_q4_0(jnp.asarray(x), axis=-1)
    t = tq.quantize_q4_0(torch.from_numpy(x), axis=-1)
    _assert_same_q4(j, t)
    assert t.scale.tolist() == [[1.0], [0.5]]
    codes = tq.unpack_q4(t.q, axis=-1).numpy()
    want = np.round(ties)                  # numpy rounds half to even too
    np.testing.assert_array_equal(codes[0, 1:15], want)
    np.testing.assert_array_equal(codes[1, 1:15], want)
    assert (np.abs(want) % 2 == 0).all()


def test_quantize_tree_q4_matches_reference_leaf_for_leaf():
    jp = _reduced_params()
    jt = jq.quantize_tree(jp, tier="q4_0")
    tt = tq.quantize_tree(params_from_numpy(jax.tree.map(np.asarray, jp)),
                          tier="q4_0")
    jleaves = dict(_walk(jt))
    tleaves = dict(_walk(tt))
    assert jleaves.keys() == tleaves.keys()
    n_q4 = 0
    for path, jl in jleaves.items():
        tl = tleaves[path]
        assert isinstance(jl, jq.Q4Tensor) == isinstance(tl, tq.Q4Tensor), \
            path
        if isinstance(jl, jq.Q4Tensor):
            n_q4 += 1
            _assert_same_q4(jl, tl)
        else:
            np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert n_q4 == 3 + 3 + 4


def test_bridge_tells_q4_from_q8_by_the_code_dtype():
    """A JAX Q4Tensor (uint8 nibble pairs) arrives as a Q4Tensor, a
    Q8Tensor (int8 codes) as a Q8Tensor, and both round-trip."""
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((64, 9)), jnp.float32)
    j4, j8 = jq.quantize_q4_0(w, axis=0), jq.quantize_q8_0(w, axis=0)
    t = params_from_numpy({"w4": jax.tree.map(np.asarray, j4),
                           "w8": jax.tree.map(np.asarray, j8)})
    assert type(t["w4"]) is tq.Q4Tensor and t["w4"].q.shape == (32, 9)
    assert type(t["w8"]) is tq.Q8Tensor and t["w8"].q.shape == (64, 9)
    np.testing.assert_array_equal(
        tq.dequantize_q4_0(t["w4"], axis=0).numpy(),
        np.asarray(jq.dequantize_q4_0(j4, axis=0)))
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["w4"][0], np.asarray(j4.q))
    np.testing.assert_array_equal(back["w4"][1].view(np.uint16),
                                  np.asarray(j4.scale).view(np.uint16))
    with pytest.raises(TypeError, match="codes"):
        params_from_numpy({"w": jq.Q8Tensor(np.zeros((2, 2), np.float32),
                                            np.zeros((1, 2), np.float16))})
