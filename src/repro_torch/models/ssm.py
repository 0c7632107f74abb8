"""Mamba2 (SSD) block of the port (the JAX package's ``models/ssm.py``),
zamba2's backbone.

Train and prefill run the chunked SSD algorithm: within a chunk of
``CHUNK`` positions a quadratic term (C_t . B_s weighed by the decay from
s to t), across chunks the carried state ``h`` (B, H, hd, N), a Python
loop over the chunks in the place of the reference's ``lax.scan``.
Decode runs the O(1) recurrent update of ``h`` and of the causal conv's
tail. Every decay exponential is of a non-positive argument (log a <= 0),
so the chunked form needs no rescaling. All of it is torch ops, as the
reference computes it in inline einsums outside any Pallas kernel.

The in-projections (z, x, B, C) are bf16 products (bf16 operands, bf16
out, as the reference's bf16 einsums), the out-projection a product of
bf16 operands rounded once to bf16 (``_wo``; split, its f32 partial is
all-reduced first); ``dt`` is an f32 product, as the reference computes
``dt_raw``. The SSD's einsums and the conv run in
f32. On the card f32 products must not round through TF32: the library
entry points rely on torch's default
(``torch.backends.cuda.matmul.allow_tf32 = False``).

The cache is ``{"conv": (B, W - 1, d_in + 2N), "h": (B, H, hd, N)}`` in
its storage dtype (bf16 in a serving pool): the steps compute in f32 and
cast back on write, as the reference does.

Under a meshed serving step with ``model`` > 1 the block takes its
``inner`` shard (``layers.unit_form``): this rank's columns of ``wz`` /
``wx``, its conv taps and its SSM heads (``wdt``, ``dt_bias``, ``A_log``,
``D``), with ``wB``, ``wC`` and their taps whole. Its in-projection is
those columns beside the whole B and C ones; the conv, ``dt`` and the
SSD run on its heads; the gated norm takes the row's mean square with
one f32 all-reduce; ``wo`` is row-parallel (``layers.row_parallel``).
The state ``h`` lies on the SSM heads, as the split does, and stays this
rank's shard (``SPLIT_STATE``). The ``conv`` leaf is the exception: the
cache places the last dim of (B, W - 1, d_in + 2N) on ``model``, whose
chunks do not line up with a rank's x channels beside the whole B and
C (zamba2-7b: 456 stored against 448 + 128 read). So a decode step
reads that leaf whole (gathered over ``model``, a few KB a row) and
takes its part, and the block returns the new tail whole, its x
channels all-gathered over ``model``, of which the step writes back
this rank's chunk.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import (filled, mm, model_axis, model_dim,
                                       model_local, ninit, prepared, rmsnorm,
                                       row_parallel, silu_bf16)
from repro_torch.parallel.sharding import constrain

CHUNK = 256

_BF16 = torch.bfloat16
_F32 = torch.float32

#: the in-projections, fused in this order into ``w_in`` (d, 2 d_in + 2N)
_IN = ("wz", "wx", "wB", "wC")
#: the depthwise conv taps, fused in this order into ``conv_w`` (W, d_in + 2N)
_CONV = ("conv_x", "conv_B", "conv_C")
#: the cache leaves a split block reads and writes as its ``model`` shard
#: (``layers.gather_cache_layer``'s ``keep_model``); ``conv`` is read whole
SPLIT_STATE = ("h",)


def _dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state, cfg.ssm_head_dim


def init_mamba(gen: torch.Generator, cfg: ArchConfig, device,
               dtype=_F32) -> dict:
    """The reference's leaves and shapes. ``dtype``: the storage type of
    the projections (wz, wx, wB, wC, wo); ``wdt``, ``dt_bias``,
    ``A_log``, ``D``, ``out_norm`` and the conv taps stay f32 (the conv's
    product is f32, as jax promotes bf16 x f32)."""
    d = cfg.d_model
    d_in, h, n, _ = _dims(cfg)
    w = cfg.ssm_conv
    return {
        "wz": ninit(gen, (d, d_in), d, device, dtype,
                    axes=("param_embed", "inner")),
        "wx": ninit(gen, (d, d_in), d, device, dtype,
                    axes=("param_embed", "inner")),
        "wB": ninit(gen, (d, n), d, device, dtype, axes=("param_embed", None)),
        "wC": ninit(gen, (d, n), d, device, dtype, axes=("param_embed", None)),
        "wdt": ninit(gen, (d, h), d, device, axes=("param_embed", "ssm_heads")),
        "dt_bias": filled((h,), 0.0, device, ("ssm_heads",)),
        "A_log": filled((h,), 0.0, device, ("ssm_heads",)),
        "D": filled((h,), 1.0, device, ("ssm_heads",)),
        "conv_x": ninit(gen, (w, d_in), w, device, axes=("conv", "inner")),
        "conv_B": ninit(gen, (w, n), w, device, axes=("conv", None)),
        "conv_C": ninit(gen, (w, n), w, device, axes=("conv", None)),
        "out_norm": filled((d_in,), 1.0, device, ("inner",)),
        "wo": ninit(gen, (d_in, d), d_in, device, dtype,
                    axes=("inner", "param_embed")),
    }


def prepare_mamba(p: dict) -> dict:
    """A mamba block's weights (one block's or stacked) with what
    ``mamba_block`` would derive at every call made once: the fused bf16
    in-projection ``w_in`` (wz | wx | wB | wC), the fused conv taps
    ``conv_w`` and ``wo`` in bf16. ``wdt`` stays f32."""
    return {**p, "w_in": _w_in(p), "conv_w": _conv_w(p),
            "wo": p["wo"].to(_BF16)}


def _w_in(p: dict) -> torch.Tensor:
    return torch.cat([p[k].to(_BF16) for k in _IN], dim=-1)


def _conv_w(p: dict) -> torch.Tensor:
    return torch.cat([p[k] for k in _CONV], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, x: (B, S, C), w: (W, C). The W taps are
    summed in the reference's order, from 0; a bf16 x times the f32 taps
    is f32. Returns (silu of the sum, the last W - 1 input rows)."""
    width = w.shape[0]
    s = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    ys = 0
    for i in range(width):
        ys = ys + xp[:, i:i + s, :] * w[i]
    return F.silu(ys), xp[:, xp.shape[1] - (width - 1):, :]


def _ssd_chunked(xh, dt, a_log_dt, B, C, h0, chunk: int = CHUNK):
    """Chunked SSD.
      xh: (B, S, H, hd)   inputs per head
      dt: (B, S, H)       softplus'd step sizes
      a_log_dt: (B, S, H) log decay a step (-exp(A_log) * dt, <= 0)
      B, C: (B, S, N)
      h0: (B, H, hd, N)   initial state
    Padding to a whole chunk has dt = 0 and log decay 0: it adds nothing
    to the state. Returns (y (B, S, H, hd) f32, the final state f32)."""
    b, s, h, hd = xh.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, a_log_dt = (F.pad(t, (0, 0, 0, pad)) for t in (dt, a_log_dt))
        B, C = (F.pad(t, (0, 0, 0, pad)) for t in (B, C))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    h_prev = h0.to(_F32)
    ys = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        xq, dtq, aq = xh[:, sl], dt[:, sl], a_log_dt[:, sl]
        Bq, Cq = B[:, sl].to(_F32), C[:, sl].to(_F32)
        acs = torch.cumsum(aq, dim=1)                        # (b, q, h)
        # intra-chunk: scores[t, s] = C_t . B_s * exp(acs_t - acs_s) (s <= t)
        cb = torch.einsum("btn,bsn->bts", Cq, Bq)
        seg = acs[:, :, None, :] - acs[:, None, :, :]        # (b, t, s, h)
        # masked before the product: the upper triangle's exp may be inf
        w_ts = torch.where(tri, torch.exp(seg), 0.0)
        scores = cb[..., None] * w_ts
        xdt = xq.to(_F32) * dtq[..., None]                   # (b, s, h, hd)
        y_intra = torch.einsum("btsh,bshd->bthd", scores, xdt)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("btn,bhdn->bthd", Cq, h_prev) \
            * torch.exp(acs)[..., None]
        # the state at the chunk's end
        decay_to_end = torch.exp(acs[:, -1:, :] - acs)       # (b, s, h)
        dh = torch.einsum("bshd,bsn,bsh->bhdn", xdt, Bq, decay_to_end)
        h_prev = h_prev * torch.exp(acs[:, -1])[:, :, None, None] + dh
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :s], h_prev


def is_split(p: dict) -> bool:
    """Whether a mamba block's weights are this rank's ``inner`` shard."""
    return model_dim(p["wz"]) is not None


def _conv_part(state: torch.Tensor, d_in: int, d_l: int) -> torch.Tensor:
    """This rank's part of a whole conv state (..., d_in + 2N): its d_l
    x channels beside B and C."""
    r = model_axis().rank
    return torch.cat([state[..., r * d_l:(r + 1) * d_l],
                      state[..., d_in:]], dim=-1)


def _whole_tail(tail: torch.Tensor, d_l: int) -> torch.Tensor:
    """A split block's new conv tail (..., d_l + 2N) whole: its x
    channels all-gathered over ``model`` in rank order, then B and C."""
    return torch.cat([model_axis().all_gather(tail[..., :d_l], dim=-1),
                      tail[..., d_l:]], dim=-1)


def _wo(y: torch.Tensor, wo: torch.Tensor, split: bool) -> torch.Tensor:
    """The out-projection y @ wo of bf16 operands, rounded once to bf16.
    On the card the unsplit block takes one bf16 library product (as the
    reference's einsum; differentiable), a split one its f32 partial
    (``mm``'s ``out_dtype``: the ``fp16_matmul`` kernel), all-reduced
    over ``model`` before the rounding (``row_parallel``). On the CPU
    an f64 product, split or not: its sums of the exact bf16 products
    lie within f64 rounding of exact, so a split block rounds as the
    unsplit one does. The CPU's split checks of the hybrid are exact for
    that reason alone: an f32 sum reassociated over ``model`` flips one
    bf16 rounding in a few thousand, which the reduced 12-layer hybrid's
    random weights carry to 1.2e-2 of the largest logit, past
    ``SPLIT_TOL`` (1e-2)."""
    y, wo = y.to(_BF16), wo.to(_BF16)
    if not y.is_cuda:
        out = y.double() @ wo.double()
        return row_parallel(out) if split else out.to(_BF16)
    if split:
        return row_parallel(mm(y, wo, out_dtype=_F32))
    return y @ wo


def mamba_block(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                mode: str = "train", cache: Optional[dict] = None):
    """x: (B, S, d). Returns (out (B, S, d) in x's dtype, new cache or
    None). ``cache`` is the lane state (decode) or, at prefill, names the
    storage dtype of the state returned (bf16 without one). Split over
    ``model`` (``is_split``) the block runs its inner shard, as the
    module says: ``h`` comes in and goes out as this rank's heads
    (``model_local``), ``conv`` whole."""
    b, s, _ = x.shape
    d_in, _, n, hd = _dims(cfg)
    split = is_split(p)
    d_l, h = p["wz"].shape[-1], p["wdt"].shape[-1]   # this rank's
    xb = x.to(_BF16)
    # a split block fuses its own shard's projections (a serving tree's
    # fused leaves are the whole block's)
    w_in = _w_in(p) if split else prepared(p, "w_in", lambda: _w_in(p))
    zxbc = xb @ w_in
    z = constrain(silu_bf16(zxbc[..., :d_l]), "batch", "q_seq", "inner")
    xbc = zxbc[..., d_l:]                                  # x | B | C, bf16
    dt = F.softplus(x.to(_F32) @ p["wdt"].to(_F32) + p["dt_bias"])
    a_log_dt = -torch.exp(p["A_log"].to(_F32)) * dt        # (b, s, h)
    conv_w = _conv_w(p) if split \
        else prepared(p, "conv_w", lambda: _conv_w(p))

    if mode == "decode":
        assert cache is not None
        state = cache["conv"]
        if split:
            state = _conv_part(state, d_in, d_l)
        xbc, tail = _causal_conv(xbc, conv_w, state)
        xh = xbc[:, 0, :d_l].reshape(b, h, hd)
        Bi, Ci = xbc[:, 0, d_l:d_l + n], xbc[:, 0, d_l + n:]
        decay = torch.exp(a_log_dt[:, 0])                  # (b, h)
        xdt = xh * dt[:, 0, :, None]                       # (b, h, hd)
        dh = xdt[..., None] * Bi[:, None, None, :]         # (b, h, hd, n)
        h_new = cache["h"].to(_F32) * decay[:, :, None, None] + dh
        # Ci is f32 but for bf16 conv taps (a dry-run's bf16 weights)
        y = (h_new @ Ci.to(_F32)[:, None, :, None])[..., 0]  # (b, h, hd)
        y = y + xh * p["D"][None, :, None]
        y = y.reshape(b, 1, d_l)
        new_cache = {"conv": tail.to(cache["conv"].dtype),
                     "h": h_new.to(cache["h"].dtype)}
    else:
        xbc, tail = _causal_conv(xbc, conv_w)
        xh = xbc[..., :d_l].reshape(b, s, h, hd)
        Bi, Ci = xbc[..., d_l:d_l + n], xbc[..., d_l + n:]
        h0 = torch.zeros((b, h, hd, n), dtype=_F32, device=x.device)
        y, h_fin = _ssd_chunked(xh, dt, a_log_dt, Bi, Ci, h0)
        y = y + xh * p["D"][None, None, :, None]
        y = y.reshape(b, s, d_l)
        new_cache = None
        if mode == "prefill":
            cdt = cache["h"].dtype if cache is not None else _BF16
            new_cache = {"conv": tail.to(cdt), "h": h_fin.to(cdt)}
    if split and new_cache is not None:
        new_cache = {"conv": _whole_tail(new_cache["conv"], d_l),
                     "h": model_local(new_cache["h"], 1)}

    y = rmsnorm(p["out_norm"], y.to(x.dtype), cfg.norm_eps) * z
    out = _wo(y, p["wo"], split)
    return constrain(out.to(x.dtype), "batch", "q_seq", "embed"), new_cache


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype=_BF16,
                     device=None) -> dict:
    """Per-lane mamba state ``{conv: (b, W - 1, d_in + 2N), h: (b, H, hd,
    N)}`` in the storage ``dtype``, zeros."""
    d_in, h, n, hd = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, h, hd, n), dtype=dtype, device=device)}


def mamba_recurrent_ref(p: dict, x: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    """Step-by-step oracle of the chunked SSD path (tests): every
    position a decode step from the zero f32 state."""
    cache = init_mamba_cache(cfg, x.shape[0], _F32, x.device)
    ys = []
    for t in range(x.shape[1]):
        y, cache = mamba_block(p, x[:, t:t + 1], cfg, mode="decode",
                               cache=cache)
        ys.append(y)
    return torch.cat(ys, dim=1)
