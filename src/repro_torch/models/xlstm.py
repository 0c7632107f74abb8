"""xLSTM blocks of the port (the JAX package's ``models/xlstm.py``): mLSTM
(chunked-parallel prefill, recurrent decode) and sLSTM.

mLSTM is a gated matrix-memory linear recurrence. Prefill runs its
chunked form (intra-chunk quadratic + carried (C, n, m) state with the
running-max stabiliser); decode runs one recurrent step. Both are torch
ops, as the reference computes them in inline einsums outside any Pallas
kernel.

sLSTM has a true sequential dependency (block-diagonal recurrent matrices
per head). Its input projections for all time steps (``_slstm_wx``) and
the stacked recurrent weights (``_stacked_r``) are torch ops, their
weights made once per serving tree (``prepare_slstm``); the
recurrence itself goes through ``dispatch("slstm_scan", ...)``, at
prefill over the whole prompt and at decode with S = 1, so on the card it
runs on the hand-written kernel (``csrc/slstm_scan.cu``). The reference's
model runs the same step math as a ``lax.scan`` over ``_slstm_step`` and
never calls its ``slstm_scan`` op: the port routes through the op on
purpose (ROADMAP queue 3).

The recurrent state cache declares its storage dtype (bf16 in a serving
pool): steps compute in f32 and cast back to the cache's dtype on write,
exactly as the reference, so the tokens served depend on the same bf16
rounding of the state that prefill hands to decode.

Under a meshed serving step with ``model`` > 1 a block takes its
``model`` shard (``layers.unit_form``) and runs it (``_mlstm_split``,
``_slstm_split``). Where the heads divide ``model`` the block runs this
rank's heads, its state the rank's shard of the heads, read and written
in place (``keeps_state``): the mLSTM its inner channels (``w_up`` and
``w_gate`` column-parallel; Q, K, V, the gates' inputs and ``w_down``
row-parallel on them, the out-norm's mean square one f32 all-reduce),
the sLSTM its heads' gate weights, sliced locally, with its hidden
states all-gathered before the norm and its FFN's columns. Where they
do not (the reference's ``serve_row_tp``) every product is row-parallel
on d_model or on the inner dim it contracts, and the recurrence runs
whole on every rank, as the state is placed whole. The bf16 products'
partials are summed once and rounded once (``_row_mm``); the f32 ones
(the sLSTM gates' ``wx``, the mLSTM's ``wi`` / ``wf``) stay f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.kernels.api import dispatch
from repro_torch.models.layers import (SLSTM_GATES, filled, gelu_bf16,
                                       init_rmsnorm, model_axis,
                                       model_chunk, model_dim, model_local,
                                       ninit, prepared, rmsnorm,
                                       row_parallel, row_parallel_mm,
                                       silu_bf16)
from repro_torch.parallel.sharding import constrain

MCHUNK = 128

GATES = SLSTM_GATES

_BF16 = torch.bfloat16
_F32 = torch.float32


def _bf16_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in bf16 (the reference's bf16 einsums), weights cast per
    call as the reference's ``.astype`` does: one bf16 library product on
    the card; on the CPU an f64 product of the bf16 operands rounded once
    to bf16. Its sums of the exact bf16 products lie within f64 rounding
    of exact, so a split block's partials (``_row_mm``) summed over
    ``model`` round as the unsplit product does: the CPU's split checks
    of xLSTM are exact for that reason (a CPU library product, rounded
    apart from an f32 sum in a bf16 element in ten thousand, moves the
    reduced model's logits by ~1e-2 of the largest, the split tests'
    bound; ``ssm._wo`` is the mamba block's twin)."""
    x, w = x.to(_BF16), w.to(_BF16)
    if not x.is_cuda:
        return (x.double() @ w.double()).to(_BF16)
    return x @ w


def _f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in f32 (the gates' input products): on the CPU an f64
    product rounded once to f32, as ``_bf16_mm`` and for its reason."""
    x, w = x.to(_F32), w.to(_F32)
    if not x.is_cuda:
        return (x.double() @ w.double()).to(_F32)
    return x @ w


def _row_mm(x: torch.Tensor, w: torch.Tensor, dtype=_BF16) -> torch.Tensor:
    """``_bf16_mm`` (``dtype`` bf16) or ``_f32_mm`` (f32) row-parallel:
    x holds this rank's ``model`` slice of the contraction and w its
    rows; the partial summed over ``model``, then rounded once to
    ``dtype``. On the card a bf16 product's f32 partial comes from the
    ``fp16_matmul`` kernel (``layers.row_parallel_mm``), an f32
    product's from one f32 product; on the CPU each is an f64 partial."""
    if x.is_cuda:
        if dtype == _BF16:
            return row_parallel_mm(x, w)
        return row_parallel(x.to(_F32) @ w.to(_F32), dtype)
    cast = _BF16 if dtype == _BF16 else _F32
    return row_parallel(x.to(cast).double() @ w.to(cast).double(), dtype)


def keeps_state(p: dict):
    """What of an xLSTM block's state a meshed decode step keeps as this
    rank's ``model`` shard (``layers.gather_cache_layer``'s
    ``keep_model``): all of it where the weights are split over this
    rank's heads (``w_up``'s columns), but the sLSTM's ``m`` where the
    cache does not place it on ``model`` (``_m_on_head_dim``); nothing
    (False) where they are split along d_model (``w_up``'s rows) or
    whole: the state is then whole on ``model``."""
    if model_dim(p["w_up"]) != 1:
        return False
    if "i" not in p:
        return True
    return SSTATE_KEYS if _m_on_head_dim(p) else SSTATE_KEYS[:3]


def _m_on_head_dim(p: dict) -> bool:
    """Whether the cache places an sLSTM block's ``m`` state on
    ``model`` along head_dim. Its axes name (batch, heads) for its (b, h,
    hd) shape, as the reference's ``_CACHE_AXES`` do, so the serve rules
    put ``heads`` on its last dim: on ``model`` where the heads divide
    it (the heads form) and head_dim does too."""
    hd = p["w_up"].shape[0] // p["i"]["w"].shape[1]
    return hd % model_axis().size == 0


def _heads(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's heads of ``t`` (all of them along ``dim``)."""
    axis = model_axis()
    return t.chunk(axis.size, dim)[axis.rank]


def _norm_chunk(w: torch.Tensor, y: torch.Tensor, eps: float):
    """``rmsnorm(w, y)``'s ``model`` chunk of the last dim, from the whole
    ``y`` and ``w``: the mean square of the whole row, then the element
    formula on the chunk alone."""
    yf = y.to(_F32)
    var = yf.square().mean(dim=-1, keepdim=True)
    return (model_chunk(yf) * torch.rsqrt(var + eps)
            * model_chunk(w.to(_F32))).to(y.dtype)


# ----------------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------------

def _mdims(cfg: ArchConfig):
    d_in = int(cfg.proj_factor * cfg.d_model)
    h = cfg.n_heads
    return d_in, h, d_in // h


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    d = cfg.d_model
    d_in, h, _ = _mdims(cfg)
    return {
        "w_up": ninit(gen, (d, d_in), d, device, axes=("param_embed", "inner")),
        "w_gate": ninit(gen, (d, d_in), d, device,
                        axes=("param_embed", "inner")),
        "wq": ninit(gen, (d_in, d_in), d_in, device, axes=("inner", None)),
        "wk": ninit(gen, (d_in, d_in), d_in, device, axes=("inner", None)),
        "wv": ninit(gen, (d_in, d_in), d_in, device, axes=("inner", None)),
        "wi": ninit(gen, (d_in, h), d_in, device, axes=("inner", None)),
        "wf": ninit(gen, (d_in, h), d_in, device, axes=("inner", None)),
        "f_bias": filled((h,), 3.0, device, (None,)),
        "out_norm": init_rmsnorm(d_in, device, ("inner",)),
        "w_down": ninit(gen, (d_in, d), d_in, device,
                        axes=("inner", "param_embed")),
    }


def _mlstm_core_chunked(q, k, v, i_raw, logf, state, chunk=MCHUNK):
    """q/k/v: (B, S, H, hd); i_raw/logf: (B, S, H); state: (C, n, m) with
    C (B, H, hd, hd), n (B, H, hd), m (B, H), f32. Returns (y, state)."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # padded steps add nothing (i = -1e30) and keep everything (logf 0)
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)
        logf = F.pad(logf, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    C, n, m = state
    ys = []
    for c0 in range(0, nc * chunk, chunk):
        sl = slice(c0, c0 + chunk)
        qq, kk, vv = (t[:, sl].to(_F32) for t in (q, k, v))
        ii, ff = i_raw[:, sl], logf[:, sl]
        Fc = torch.cumsum(ff, dim=1)                          # (b, t, h)
        # log weights: intra D[t, s] = F_t - F_s + i_s (s <= t)
        Dlog = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]
        Dlog = torch.where(tri, Dlog, -torch.inf)
        # inter weight of the carried state: F_t + m_prev
        inter_log = Fc + m[:, None, :]                        # (b, t, h)
        m_t = torch.maximum(Dlog.amax(dim=2), inter_log)
        m_t = torch.clamp(m_t, min=-1e30)
        w_intra = torch.exp(Dlog - m_t[:, :, None, :])        # (b, t, s, h)
        w_inter = torch.exp(inter_log - m_t)                  # (b, t, h)

        qk = torch.einsum("bthd,bshd->bths", qq, kk) * scale   # (b, t, h, s)
        sc = qk * w_intra.transpose(2, 3)
        num_intra = torch.einsum("bths,bshd->bthd", sc, vv)
        den_intra = sc.sum(dim=-1)                            # (b, t, h)
        qC = torch.einsum("bthd,bhde->bthe", qq, C) * scale
        qn = torch.einsum("bthd,bhd->bth", qq, n) * scale
        num = num_intra + qC * w_inter[..., None]
        den = den_intra + qn * w_inter
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        ys.append(num / den[..., None])

        # carry to the chunk's end
        F_end = Fc[:, -1, :]                                  # (b, h)
        m_new = torch.maximum(F_end + m,
                              (F_end[:, None] - Fc + ii).amax(dim=1))
        w_state = torch.exp(F_end[:, None] - Fc + ii - m_new[:, None])
        decay = torch.exp(F_end + m - m_new)
        C = C * decay[..., None, None] + torch.einsum(
            "bshd,bshe,bsh->bhde", kk, vv, w_state)
        n = n * decay[..., None] + torch.einsum("bshd,bsh->bhd", kk,
                                                w_state)
        m = m_new
    y = torch.cat(ys, dim=1)[:, :s]
    return y, (C, n, m)


def _mlstm_core_step(q, k, v, i_raw, logf, state):
    """One decode step. q/k/v: (B, H, hd); i_raw/logf: (B, H)."""
    C, n, m = state
    scale = q.shape[-1] ** -0.5
    q, k, v = q.to(_F32), k.to(_F32), v.to(_F32)
    m_new = torch.maximum(logf + m, i_raw)
    decay = torch.exp(logf + m - m_new)
    gain = torch.exp(i_raw - m_new)
    C = C * decay[..., None, None] \
        + gain[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v)
    n = n * decay[..., None] + gain[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C) * scale
    den = torch.einsum("bhd,bhd->bh", q, n) * scale
    den = torch.maximum(den.abs(), torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def _init_mstate(b, h, hd, device):
    return (torch.zeros((b, h, hd, hd), device=device),
            torch.zeros((b, h, hd), device=device),
            torch.full((b, h), -1e30, device=device))


def mlstm_block(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                mode: str = "train", cache: Optional[dict] = None):
    """x: (B, S, d). Returns (out (B, S, d) in x's dtype, new cache or
    None). ``cache`` ``{C, n, m}`` is the lane state (decode) or, at
    prefill, names the storage dtype of the state returned."""
    if model_dim(p["w_up"]) is not None:
        return _mlstm_split(p, x, cfg, mode, cache)
    b, s, _ = x.shape
    d_in, h, hd = _mdims(cfg)
    u = constrain(_bf16_mm(x, p["w_up"]), "batch", "q_seq", "inner")
    g = silu_bf16(_bf16_mm(x, p["w_gate"]))
    q = _bf16_mm(u, p["wq"]).reshape(b, s, h, hd)
    k = _bf16_mm(u, p["wk"]).reshape(b, s, h, hd)
    v = _bf16_mm(u, p["wv"]).reshape(b, s, h, hd)
    uf = u.to(_F32)
    wi = prepared(p, "wi_f32", lambda: p["wi"].to(_F32))
    wf = prepared(p, "wf_f32", lambda: p["wf"].to(_F32))
    i_raw = _f32_mm(uf, wi)
    logf = F.logsigmoid(_f32_mm(uf, wf) + p["f_bias"].to(_F32))

    cdt = cache["C"].dtype if cache is not None else _F32
    if mode == "decode":
        assert cache is not None
        state = tuple(cache[key].to(_F32) for key in ("C", "n", "m"))
        y, (C, n, m) = _mlstm_core_step(q[:, 0], k[:, 0], v[:, 0],
                                        i_raw[:, 0], logf[:, 0], state)
        y = y[:, None]
        new_cache = {"C": C.to(cdt), "n": n.to(cdt), "m": m.to(cdt)}
    else:
        state = _init_mstate(b, h, hd, x.device)
        y, (C, n, m) = _mlstm_core_chunked(q, k, v, i_raw, logf, state)
        new_cache = {"C": C.to(cdt), "n": n.to(cdt), "m": m.to(cdt)} \
            if mode == "prefill" else None

    y = y.reshape(b, -1, d_in).to(x.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * g[:, :y.shape[1]]
    out = _bf16_mm(y, p["w_down"]).to(x.dtype)
    return constrain(out, "batch", "q_seq", "embed"), new_cache


def _mlstm_split(p: dict, x: torch.Tensor, cfg: ArchConfig, mode: str,
                 cache: Optional[dict]):
    """``mlstm_block`` on this rank's ``model`` shard (the module's
    split): its heads where ``keeps_state``, the state then this rank's
    heads (``model_local``), else along d_model with the core whole."""
    b, s, _ = x.shape
    d_in, h, hd = _mdims(cfg)
    axis = model_axis()
    heads = keeps_state(p)
    if heads:    # this rank's inner channels: its heads
        u = _bf16_mm(x, p["w_up"])
        g = silu_bf16(_bf16_mm(x, p["w_gate"]))
        ul = u
    else:        # row-parallel on d_model: u and g whole
        xl = model_chunk(x)
        u = _row_mm(xl, p["w_up"])
        g = silu_bf16(_row_mm(xl, p["w_gate"]))
        ul = model_chunk(u)
    # Q, K, V (one bf16 all-reduce) and the gates' inputs (one f32 one),
    # row-parallel on this rank's inner channels, whole after the sum
    qkv = _row_mm(ul, torch.cat([p["wq"], p["wk"], p["wv"]], 1))
    gates = _row_mm(ul, torch.cat([p["wi"], p["wf"]], 1), _F32)
    i_raw = gates[..., :h]
    logf = F.logsigmoid(gates[..., h:] + p["f_bias"].to(_F32))
    q, k, v = (qkv[..., j * d_in:(j + 1) * d_in].reshape(b, s, h, hd)
               for j in range(3))
    if heads:
        q, k, v = (_heads(t, 2) for t in (q, k, v))
        i_raw, logf = _heads(i_raw, 2), _heads(logf, 2)
    n_h = q.shape[2]

    cdt = cache["C"].dtype if cache is not None else _F32
    if mode == "decode":
        assert cache is not None
        state = tuple(cache[key].to(_F32) for key in ("C", "n", "m"))
        y, (C, n, m) = _mlstm_core_step(q[:, 0], k[:, 0], v[:, 0],
                                        i_raw[:, 0], logf[:, 0], state)
        y = y[:, None]
    else:
        state = _init_mstate(b, n_h, hd, x.device)
        y, (C, n, m) = _mlstm_core_chunked(q, k, v, i_raw, logf, state)
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {"C": C.to(cdt), "n": n.to(cdt), "m": m.to(cdt)}
        if heads:
            new_cache = {key: model_local(t, 1)
                         for key, t in new_cache.items()}

    y = y.reshape(b, -1, n_h * hd).to(x.dtype)
    if heads:    # out_norm is this rank's chunk: one f32 all-reduce
        y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * g[:, :y.shape[1]]
    else:
        y = _norm_chunk(p["out_norm"], y, cfg.norm_eps) \
            * model_chunk(g)[:, :y.shape[1]]
    out = _row_mm(y, p["w_down"]).to(x.dtype)
    return constrain(out, "batch", "q_seq", "embed"), new_cache


def prepare_mlstm(p: dict) -> dict:
    """An mLSTM block's weights (one block's or stacked) with the f32
    gate weights that ``mlstm_block`` would widen at every call."""
    return {**p, "wi_f32": p["wi"].to(_F32), "wf_f32": p["wf"].to(_F32)}


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype=_BF16,
                     device=None) -> dict:
    """Per-lane mLSTM state ``{C: (b, h, hd, hd), n: (b, h, hd), m: (b,
    h)}`` in the storage ``dtype`` (every leaf, ``m`` included)."""
    _, h, hd = _mdims(cfg)
    C, n, m = _init_mstate(batch, h, hd, device)
    return {"C": C.to(dtype), "n": n.to(dtype), "m": m.to(dtype)}


# ----------------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    up = int(cfg.proj_factor * d)

    def gate():
        return {"w": ninit(gen, (d, h, hd), d, device,
                           axes=("param_embed", None, None)),
                "r": ninit(gen, (h, hd, hd), hd, device,
                           axes=(None, None, None)),
                "b": filled((h, hd), 0.0, device, (None, None))}

    return {
        "i": gate(), "f": gate(), "z": gate(), "o": gate(),
        "out_norm": init_rmsnorm(d, device),
        "w_up": ninit(gen, (d, up), d, device, axes=("param_embed", "inner")),
        "w_down": ninit(gen, (up, d), up, device,
                        axes=("inner", "param_embed")),
    }


def _widen_w(w: torch.Tensor) -> torch.Tensor:
    """A gate's input weight rounded to bf16 and widened to f32."""
    return w.to(_BF16).to(_F32)


def _slstm_wx(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Input pre-activations of all time steps at once: (4, B, S, H, hd),
    f32. The reference's bf16 x bf16 einsum with f32 accumulation: bf16
    operands widened to f32 give exact products."""
    b, s, d = x.shape
    xb = x.to(_BF16).to(_F32).reshape(b * s, d)
    out = []
    for g in GATES:
        w = p[g]["w"]
        wf = prepared(p[g], "w_f32", lambda: _widen_w(w)).reshape(d, -1)
        y = _f32_mm(xb, wf).reshape(b, s, *w.shape[1:])
        out.append(y + p[g]["b"].to(_F32))
    return torch.stack(out)


def _stacked_r(p: dict) -> torch.Tensor:
    """(4, H, hd, hd) stacked recurrent weights (or (n, 4, H, hd, hd) for
    n stacked blocks): bf16 as stored (no f32 copy; ``slstm_scan`` widens
    each element as it reads it, and a bf16 value is exact in f32), f32
    otherwise."""
    rs = [p[g]["r"] for g in GATES]
    dt = _BF16 if all(r.dtype == _BF16 for r in rs) else _F32
    return torch.stack([r.to(dt) for r in rs], dim=-4)


def prepare_slstm(p: dict) -> dict:
    """An sLSTM block's weights (one block's or stacked) with what
    ``slstm_block`` would derive at every call made once: each gate's
    widened input weight (``w_f32``; ~201 MB a decode step over
    xlstm-350m's 12 sLSTM blocks) and the stacked recurrent weights
    (``r_stacked``)."""
    out = {**p, **{g: {**p[g], "w_f32": _widen_w(p[g]["w"])}
                   for g in GATES}}
    out["r_stacked"] = _stacked_r(p)
    return out


def _init_sstate(b, h, hd, device) -> torch.Tensor:
    """Stacked (c, n, h, m) initial state, (4, b, h, hd) f32."""
    st = torch.zeros((4, b, h, hd), device=device)
    st[3] = -1e30
    return st


SSTATE_KEYS = ("c", "n", "h", "m")


def slstm_block(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                mode: str = "train", cache: Optional[dict] = None):
    """x: (B, S, d). The recurrence over all S steps is one
    ``slstm_scan`` call: from the lane state at decode (S = 1), from the
    initial state otherwise. Returns (out, new cache or None)."""
    if model_dim(p["w_up"]) is not None:
        return _slstm_split(p, x, cfg, mode, cache)
    b, s, d = x.shape
    h_, hd = cfg.n_heads, d // cfg.n_heads
    cdt = cache["c"].dtype if cache is not None else _F32
    if mode == "decode":
        assert cache is not None
        state0 = torch.stack([cache[key].to(_F32) for key in SSTATE_KEYS])
    else:
        state0 = _init_sstate(b, h_, hd, x.device)
    wx = _slstm_wx(p, x).permute(2, 0, 1, 3, 4).contiguous()  # (S,4,B,H,hd)
    hs, state = dispatch("slstm_scan", wx,
                         prepared(p, "r_stacked", lambda: _stacked_r(p)),
                         state0)
    y = hs.permute(1, 0, 2, 3).reshape(b, s, d)
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {key: state[i].to(cdt)
                     for i, key in enumerate(SSTATE_KEYS)}

    y = rmsnorm(p["out_norm"], y.to(x.dtype), cfg.norm_eps)
    u = gelu_bf16(_bf16_mm(y, p["w_up"]))
    out = _bf16_mm(u, p["w_down"])
    return out.to(x.dtype), new_cache


def _slstm_split(p: dict, x: torch.Tensor, cfg: ArchConfig, mode: str,
                 cache: Optional[dict]):
    """``slstm_block`` on this rank's ``model`` shard (the module's
    split): its heads where ``keeps_state`` (the gate weights sliced
    locally, the state this rank's heads, the hidden states all-gathered
    before the whole norm, ``w_up`` column-parallel), else the gates'
    ``wx`` row-parallel on d_model in f32 and the scan whole; ``w_down``
    row-parallel either way."""
    b, s, d = x.shape
    h_, hd = cfg.n_heads, d // cfg.n_heads
    axis = model_axis()
    heads = keeps_state(p)
    cdt = cache["c"].dtype if cache is not None else _F32
    if heads:
        gates = {g: {"w": _heads(p[g]["w"], 1), "r": _heads(p[g]["r"], 0),
                     "b": _heads(p[g]["b"], 0)} for g in GATES}
        wx = _slstm_wx(gates, x)
    else:
        xl = model_chunk(x.to(_BF16)).reshape(b * s, -1)
        w = torch.cat([_widen_w(p[g]["w"]).reshape(xl.shape[1], -1)
                       for g in GATES], 1)
        y = _row_mm(xl, w, _F32).reshape(b, s, len(GATES), h_, hd)
        wx = torch.stack([y[:, :, j] + p[g]["b"].to(_F32)
                          for j, g in enumerate(GATES)])
        gates = p
    n_h = wx.shape[3]
    # the heads form's m state: the cache holds it on head_dim (all the
    # heads; one all-to-all each way) or whole (this rank's heads read,
    # every rank's gathered back)
    m_hd = heads and _m_on_head_dim(p)
    if mode == "decode":
        assert cache is not None
        st = dict(cache)
        if m_hd:
            st["m"] = axis.all_to_all(st["m"], split_dim=1, cat_dim=2)
        elif heads:
            st["m"] = _heads(st["m"], 1)
        state0 = torch.stack([st[key].to(_F32) for key in SSTATE_KEYS])
    else:
        state0 = _init_sstate(b, n_h, hd, x.device)
    hs, state = dispatch("slstm_scan", wx.permute(2, 0, 1, 3, 4).contiguous(),
                         _stacked_r(gates), state0)
    if heads:
        hs = axis.all_gather(hs, dim=2)
    y = hs.permute(1, 0, 2, 3).reshape(b, s, d)
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {key: state[i].to(cdt)
                     for i, key in enumerate(SSTATE_KEYS)}
        if heads:
            m = new_cache.pop("m")
            new_cache = {key: model_local(t, 1)
                         for key, t in new_cache.items()}
            new_cache["m"] = model_local(axis.all_to_all(
                m, split_dim=2, cat_dim=1), 2) if m_hd \
                else axis.all_gather(m, dim=1)

    y = rmsnorm(p["out_norm"], y.to(x.dtype), cfg.norm_eps)
    if heads:
        u = gelu_bf16(_bf16_mm(y, p["w_up"]))
        out = _row_mm(u, p["w_down"])
    else:
        u = gelu_bf16(_row_mm(model_chunk(y), p["w_up"]))
        out = _row_mm(model_chunk(u), p["w_down"])
    return out.to(x.dtype), new_cache


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype=_BF16,
                     device=None) -> dict:
    """Per-lane sLSTM state, four (b, h, hd) leaves in the storage
    ``dtype``."""
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    st = _init_sstate(batch, h, hd, device)
    return {key: st[i].to(dtype) for i, key in enumerate(SSTATE_KEYS)}
