"""Attention block of the port (the JAX package's ``models/attention.py``):
the Whisper paths and the decoder-only families' GQA, QKV biases,
qk-norm, rotary positions, sliding and local windows and logit softcap.

Train/prefill project Q/K/V (the fused ``wqkv`` product of self-attention,
then biases and qk-norm, then rope where the block asks for it) and run
``dispatch("flash_attention")``: the encoder's bidirectional
self-attention, the causal prefill and the cross-attention prefill
(Sq != Skv), all on the one kernel. Decode takes the serving engine's
stacked cache, ``{"k", "v"}`` (bf16), ``{"kq", "ks", "vq", "vs"}`` (q8_0)
or ``{"kp", "ks", "vp", "vs"}`` (q4_0, nibble-packed along head_dim)
planes of shape (L, B, S, Hkv, .), and a per-lane position vector. x
carries Q tokens a lane: Q = 1 in plain decode, ``spec_k`` in the
speculative verify, where token j sits at pos + j and attends [0, pos +
j]; rope rotates q and k at those positions, read from the device
tensor, so a captured tick takes them from the lane state:

* self-attention writes the Q new tokens of every lane at (layer, b,
  pos[b] + j) **in place** (``index_put_``; the reference's functional
  update returns a new buffer under donation), then reads the layer —
  bf16 through einsum decode in torch ops with a (B, Q, K) mask (causal,
  and the window where the layer has one; softcap where the model has
  one), q8_0 and q4_0 through ``dispatch("q8_decode_attention")`` /
  ``dispatch("q4_decode_attention")``, which read the stacked planes
  where they lie, with (B,) lengths for Q = 1 and (B, Q) for Q > 1;
* cross-attention reads the cached encoder K/V, every query of lane b
  attending positions [0, kv_lens[b]).

The quantized tiers and the paged pool take plain softmax attention
only, as the reference's do: a softcap or a window raises there.

Split over ``model`` (a meshed serving step, ``layers.split_unit``) the
block runs on this rank's query heads and ``wo`` is row-parallel. In
the ``heads`` form its K/V heads are its shard too, and so is the cache
it reads. In the ``head_dim`` form (the KV heads do not divide
``model``; the cache splits head_dim) ``wk`` and ``wv`` are this rank's
head_dim slice of every KV head, multiplied beside its query heads in
one product, and K and V come out on that slice. K's slices are
all-gathered along head_dim before the qk-norm and rope, which read the
whole head_dim (rope pairs dim i with i + D/2), and the cache keeps the
rank's slice of the result; V's slice goes into the cache as it is. A
prefill all-gathers V's slices too, so its query heads read their KV
heads at full head_dim; a decode step gathers the query of every head,
sums the scores of its head_dim slice over ``model`` in f32, and moves
P.V from its slice of every head to the whole head_dim of its heads
with one all-to-all. In the ``param_embed`` form (the heads do not
divide ``model``: the reference's ``serve_row_tp``) Q, K and V are
row-parallel on this rank's d_model slice of x and whole after their
sum, and every head runs on every rank. A prefill is context-parallel,
as the reference places ``q_seq`` on ``model``: a rank attends its
block of ceil(S / tp) query positions with every head over the whole K
and V (``flash_attention`` at the block's ``q_offset``), and the
blocks' outputs meet again before ``wo``; a decode step's one position
runs on every rank. Where the cache splits head_dim (``wo`` lies on
head_dim), the cache keeps this rank's slice, the prefill's blocks move
to the slice of every position by one all-to-all, a decode step sums
the scores of the slice over ``model`` in f32 from the whole query (no
gather of it) and runs P.V on the slice, and ``wo`` is row-parallel
over the slice; where head_dim does not divide ``model`` the cache is
whole, read locally, the prefill's blocks are all-gathered, and ``wo``
(on d_model) is column-parallel, its output all-gathered.

With a ``page_table`` the planes are a paged pool (L, n_pages, P, Hkv,
.) shared by the lanes (``repro_torch.paging``): self-attention writes
token j of lane b at (layer, table[b, (pos + j) // P], (pos + j) % P),
the logical page clipped to the row as the reference clips it, and both
attentions read through ``dispatch("paged_decode_attention")``, a
gather over the table followed by the slot pool's decode.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.api import dispatch
from repro_torch.kernels.paged_attention.plain import (bf16_decode_attention,
                                                      grouped_scores,
                                                      grouped_values)
from repro_torch.models.layers import (attention_form, filled,
                                       meshed_rows, mm, mm_out,
                                       model_axis, model_chunk, model_dim,
                                       model_local, ninit, prepared,
                                       rmsnorm, rope, row_parallel_mm)
from repro_torch.parallel.sharding import constrain
from repro_torch.quantize import QBLOCK, quantize_q4_0, quantize_q8_0


def init_attention(gen: torch.Generator, cfg: ArchConfig, device,
                   dtype=torch.float32) -> dict:
    """Projections in ``dtype``; the biases (zeros) and the qk-norm
    weights (ones) in f32, as the reference keeps them."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ninit(gen, (d, h, dh), d, device, dtype,
                    axes=("param_embed", "heads", "head_dim")),
        "wk": ninit(gen, (d, hk, dh), d, device, dtype,
                    axes=("param_embed", "kv_heads", "head_dim")),
        "wv": ninit(gen, (d, hk, dh), d, device, dtype,
                    axes=("param_embed", "kv_heads", "head_dim")),
        "wo": ninit(gen, (h, dh, d), h * dh, device, dtype,
                    axes=("heads", "head_dim", "param_embed")),
    }
    if cfg.attn_bias:
        p["bq"] = filled((h, dh), 0.0, device, ("heads", "head_dim"))
        p["bk"] = filled((hk, dh), 0.0, device, ("kv_heads", "head_dim"))
        p["bv"] = filled((hk, dh), 0.0, device, ("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p["q_norm"] = filled((dh,), 1.0, device, ("head_dim",))
        p["k_norm"] = filled((dh,), 1.0, device, ("head_dim",))
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 x_kv: Optional[torch.Tensor] = None):
    """(q, k, v) after their biases and qk-norm. In the ``head_dim`` form
    q is this rank's query heads, k every KV head at full head_dim (its
    slices all-gathered over ``model``) and v this rank's head_dim slice
    of every KV head."""
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    form = attention_form(p)
    if form == "head_dim":
        q, k, v = _head_dim_qkv(p, x, x_kv)
        return bias_norm(p, q, cfg, "q"), \
            bias_norm(p, k, cfg, "k", gather=True), bias_norm(p, v, cfg, "v")
    if form == "param_embed":
        # row-parallel on this rank's d_model slice, whole after the sum
        xl = model_chunk(x)
        if x_kv is None:
            h, hk = wq.shape[1], wk.shape[1]
            y = row_parallel_mm(xl, torch.cat([wq, wk, wv], dim=1))
            q, k, v = y[..., :h, :], y[..., h:h + hk, :], y[..., h + hk:, :]
        else:
            kvl = model_chunk(x_kv)
            q, k, v = (row_parallel_mm(xl, wq), row_parallel_mm(kvl, wk),
                       row_parallel_mm(kvl, wv))
    elif x_kv is None and isinstance(wq, torch.Tensor):
        # self-attention with plain weights: one QKV product over the
        # head-concatenated weight (the same per-element contraction);
        # the heads as the weights hold them (a split's: this rank's)
        h, hk = wq.shape[1], wk.shape[1]
        wqkv = prepared(p, "wqkv", lambda: torch.cat([wq, wk, wv], dim=1))
        y = mm(x, wqkv)
        q, k, v = y[..., :h, :], y[..., h:h + hk, :], y[..., h + hk:, :]
    else:
        x_kv = x if x_kv is None else x_kv
        q, k, v = mm(x, wq), mm(x_kv, wk), mm(x_kv, wv)
    return bias_norm(p, q, cfg, "q"), bias_norm(p, k, cfg, "k"), \
        bias_norm(p, v, cfg, "v")


def _head_dim_qkv(p: dict, x: torch.Tensor,
                  x_kv: Optional[torch.Tensor]) -> tuple:
    """The ``head_dim`` form's products, before the biases: x against
    this rank's query heads beside its head_dim slice of every KV head,
    one (d, H/tp * D + 2 * Hkv * D/tp) product for self-attention
    (cross-attention: q of x, then one product of x_kv for k and v).
    Returns q (..., H/tp, D), k and v (..., Hkv, D/tp)."""
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    d = wq.shape[0]
    ws = [w.reshape(d, -1) for w in (wq, wk, wv)]
    nq, nk = ws[0].shape[1], ws[1].shape[1]
    if x_kv is None:
        q, k, v = mm(x, torch.cat(ws, dim=1)).split([nq, nk, nk], dim=-1)
    else:
        q = mm(x, ws[0])
        k, v = mm(x_kv, torch.cat(ws[1:], dim=1)).split([nk, nk], dim=-1)
    return (q.unflatten(-1, wq.shape[1:]), k.unflatten(-1, wk.shape[1:]),
            v.unflatten(-1, wv.shape[1:]))


def bias_norm(p: dict, t: torch.Tensor, cfg: ArchConfig,
              which: str, gather: bool = False) -> torch.Tensor:
    """The projection ``which`` ("q", "k", "v") with its bias added in
    its own dtype and, for q and k, the qk-norm, as the reference's
    ``_project_qkv`` does after the product. ``gather``: ``t`` is this
    rank's head_dim slice (the ``head_dim`` form's K), the bias its
    slice too; the slices, biased, are all-gathered over ``model`` along
    head_dim before the norm."""
    if f"b{which}" in p:
        t = t + p[f"b{which}"].to(t.dtype)
    if gather:
        t = model_axis().all_gather(t.contiguous(), dim=-1)
    if f"{which}_norm" in p:
        t = rmsnorm(p[f"{which}_norm"], t, cfg.norm_eps)
    return t.contiguous()


def _window_for(cfg: ArchConfig, kind: str) -> Optional[int]:
    if kind == "local":
        return cfg.local_window
    if cfg.sliding_window is not None and kind != "bidir":
        return cfg.sliding_window
    return None


def attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
              kind: str = "global", mode: str = "train",
              cache: Optional[dict] = None, pos=None,
              x_kv: Optional[torch.Tensor] = None,
              use_rope: bool = False, layer_idx: Optional[int] = None,
              kv_lens: Optional[torch.Tensor] = None,
              page_table: Optional[torch.Tensor] = None):
    """Returns (y, new_cache). ``mode``: ``train`` (no cache),
    ``prefill`` (returns this layer's K/V, padded to ``cache``'s length
    when one is given) or ``decode`` (x is (B, Q, d); ``cache`` is a
    stacked pool, ``layer_idx`` its layer, ``pos`` the (B,) positions of
    each lane's first token: the serving pool, or under a meshed decode
    step ``layers.gather_cache_layer``'s one-layer pool of this rank's
    rows, which ``write_cache_layer`` writes back into the shards).
    Cross-attention passes ``x_kv`` (the encoder states in prefill; any
    tensor in decode, where the cached K/V are read). ``page_table``
    (decode): ``cache`` is a paged pool (L, n_pages, P, Hkv, .) and the
    (B, n_lp) table maps each lane's logical pages to its pool pages.
    ``use_rope``: rotate self-attention's q and k at their positions
    (0 .. S - 1 in train/prefill, pos + j in decode)."""
    b, s, _ = x.shape
    causal = kind != "bidir" and x_kv is None
    window = _window_for(cfg, kind)
    softcap = cfg.attn_softcap
    form = attention_form(p)

    if mode in ("train", "prefill"):
        q, k, v = _project_qkv(p, x, cfg, x_kv)
        if use_rope and x_kv is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        q = constrain(q, "batch", "q_seq", "heads", "head_dim")
        k = constrain(k, "batch", "kv_seq", "kv_heads", "head_dim")
        v = constrain(v, "batch", "kv_seq", "kv_heads", "head_dim")
        kq, vq = k, v
        d_split = _cache_splits_head_dim(p)
        if form == "head_dim":
            # K whole, V this rank's head_dim slice: V's slices gathered,
            # the query heads read their KV heads at full head_dim, the
            # cache keeps the slice of each
            lo, hi = _kv_span(q.shape[2], cfg)
            vq = model_axis().all_gather(v, dim=-1)
            kq, vq = k[:, :, lo:hi].contiguous(), vq[:, :, lo:hi].contiguous()
            k = _d_slice(k)
        elif d_split:
            k, v = _d_slice(k), _d_slice(v)
        first = 0
        if form == "param_embed":
            # context parallelism: this rank's block of the positions
            q, first = _query_block(q)
        out = dispatch("flash_attention", q, kq, vq, causal=causal,
                       window=window, softcap=softcap, q_offset=first)
        if form == "param_embed":
            out = _join_blocks(out, s, d_split)
        new_cache = None
        if mode == "prefill":
            new_cache = _write_prefill_cache(cache, k, v)
            if form == "heads" or d_split:
                split = 2 if form == "heads" else 3
                new_cache = {key: model_local(t, split)
                             for key, t in new_cache.items()}
        return constrain(_project_out(p, out), "batch", "q_seq",
                         "embed"), new_cache

    if mode != "decode" or cache is None or layer_idx is None:
        raise ValueError("decode needs the stacked cache and its layer")
    tier = cache_tier(cache)
    if tier != "bf16" and (softcap is not None or window is not None):
        raise NotImplementedError(f"{tier} KV-cache decode supports plain "
                                  f"softmax attention only")
    if page_table is not None and (softcap is not None
                                   or window is not None):
        raise NotImplementedError("paged KV-cache decode supports plain "
                                  "softmax attention only (no softcap / "
                                  "sliding window)")
    if page_table is not None and meshed_rows() is not None:
        raise NotImplementedError("the meshed decode step takes the slot "
                                  "pool's cache; a paged pool is not "
                                  "sharded")
    pos_b = torch.as_tensor(pos, device=x.device).reshape(-1).expand(b)
    posq = pos_b[:, None] + torch.arange(s, device=x.device)[None, :]

    if x_kv is None:   # self-attention: write the new tokens, then read
        q, k_new, v_new = _project_qkv(p, x, cfg)
        if use_rope:
            q = rope(q, posq, cfg.rope_theta)
            k_new = rope(k_new, posq, cfg.rope_theta)
        # token j attends [0, pos + j]; Q == 1 keeps the (B,) form
        read_lens = pos_b + 1 if s == 1 else posq + 1
        new = {"k": k_new, "v": v_new}
        if _cache_splits_head_dim(p):
            if tier != "bf16":
                raise NotImplementedError("a quantized cache on a mesh "
                                          "keeps the attention whole")
            # the head_dim form's v_new is this rank's slice already
            new = {"k": _d_slice(k_new),
                   "v": v_new if form == "head_dim" else _d_slice(v_new)}
        if tier != "bf16":
            qz = quantize_q8_0 if tier == "q8_0" else quantize_q4_0
            kt, vt = qz(k_new, axis=-1), qz(v_new, axis=-1)
            ck, cv = _CODE_KEYS[tier]
            new = {ck: kt.q, "ks": kt.scale, cv: vt.q, "vs": vt.scale}
        if page_table is not None:
            # token j of lane b goes to (layer, table[b, lp], (pos+j) % P),
            # the logical page clipped to the row as the reference clips
            # it: a frozen lane at the end of its extent, or the verify's
            # last positions, write inside the lane's own row
            psz = cache[_CODE_KEYS[tier][0]].shape[2]
            lp = (posq // psz).clamp(max=page_table.shape[1] - 1)
            at = (layer_idx, page_table.gather(1, lp), posq % psz)
        else:
            at = (layer_idx, torch.arange(b, device=x.device)[:, None], posq)
        for key, val in new.items():
            cache[key][at] = val.to(cache[key].dtype)
        if page_table is not None:
            out = _paged_cache_attention(q, cache, layer_idx, page_table,
                                         read_lens)
            return _decoded(_project_out(p, out.to(x.dtype))), cache
        if tier != "bf16":
            return _decoded(_quant_decode(p, x, q, cache, tier, read_lens,
                                          layer_idx)), cache
        kv_len = cache["k"].shape[2]
        kpos = torch.arange(kv_len, device=x.device)
        mask = kpos[None, None, :] <= posq[:, :, None]             # (B,Q,K)
        if window is not None:
            mask &= (posq[:, :, None] - kpos[None, None, :]) < window
    else:              # cross-attention: read the cached encoder K/V
        q = bias_norm(p, row_parallel_mm(model_chunk(x), p["wq"])
                      if form == "param_embed" else mm(x, p["wq"]), cfg, "q")
        if page_table is not None:
            # read-only paged cross block; lane b attends its gathered
            # logical positions [0, kv_lens[b])
            kv_len = page_table.shape[1] * cache[_CODE_KEYS[tier][0]].shape[2]
            lens = (torch.full((b,), kv_len, device=x.device)
                    if kv_lens is None else kv_lens)
            out = _paged_cache_attention(q, cache, layer_idx, page_table,
                                         lens)
            return _decoded(_project_out(p, out.to(x.dtype))), cache
        kv_len = cache[_CODE_KEYS[tier][0]].shape[2]
        lens = (torch.full((b,), kv_len, device=x.device)
                if kv_lens is None else kv_lens)
        if tier != "bf16":
            return _decoded(_quant_decode(p, x, q, cache, tier, lens,
                                          layer_idx)), cache
        mask = (torch.arange(kv_len, device=x.device)[None, :]
                < lens[:, None])[:, None, :]

    # bf16 cache: einsum decode in torch ops (the reference has no Pallas
    # kernel here), the chain the paged op runs after its gather
    q = constrain(q, "batch", None, "heads", "head_dim")
    if form == "head_dim":
        out = _split_d_decode(q, cache["k"][layer_idx],
                              cache["v"][layer_idx], mask, softcap)
    elif _cache_splits_head_dim(p):
        out = _slice_decode(_d_slice(q), cache["k"][layer_idx],
                            cache["v"][layer_idx], mask, softcap,
                            q.shape[-1])
    else:
        out = bf16_decode_attention(q, cache["k"][layer_idx],
                                    cache["v"][layer_idx], mask, softcap)
    return _decoded(_project_out(p, out.to(x.dtype))), cache


def _decoded(y: torch.Tensor) -> torch.Tensor:
    """A decode attention's output, constrained as the reference's."""
    return constrain(y, "batch", None, "embed")


def _project_out(p: dict, out: torch.Tensor) -> torch.Tensor:
    """The output projection of an attention's (..., heads, head_dim)
    output: ``mm_out``, or, where ``wo`` holds this rank's heads or its
    head_dim slice (a split; ``out`` the same rows of it),
    row-parallel: this rank's f32 partial, summed over ``model`` and
    rounded once (``layers.row_parallel_mm``); where ``wo`` holds this
    rank's d_model columns, column-parallel: those columns of every
    row, all-gathered over ``model``."""
    wo = p["wo"]
    dim = model_dim(wo)
    if dim == 2:
        return model_axis().all_gather(mm_out(out, wo), dim=-1)
    if dim is not None:
        return row_parallel_mm(out.flatten(-2), wo.reshape(-1, wo.shape[-1]))
    return mm_out(out, wo)


def _cache_splits_head_dim(p: dict) -> bool:
    """Whether a split attention's cache holds this rank's head_dim
    slice: the ``head_dim`` form, or ``param_embed`` with ``wo`` on
    head_dim (the serve rules place both on ``model`` together)."""
    form = attention_form(p)
    return form == "head_dim" or (form == "param_embed"
                                  and model_dim(p["wo"]) == 1)


def _d_slice(t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the last dim (head_dim) of ``t``."""
    axis = model_axis()
    return t.chunk(axis.size, -1)[axis.rank]


def _query_block(q: torch.Tensor) -> tuple:
    """(this rank's block of q (B, S, H, D) along the sequence, its
    first position): ceil(S / tp) positions at rank * ceil(S / tp), the
    rows past S zero, so every rank's block has one shape."""
    axis = model_axis()
    s = q.shape[1]
    blk = -(-s // axis.size)
    lo = axis.rank * blk
    qb = q[:, lo:lo + blk]
    if qb.shape[1] < blk:
        qb = torch.nn.functional.pad(qb, (0, 0, 0, 0, 0, blk - qb.shape[1]))
    return qb.contiguous(), lo


def _join_blocks(out: torch.Tensor, s: int, d_split: bool) -> torch.Tensor:
    """The blocks' attention outputs (B, ceil(S / tp), H, D), one a
    rank, as ``_project_out`` takes them: with ``wo`` on head_dim one
    all-to-all to this rank's head_dim slice of every position (B, S, H,
    D / tp); with ``wo`` on d_model one all-gather of every position (B,
    S, H, D). The padded rows dropped."""
    axis = model_axis()
    if d_split:
        out = axis.all_to_all(out, split_dim=3, cat_dim=1)
    else:
        out = axis.all_gather(out, dim=1)
    return out[:, :s].contiguous()


def _kv_span(n_local: int, cfg: ArchConfig) -> tuple:
    """[lo, hi): the KV heads this rank's ``n_local`` query heads read
    (GQA: query head j reads KV head j // (heads / kv_heads))."""
    g = cfg.n_heads // cfg.n_kv_heads
    first = model_axis().rank * n_local
    return first // g, (first + n_local - 1) // g + 1


def _slice_decode(q, k, v, mask, softcap, head_dim: int) -> torch.Tensor:
    """Decode attention over this rank's head_dim slice: q (B, Q, H,
    D/tp) against the cache's k, v (B, S, Hkv, D/tp), the scores summed
    over ``model`` in f32 (scaled by the whole ``head_dim``), the
    softcap, mask and softmax whole, P.V on the slice. Returns f32 (B,
    Q, H, D/tp)."""
    widen = not q.is_cuda    # bf16_decode_attention's choice
    # the scores go in unnamed, so grouped_values frees them as it goes
    return grouped_values(
        model_axis().all_reduce(grouped_scores(q, k, widen))
        * head_dim ** -0.5, v, mask, softcap, q.shape, widen)


def _split_d_decode(q, k, v, mask, softcap) -> torch.Tensor:
    """Decode attention of this rank's query heads q (B, Q, H/tp, D) over
    a cache split along head_dim (k, v (B, S, Hkv, D/tp)): the query of
    every head gathered over ``model``, ``_slice_decode`` of its head_dim
    slice, and one all-to-all from the slice of every head to the whole
    head_dim of this rank's heads. Returns f32 (B, Q, H/tp, D)."""
    axis = model_axis()
    out = _slice_decode(_d_slice(axis.all_gather(q, dim=2)), k, v, mask,
                        softcap, q.shape[-1])
    return axis.all_to_all(out, split_dim=2, cat_dim=3)


#: the code-plane keys (K, V) of each cache tier
_CODE_KEYS = {"bf16": ("k", "v"), "q8_0": ("kq", "vq"),
              "q4_0": ("kp", "vp")}


def _quant_decode(p: dict, x: torch.Tensor, q: torch.Tensor, cache: dict,
                  tier: str, lens, layer_idx: int) -> torch.Tensor:
    """Attention of q (B, Q, H, D) over one layer of a q8_0 / q4_0
    stacked cache, through the tier's decode-attention kernel, and the
    output projection."""
    ck, cv = _CODE_KEYS[tier]
    op = "q8_decode_attention" if tier == "q8_0" else "q4_decode_attention"
    out = dispatch(op, q, cache[ck], cache["ks"], cache[cv], cache["vs"],
                   lens, layer=layer_idx)
    return _project_out(p, out.to(x.dtype))


def _paged_cache_attention(q: torch.Tensor, planes: dict, layer_idx: int,
                           table: torch.Tensor, lens) -> torch.Tensor:
    """Attention of q (B, Q, H, D) over one layer of a paged pool (planes
    (L, n_pages, P, Hkv, .)) through ``dispatch("paged_decode_attention")``:
    lane b attends its gathered logical positions [0, lens[b]) (lens (B,)
    or (B, Q))."""
    tier = cache_tier(planes)
    if tier == "bf16":
        kc, vc = planes["k"][layer_idx], planes["v"][layer_idx]
    else:
        ck, cv = _CODE_KEYS[tier]
        c = "q" if tier == "q8_0" else "p"
        kc = {c: planes[ck][layer_idx], "s": planes["ks"][layer_idx]}
        vc = {c: planes[cv][layer_idx], "s": planes["vs"][layer_idx]}
    return dispatch("paged_decode_attention", q, kc, vc, table, lens)


def _write_prefill_cache(cache: Optional[dict], k: torch.Tensor,
                         v: torch.Tensor) -> dict:
    """Prefill K/V, zero-padded up to the cache length when a cache was
    allocated."""
    if cache is None:
        return {"k": k, "v": v}
    kv_len = cache["k"].shape[1]
    s = k.shape[1]
    if s < kv_len:
        pad = (0, 0, 0, 0, 0, kv_len - s)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """KV-cache planes (batch, max_len, Hkv, Dh): a tensor dtype, or a
    tier string: ``"q8_0"`` (int8 planes + f16 scales blocked along
    head_dim) or ``"q4_0"`` (nibble-packed uint8 planes, head_dim halved,
    + f16 scales)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if isinstance(dtype, str):
        if dtype not in ("q8_0", "q4_0"):
            raise ValueError(f"unknown KV-cache tier {dtype!r}")
        if cfg.head_dim % QBLOCK:
            raise ValueError(f"{dtype} KV cache needs head_dim % {QBLOCK} "
                             f"== 0, got {cfg.head_dim}")
        sshape = shape[:-1] + (cfg.head_dim // QBLOCK,)
        if dtype == "q8_0":
            cshape, cdt = shape, torch.int8
        else:
            cshape, cdt = shape[:-1] + (cfg.head_dim // 2,), torch.uint8
        ck, cv = _CODE_KEYS[dtype]
        return {ck: torch.zeros(cshape, dtype=cdt, device=device),
                "ks": torch.zeros(sshape, dtype=torch.float16, device=device),
                cv: torch.zeros(cshape, dtype=cdt, device=device),
                "vs": torch.zeros(sshape, dtype=torch.float16, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: ArchConfig, n_pages: int, page_size: int,
                        dtype=torch.bfloat16, device=None) -> dict:
    """Page-pool KV planes (n_pages, P, Hkv, .): ``init_kv_cache``'s
    plane dict with (batch, max_len) replaced by the pool's (n_pages,
    page_size). Page 0 is the reserved scratch page."""
    return init_kv_cache(cfg, n_pages, page_size, dtype, device)


def is_q8_cache(cache) -> bool:
    return isinstance(cache, dict) and "kq" in cache


def is_q4_cache(cache) -> bool:
    return isinstance(cache, dict) and "kp" in cache


def cache_tier(cache) -> str:
    """``"q8_0"``, ``"q4_0"`` or ``"bf16"`` (float planes)."""
    if is_q8_cache(cache):
        return "q8_0"
    return "q4_0" if is_q4_cache(cache) else "bf16"


def quantize_kv_cache(tree, tier: str = "q8_0"):
    """bf16 KV-cache tree -> quantized plane tree: every ``{"k", "v"}``
    dict becomes ``{"kq", "ks", "vq", "vs"}`` (``tier="q8_0"``) or
    ``{"kp", "ks", "vp", "vs"}`` (``"q4_0"``), blocked along head_dim."""
    if tier not in ("q8_0", "q4_0"):
        raise ValueError(f"unknown KV-cache tier {tier!r}")
    if isinstance(tree, dict):
        if set(tree) == {"k", "v"}:
            qz = quantize_q8_0 if tier == "q8_0" else quantize_q4_0
            kt, vt = qz(tree["k"], axis=-1), qz(tree["v"], axis=-1)
            ck, cv = _CODE_KEYS[tier]
            return {ck: kt.q, "ks": kt.scale, cv: vt.q, "vs": vt.scale}
        return {key: quantize_kv_cache(sub, tier)
                for key, sub in tree.items()}
    return tree
