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
from repro_torch.kernels.paged_attention.plain import bf16_decode_attention
from repro_torch.models.layers import (mm, mm_out, ninit, prepared,
                                       rmsnorm, rope)
from repro_torch.quantize import QBLOCK, quantize_q4_0, quantize_q8_0


def init_attention(gen: torch.Generator, cfg: ArchConfig, device,
                   dtype=torch.float32) -> dict:
    """Projections in ``dtype``; the biases (zeros) and the qk-norm
    weights (ones) in f32, as the reference keeps them."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ninit(gen, (d, h, dh), d, device, dtype),
        "wk": ninit(gen, (d, hk, dh), d, device, dtype),
        "wv": ninit(gen, (d, hk, dh), d, device, dtype),
        "wo": ninit(gen, (h, dh, d), h * dh, device, dtype),
    }
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.attn_bias:
        p["bq"] = torch.zeros((h, dh), **f32)
        p["bk"] = torch.zeros((hk, dh), **f32)
        p["bv"] = torch.zeros((hk, dh), **f32)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), **f32)
        p["k_norm"] = torch.ones((dh,), **f32)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 x_kv: Optional[torch.Tensor] = None):
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    if x_kv is None and isinstance(wq, torch.Tensor):
        # self-attention with plain weights: one QKV product over the
        # head-concatenated weight (the same per-element contraction)
        h, hk = cfg.n_heads, cfg.n_kv_heads
        wqkv = prepared(p, "wqkv", lambda: torch.cat([wq, wk, wv], dim=1))
        y = mm(x, wqkv)
        q, k, v = y[..., :h, :], y[..., h:h + hk, :], y[..., h + hk:, :]
    else:
        x_kv = x if x_kv is None else x_kv
        q, k, v = mm(x, wq), mm(x_kv, wk), mm(x_kv, wv)
    return bias_norm(p, q, cfg, "q"), bias_norm(p, k, cfg, "k"), \
        bias_norm(p, v, cfg, "v")


def bias_norm(p: dict, t: torch.Tensor, cfg: ArchConfig,
              which: str) -> torch.Tensor:
    """The projection ``which`` ("q", "k", "v") with its bias added in
    its own dtype and, for q and k, the qk-norm, as the reference's
    ``_project_qkv`` does after the product."""
    if f"b{which}" in p:
        t = t + p[f"b{which}"].to(t.dtype)
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
    when one is given) or ``decode`` (x is (B, Q, d); ``cache`` is the
    stacked pool, ``layer_idx`` its layer, ``pos`` the (B,) positions of
    each lane's first token).
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

    if mode in ("train", "prefill"):
        q, k, v = _project_qkv(p, x, cfg, x_kv)
        if use_rope and x_kv is None:
            positions = torch.arange(s, device=x.device).expand(b, s)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        out = dispatch("flash_attention", q, k, v, causal=causal,
                       window=window, softcap=softcap)
        new_cache = _write_prefill_cache(cache, k, v) \
            if mode == "prefill" else None
        return mm_out(out, p["wo"]), new_cache

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
            return mm_out(out.to(x.dtype), p["wo"]), cache
        if tier != "bf16":
            return _quant_decode(p, x, q, cache, tier, read_lens,
                                 layer_idx), cache
        kv_len = cache["k"].shape[2]
        kpos = torch.arange(kv_len, device=x.device)
        mask = kpos[None, None, :] <= posq[:, :, None]             # (B,Q,K)
        if window is not None:
            mask &= (posq[:, :, None] - kpos[None, None, :]) < window
    else:              # cross-attention: read the cached encoder K/V
        q = bias_norm(p, mm(x, p["wq"]), cfg, "q")
        if page_table is not None:
            # read-only paged cross block; lane b attends its gathered
            # logical positions [0, kv_lens[b])
            kv_len = page_table.shape[1] * cache[_CODE_KEYS[tier][0]].shape[2]
            lens = (torch.full((b,), kv_len, device=x.device)
                    if kv_lens is None else kv_lens)
            out = _paged_cache_attention(q, cache, layer_idx, page_table,
                                         lens)
            return mm_out(out.to(x.dtype), p["wo"]), cache
        kv_len = cache[_CODE_KEYS[tier][0]].shape[2]
        lens = (torch.full((b,), kv_len, device=x.device)
                if kv_lens is None else kv_lens)
        if tier != "bf16":
            return _quant_decode(p, x, q, cache, tier, lens,
                                 layer_idx), cache
        mask = (torch.arange(kv_len, device=x.device)[None, :]
                < lens[:, None])[:, None, :]

    # bf16 cache: einsum decode in torch ops (the reference has no Pallas
    # kernel here), the chain the paged op runs after its gather
    out = bf16_decode_attention(q, cache["k"][layer_idx],
                                cache["v"][layer_idx], mask, softcap)
    return mm_out(out.to(x.dtype), p["wo"]), cache


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
    return mm_out(out.to(x.dtype), p["wo"])


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
