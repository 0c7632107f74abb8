"""Attention block of the port, for the Whisper paths (the JAX package's
``models/attention.py``).

Train/prefill project Q/K/V and run ``dispatch("flash_attention")``: the
encoder's bidirectional self-attention, the decoder's causal prefill and
the cross-attention prefill (Sq != Skv), all on the one kernel. Decode
takes the serving engine's stacked cache, ``{"k", "v"}`` (bf16),
``{"kq", "ks", "vq", "vs"}`` (q8_0) or ``{"kp", "ks", "vp", "vs"}``
(q4_0, nibble-packed along head_dim) planes of shape (L, B, S, Hkv, .),
and a per-lane position vector. x carries Q tokens a lane: Q = 1 in
plain decode, ``spec_k`` in the speculative verify, where token j sits
at pos + j and attends [0, pos + j]:

* self-attention writes the Q new tokens of every lane at (layer, b,
  pos[b] + j) **in place** (``index_put_``; the reference's functional
  update returns a new buffer under donation), then reads the layer —
  bf16 through einsum decode in torch ops with a (B, Q, K) mask, q8_0
  and q4_0 through ``dispatch("q8_decode_attention")`` /
  ``dispatch("q4_decode_attention")``, which read the stacked planes
  where they lie, with (B,) lengths for Q = 1 and (B, Q) for Q > 1;
* cross-attention reads the cached encoder K/V, every query of lane b
  attending positions [0, kv_lens[b]).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.api import dispatch
from repro_torch.models.layers import mm, mm_out, ninit, prepared
from repro_torch.quantize import QBLOCK, quantize_q4_0, quantize_q8_0

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.attn_bias or cfg.qk_norm:
        raise NotImplementedError(
            "attention biases and qk-norm belong to the decoder-only "
            "families (ROADMAP queue 1, item 14)")
    return {
        "wq": ninit(gen, (d, h, dh), d, device),
        "wk": ninit(gen, (d, hk, dh), d, device),
        "wv": ninit(gen, (d, hk, dh), d, device),
        "wo": ninit(gen, (h, dh, d), h * dh, device),
    }


def _project_qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 x_kv: Optional[torch.Tensor] = None):
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    if x_kv is None and isinstance(wq, torch.Tensor):
        # self-attention with plain weights: one QKV product over the
        # head-concatenated weight (the same per-element contraction)
        h, hk = cfg.n_heads, cfg.n_kv_heads
        wqkv = prepared(p, "wqkv", lambda: torch.cat([wq, wk, wv], dim=1))
        y = mm(x, wqkv)
        return (y[..., :h, :].contiguous(), y[..., h:h + hk, :].contiguous(),
                y[..., h + hk:, :].contiguous())
    x_kv = x if x_kv is None else x_kv
    return mm(x, wq), mm(x_kv, wk), mm(x_kv, wv)


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
              kv_lens: Optional[torch.Tensor] = None):
    """Returns (y, new_cache). ``mode``: ``train`` (no cache),
    ``prefill`` (returns this layer's K/V, padded to ``cache``'s length
    when one is given) or ``decode`` (x is (B, Q, d); ``cache`` is the
    stacked pool, ``layer_idx`` its layer, ``pos`` the (B,) positions of
    each lane's first token).
    Cross-attention passes ``x_kv`` (the encoder states in prefill; any
    tensor in decode, where the cached K/V are read)."""
    if use_rope:
        raise NotImplementedError(
            "rotary positions belong to the decoder-only families "
            "(ROADMAP queue 1, item 14)")
    b, s, _ = x.shape
    h = cfg.n_heads
    causal = kind != "bidir" and x_kv is None
    window = _window_for(cfg, kind)
    softcap = cfg.attn_softcap

    if mode in ("train", "prefill"):
        q, k, v = _project_qkv(p, x, cfg, x_kv)
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
    pos_b = torch.as_tensor(pos, device=x.device).reshape(-1).expand(b)
    posq = pos_b[:, None] + torch.arange(s, device=x.device)[None, :]
    lanes = torch.arange(b, device=x.device)[:, None]

    if x_kv is None:   # self-attention: write the new tokens, then read
        q, k_new, v_new = _project_qkv(p, x, cfg)
        # token j attends [0, pos + j]; Q == 1 keeps the (B,) form
        read_lens = pos_b + 1 if s == 1 else posq + 1
        if tier != "bf16":
            qz = quantize_q8_0 if tier == "q8_0" else quantize_q4_0
            kt, vt = qz(k_new, axis=-1), qz(v_new, axis=-1)
            ck, cv = _CODE_KEYS[tier]
            for key, val in ((ck, kt.q), ("ks", kt.scale),
                             (cv, vt.q), ("vs", vt.scale)):
                cache[key][layer_idx, lanes, posq] = val
            return _quant_decode(p, x, q, cache, tier, read_lens,
                                 layer_idx), cache
        cache["k"][layer_idx, lanes, posq] = k_new.to(cache["k"].dtype)
        cache["v"][layer_idx, lanes, posq] = v_new.to(cache["v"].dtype)
        kv_len = cache["k"].shape[2]
        kpos = torch.arange(kv_len, device=x.device)
        mask = kpos[None, None, :] <= posq[:, :, None]             # (B,Q,K)
        if window is not None:
            mask &= (posq[:, :, None] - kpos[None, None, :]) < window
    else:              # cross-attention: read the cached encoder K/V
        q = mm(x, p["wq"])
        kv_len = cache[_CODE_KEYS[tier][0]].shape[2]
        lens = (torch.full((b,), kv_len, device=x.device)
                if kv_lens is None else kv_lens)
        if tier != "bf16":
            return _quant_decode(p, x, q, cache, tier, lens,
                                 layer_idx), cache
        mask = (torch.arange(kv_len, device=x.device)[None, :]
                < lens[:, None])[:, None, :]

    # bf16 cache: einsum decode in torch ops (the reference has no Pallas
    # kernel here): bf16 operands, f32 accumulation
    k_layer = cache["k"][layer_idx].repeat_interleave(
        h // cfg.n_kv_heads, dim=2)
    v_layer = cache["v"][layer_idx].repeat_interleave(
        h // cfg.n_kv_heads, dim=2)
    bf = torch.bfloat16
    scale = cfg.head_dim ** -0.5
    s_ = torch.einsum("bqhd,bkhd->bhqk", q.to(bf).float(),
                      k_layer.to(bf).float()) * scale
    if softcap is not None:
        s_ = softcap * torch.tanh(s_ / softcap)
    s_ = torch.where(mask[:, None], s_, torch.full_like(s_, NEG_INF))
    w = torch.softmax(s_, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(bf).float(),
                       v_layer.to(bf).float())
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
