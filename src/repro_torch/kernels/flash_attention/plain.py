"""Plain PyTorch version of flash attention (dense softmax, the same
masks): the HOST backend and the oracle the CUDA kernel is held
against."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, Hkv, D) with H % Hkv == 0 (GQA:
    query head h reads KV head h // (H // Hkv)). Query i sits at
    position q_offset + i and key j at position j, so the causal mask is
    j <= q_offset + i for any Sq, Skv. Computed in f32; returns q's
    dtype."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * (d ** -0.5)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(q_offset, q_offset + sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l, v.to(torch.float32))
    return out.to(q.dtype)
