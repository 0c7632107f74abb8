"""Plain PyTorch version of decode attention over a Q8_0 KV cache: the
HOST backend and the oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch

from repro_torch.quantize import QBLOCK


def dequant(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """codes: (..., S, D) int8; scale: (..., S, D // 32) -> f32."""
    return codes.to(torch.float32) * scale.to(torch.float32) \
        .repeat_interleave(QBLOCK, dim=-1)


def lens_mask(length, bh: int, s_len: int, device) -> tuple:
    """A length of shape (), (BH,) or (BH, Q) as (the (BH, Q|1) lengths,
    the (BH, Q|1, S) attend mask), as the reference's ``lens_mask``."""
    lens = torch.as_tensor(length, dtype=torch.int64, device=device)
    if lens.dim() <= 1:
        lens = lens.reshape(-1).expand(bh)[:, None]
    mask = torch.arange(s_len, device=device)[None, None, :] \
        < lens[:, :, None]
    return lens, mask


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length) -> torch.Tensor:
    """Softmax attention of q (BH, Q, D) over f32 k, v (BH, S, D), query
    (i, j) over positions [0, length); a query of length 0 attends
    nothing and returns 0. Returns q's dtype."""
    bh, _, d = q.shape
    lens, mask = lens_mask(length, bh, k.shape[1], q.device)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k) * (d ** -0.5)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", w, v)
    out = torch.where((lens > 0)[:, :, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def q8_decode_attention(q, kq, ks, vq, vs, length) -> torch.Tensor:
    """q: (BH, Q, D); int8 code planes (BH, S, D) with f16 scales
    (BH, S, D // 32); query (i, j) attends positions [0, length) with
    ``length`` a scalar, (BH,) or (BH, Q)."""
    return attend(q, dequant(kq, ks), dequant(vq, vs), length)


def flat_layer(c: torch.Tensor, layer: int, h: int) -> torch.Tensor:
    """Layer ``layer`` of a stacked (L, B, S, Hkv, .) plane as the
    (B*H, S, .) form, KV heads repeated for the H query heads."""
    lay = c[layer].repeat_interleave(h // c.shape[3], dim=2)
    return lay.permute(0, 2, 1, 3).reshape(-1, lay.shape[1], lay.shape[3])


def flat_cache_call(fn, q, kq, ks, vq, vs, lens, layer: int):
    """Run the flat (B*H, Q, D) form ``fn`` over one layer of the stacked
    cache, as the reference's ``_quant_cache_attention`` does: q
    (B, Q, H, D), lens (B,) or (B, Q). Returns (B, Q, H, D)."""
    b, nq, h, d = q.shape
    qf = q.permute(0, 2, 1, 3).reshape(b * h, nq, d)
    lens_f = torch.as_tensor(lens, device=q.device).repeat_interleave(
        h, dim=0)
    out = fn(qf, flat_layer(kq, layer, h), flat_layer(ks, layer, h),
             flat_layer(vq, layer, h), flat_layer(vs, layer, h), lens_f)
    return out.reshape(b, h, nq, d).permute(0, 2, 1, 3)


def q8_decode_attention_cache(q, kq, ks, vq, vs, lens, layer: int):
    """The same function over one layer of the serving engine's stacked
    cache: q (B, Q, H, D); planes (L, B, S, Hkv, .); lens (B,) or (B, Q).
    Returns (B, Q, H, D)."""
    return flat_cache_call(q8_decode_attention, q, kq, ks, vq, vs, lens,
                           layer)
