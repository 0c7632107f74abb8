"""Plain PyTorch version of decode attention over a Q8_0 KV cache: the
HOST backend and the oracle the CUDA kernel is held against."""

from __future__ import annotations

import torch

from repro_torch.quantize import QBLOCK


def dequant(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """codes: (..., S, D) int8; scale: (..., S, D // 32) -> f32."""
    return codes.to(torch.float32) * scale.to(torch.float32) \
        .repeat_interleave(QBLOCK, dim=-1)


def q8_decode_attention(q, kq, ks, vq, vs, length) -> torch.Tensor:
    """q: (BH, Q, D); int8 code planes (BH, S, D) with f16 scales
    (BH, S, D // 32); lane i attends positions [0, length[i]) (``length``
    a scalar or (BH,)). A lane of length 0 attends nothing and returns 0.
    Returns q's dtype."""
    bh, _, d = q.shape
    s_len = kq.shape[1]
    k = dequant(kq, ks)
    v = dequant(vq, vs)
    lens = torch.as_tensor(length, dtype=torch.int64,
                           device=q.device).reshape(-1).expand(bh)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k) * (d ** -0.5)
    mask = torch.arange(s_len, device=q.device)[None, None, :] \
        < lens[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", w, v)
    out = torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def q8_decode_attention_cache(q, kq, ks, vq, vs, lens, layer: int):
    """The same function over one layer of the serving engine's stacked
    cache: q (B, Q, H, D); planes (L, B, S, Hkv, .); lens (B,). Flattens
    to the (B*H, S, .) form above, as the reference's
    ``_quant_cache_attention`` does. Returns (B, Q, H, D)."""
    b, nq, h, d = q.shape

    def flat(c):
        lay = c[layer].repeat_interleave(h // c.shape[3], dim=2)
        return lay.permute(0, 2, 1, 3).reshape(b * h, lay.shape[1], -1)

    qf = q.permute(0, 2, 1, 3).reshape(b * h, nq, d)
    lens_f = torch.as_tensor(lens, device=q.device).repeat_interleave(h)
    out = q8_decode_attention(qf, flat(kq), flat(ks), flat(vq), flat(vs),
                              lens_f)
    return out.reshape(b, h, nq, d).permute(0, 2, 1, 3)
