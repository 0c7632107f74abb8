"""Plain PyTorch version of decode attention over a paged KV pool: the
HOST backend of ``paged_decode_attention`` (the reference's
``kernels/paged_attention/xla.py``).

The cache planes of one layer live in a shared page pool
``(n_pages, P, Hkv, .)``; lane b's logical sequence is gathered through
its page-table row, ``table[b]`` listing physical pages in logical
order, so the gathered ``(B, n_lp * P, Hkv, .)`` planes have exactly the
layout of a slot-pool lane's row. After the gather a quantized tier runs
the plain version of its decode attention, and the bf16 tier runs
``bf16_decode_attention``, the chain the slot pool's bf16 decode runs
too. A paged lane is then bit-equal to its slot-pool twin whenever the
gathered values match and ``n_lp * P`` is the slot pool's length.

``kc`` / ``vc`` are a bf16 plane, ``{"q": int8, "s": f16}`` (q8_0) or
``{"p": uint8, "s": f16}`` (q4_0, nibble-packed along head_dim).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode
from repro_torch.kernels.q4_attention import plain as q4_plain
from repro_torch.kernels.q8_attention import plain as q8_plain

NEG_INF = -1e30

_NAME = "paged_decode_attention"


def gather_pages(plane: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """plane (n_pages, P, Hkv, .) + table (B, n_lp) ->
    (B, n_lp * P, Hkv, .) per-lane logical planes."""
    b, n_lp = table.shape
    g = plane.index_select(0, table.reshape(-1))
    return g.reshape(b, n_lp * plane.shape[1], *plane.shape[2:])


def bf16_decode_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, mask: torch.Tensor,
                          softcap=None) -> torch.Tensor:
    """Decode attention of q (B, Q, H, D) over float K/V rows
    (B, S, Hkv, D), query (b, j) attending where ``mask`` (B, Q|1, S)
    holds: bf16 operands, f32 accumulation, a -1e30 mask, as the
    reference's inline einsum. Returns f32 (B, Q, H, D)."""
    h, d = q.shape[2], q.shape[3]
    k = k.repeat_interleave(h // k.shape[2], dim=2)
    v = v.repeat_interleave(h // v.shape[2], dim=2)
    bf = torch.bfloat16
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(bf).float(),
                     k.to(bf).float()) * d ** -0.5
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(bf).float(),
                        v.to(bf).float())


def code_key(kc) -> str:
    """The code plane's key of a quantized plane dict."""
    return "p" if "p" in kc else "q"


def paged(q, kc, vc, table, lens, q8_fn, q4_fn) -> torch.Tensor:
    """The gather, then the tier's decode attention: ``q8_fn`` /
    ``q4_fn`` take the stacked-cache form (q, codes, scales, codes,
    scales, lens, layer) of one-layer (1, B, S, Hkv, .) planes. q
    (B, Q, H, D); lens (B,) or (B, Q). Returns (B, Q, H, D) in q's
    dtype."""
    b, nq = q.shape[:2]
    if not isinstance(kc, dict):
        k, v = gather_pages(kc, table), gather_pages(vc, table)
        lens = decode.lens_table(lens, b, nq, q.device, _NAME)
        mask = torch.arange(k.shape[1], device=q.device)[None, None, :] \
            < lens[:, :, None]
        return bf16_decode_attention(q, k, v, mask).to(q.dtype)
    ck = code_key(kc)
    fn = q4_fn if ck == "p" else q8_fn
    planes = [gather_pages(p, table)[None]
              for p in (kc[ck], kc["s"], vc[ck], vc["s"])]
    return fn(q, *planes, lens, 0)


def paged_decode_attention(q, kc, vc, table, lens) -> torch.Tensor:
    """q: (B, Q, H, D); kc/vc: one layer's pool planes (n_pages, P,
    Hkv, .), a tensor or a quantized plane dict; table: (B, n_lp); lens:
    (B,) or (B, Q) attend depths. Returns (B, Q, H, D) in q's dtype."""
    return paged(q, kc, vc, table, lens, q8_plain.q8_decode_attention_cache,
                 q4_plain.q4_decode_attention_cache)
