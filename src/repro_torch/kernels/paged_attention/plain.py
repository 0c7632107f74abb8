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
    reference's inline einsum. Returns f32 (B, Q, H, D). CUDA tensors
    take ``attend_bf16_planes``, which makes no f32 copy of a K/V plane;
    the CPU has no kernel for its bf16 x bf16 -> f32 product
    (``aten::bmm.dtype``), so CPU tensors take ``attend_widened``. Their
    products differ only in f32 summation order (a bf16 x bf16 product
    is exact in f32), and through it, where a probability lies at a
    bf16 rounding boundary, in that probability's rounding."""
    if q.is_cuda:
        return attend_bf16_planes(q, k, v, mask, softcap)
    return attend_widened(q, k, v, mask, softcap)


def attend_bf16_planes(q, k, v, mask, softcap=None) -> torch.Tensor:
    """``bf16_decode_attention`` on bf16 planes, as the reference streams
    them: the query heads of each KV head grouped into the rows of one
    product (GQA by index, no repeat of K/V), each product taking bf16
    operands into an f32 result (``torch.bmm(..., out_dtype=f32)``)."""
    b, nq, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bf, f32 = torch.bfloat16, torch.float32
    # query head hk * g + i reads KV head hk (repeat_interleave's order)
    qg = q.to(bf).reshape(b, nq, hkv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * hkv, g * nq, d)
    kt = k.to(bf).permute(0, 2, 3, 1).reshape(b * hkv, d, s)
    vg = v.to(bf).permute(0, 2, 1, 3).reshape(b * hkv, s, d)
    sc = (torch.bmm(qg, kt, out_dtype=f32) * d ** -0.5) \
        .view(b, hkv, g, nq, s)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, NEG_INF))
    w = torch.softmax(sc, dim=-1).to(bf).view(b * hkv, g * nq, s)
    out = torch.bmm(w, vg, out_dtype=f32)
    return out.view(b, hkv, g, nq, d).permute(0, 3, 1, 2, 4) \
        .reshape(b, nq, h, d)


def attend_widened(q, k, v, mask, softcap=None) -> torch.Tensor:
    """``bf16_decode_attention`` with K/V repeated to every query head
    and the bf16-rounded operands widened to f32 before the products."""
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
    from repro_torch.kernels.api import kernel_call
    ck = code_key(kc)
    planes = [gather_pages(p, table)[None]
              for p in (kc[ck], kc["s"], vc[ck], vc["s"])]
    if ck == "p":
        return kernel_call("q4_decode_attention", q4_fn, q, *planes, lens, 0)
    return kernel_call("q8_decode_attention", q8_fn, q, *planes, lens, 0)


def paged_decode_attention(q, kc, vc, table, lens) -> torch.Tensor:
    """q: (B, Q, H, D); kc/vc: one layer's pool planes (n_pages, P,
    Hkv, .), a tensor or a quantized plane dict; table: (B, n_lp); lens:
    (B,) or (B, Q) attend depths. Returns (B, Q, H, D) in q's dtype."""
    return paged(q, kc, vc, table, lens, q8_plain.q8_decode_attention_cache,
                 q4_plain.q4_decode_attention_cache)
