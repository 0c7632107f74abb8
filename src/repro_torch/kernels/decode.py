"""What the two quantized decode-attention wrappers share.

``q8_decode_attention`` (``csrc/q8_attention.cu``) and
``q4_decode_attention`` (``csrc/q4_attention.cu``) have one C interface:
the query, the K/V code planes and their scale planes, each given by a
base pointer and (lane, position or query, head) strides in elements, a
(B, Q) int32 table of per-query lengths, and the output. Q is 1 in plain
decode and ``spec_k`` in the speculative verify, where token j of a lane
attends [0, pos + j]. Both are one templated kernel body
(``csrc/decode_attention.cuh``) over their code formats: the cache
positions are split into chunks (``chunk_plan``), one CTA per (lane, KV
head, group of up to ROWS_MAX query rows, chunk) reads each of its rows
once for all of those queries and keeps an online softmax; with several
chunks, each writes an (m, l, o) partial to a workspace that a second
kernel merges in chunk order. A CTA's shared memory does not grow with
S, so S has no cap but the int positions.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LL = ctypes.c_longlong
_P = ctypes.c_void_p
ARGTYPES = ([_P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _P, _LL, _LL,
             _LL, _P, _P, _LL, _LL, _LL, _P] + [ctypes.c_int] * 8 + [_P])

#: head dims a CTA takes, at most (csrc/decode_attention.cuh)
D_MAX = 128

#: cache positions a CTA reads, at least and at most, and the multiple a
#: chunk is of
CHUNK_MIN = 64
CHUNK_MAX = 512
CHUNK_ALIGN = 32
#: query rows (queries x the heads of one KV head) a CTA holds
ROWS_MAX = 4


def chunk_plan(b: int, hkv: int, rows: int, s_len: int,
               sms: int) -> tuple[int, int]:
    """(positions a chunk, chunks) of a launch over ``b`` lanes, ``hkv``
    KV heads and ``rows`` query rows a KV head (Q x H / Hkv), for a
    cache of ``s_len`` positions on ``sms`` SMs: as many chunks as make
    the (lane, KV head, row group) CTAs reach the SMs, each a multiple
    of CHUNK_ALIGN positions, at least CHUNK_MIN and at most CHUNK_MAX
    (a long cache runs as more CTAs than SMs, not as longer ones)."""
    ctas = b * hkv * build.cdiv(rows, ROWS_MAX)
    want = build.cdiv(sms, max(1, ctas))
    chunk = s_len // want // CHUNK_ALIGN * CHUNK_ALIGN
    chunk = min(CHUNK_MAX, max(CHUNK_MIN, chunk))
    return chunk, max(1, build.cdiv(s_len, chunk))


def lens_table(length, b: int, nq: int, device, name: str) -> torch.Tensor:
    """A length of shape (), (1,), (B,) or (B, Q) as the (B, Q) int32
    table the kernels read: a (B,) length applies to every query of its
    lane (cross-attention, plain decode)."""
    lens = torch.as_tensor(length, device=device)
    if lens.dim() == 2:
        if tuple(lens.shape) != (b, nq):
            raise ValueError(f"{name}: length of shape {tuple(lens.shape)} "
                             f"for {b} lanes of {nq} queries")
        return lens.to(torch.int32).contiguous()
    if lens.dim() > 1 or (lens.dim() == 1 and lens.shape[0] not in (1, b)):
        raise ValueError(f"{name}: length of shape {tuple(lens.shape)} "
                         f"for {b} lanes")
    return lens.to(torch.int32).reshape(-1, 1).expand(b, nq).contiguous()


_entries: dict = {}   # each C entry point, typed once


def _entry(lib_name: str, fn_name: str):
    fn = _entries.get(fn_name)
    if fn is None:
        fn = getattr(build.load(lib_name), fn_name)
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entries[fn_name] = fn
    return fn


def launch(lib_name: str, fn_name: str, q, q_strides, kp, vp, kv_strides,
           ks, vs, sc_strides, lens, out, o_strides, b: int, nq: int,
           h: int, hkv: int, s_len: int, d: int) -> None:
    """Launch ``fn_name`` of library ``lib_name`` over lanes ``b``,
    queries ``nq``, heads ``h`` and KV heads ``hkv``, the positions split
    as ``chunk_plan`` says; strides in elements of each plane."""
    if kp.data_ptr() % 16 or vp.data_ptr() % 16 \
            or any(st % 16 for st in kv_strides):
        raise ValueError(f"{fn_name}: code rows must be 16-byte aligned")
    chunk, nch = chunk_plan(b, hkv, nq * (h // hkv), s_len,
                            build.sm_count(q.device))
    part = None
    if nch > 1:
        part = torch.empty(b * nq * h * nch * (d + 2), dtype=torch.float32,
                           device=q.device)
    rc = _entry(lib_name, fn_name)(
        q.data_ptr(), *q_strides, kp.data_ptr(), vp.data_ptr(),
        *kv_strides, ks.data_ptr(), vs.data_ptr(), *sc_strides,
        lens.data_ptr(), out.data_ptr(), *o_strides,
        None if part is None else part.data_ptr(), b, nq, h, hkv, s_len, d,
        chunk, nch, build.stream(q.device))
    build.check(rc, lib_name)
