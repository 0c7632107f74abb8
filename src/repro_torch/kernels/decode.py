"""What the two quantized decode-attention wrappers share.

``q8_decode_attention`` (``csrc/q8_attention.cu``) and
``q4_decode_attention`` (``csrc/q4_attention.cu``) have one C interface:
the query, the K/V code planes and their scale planes, each given by a
base pointer and (lane, position or query, head) strides in elements, a
(B, Q) int32 table of per-query lengths, and the output. Q is 1 in plain
decode and ``spec_k`` in the speculative verify, where token j of a lane
attends [0, pos + j]. Both are one templated kernel body
(``csrc/decode_attention.cuh``) over their code formats: one block runs
per (lane, query, head) and holds that query's S scores in shared
memory for a two-pass softmax, which bounds S (``launch`` checks it).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_LL = ctypes.c_longlong
_P = ctypes.c_void_p
ARGTYPES = ([_P, _LL, _LL, _LL, _P, _P, _LL, _LL, _LL, _P, _P, _LL, _LL,
             _LL, _P, _P, _LL, _LL, _LL] + [ctypes.c_int] * 6 + [_P])

#: bytes of shared memory one block may use on Hopper
SMEM_LIMIT = 232_448
NT = 128  # threads of a block (csrc/q*_attention.cu)


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


def launch(lib_name: str, fn_name: str, q, q_strides, kp, vp, kv_strides,
           ks, vs, sc_strides, lens, out, o_strides, b: int, nq: int,
           h: int, hkv: int, s_len: int, d: int) -> None:
    """Launch ``fn_name`` of library ``lib_name`` over lanes ``b``,
    queries ``nq`` and heads ``h``; strides in elements of each plane."""
    if (d + s_len + 4 + NT) * 4 > SMEM_LIMIT:
        raise ValueError(f"{fn_name}: S={s_len} scores exceed the shared "
                         f"memory of one block")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16 \
            or any(st % 16 for st in kv_strides):
        raise ValueError(f"{fn_name}: code rows must be 16-byte aligned")
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), *q_strides, kp.data_ptr(), vp.data_ptr(),
            *kv_strides, ks.data_ptr(), vs.data_ptr(), *sc_strides,
            lens.data_ptr(), out.data_ptr(), *o_strides, b, nq, h, hkv,
            s_len, d, build.stream(q.device))
    build.check(rc, lib_name)
