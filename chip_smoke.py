#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with an H100 (or any
CUDA card) and ``nvcc``. It imports nothing of JAX and nothing of the
JAX package. Phases:

1. build the seven CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. for each kernel, at the main path's shapes: the largest difference
   from its plain PyTorch version, its time, the plain version's time,
   one PyTorch library call's time as a yardstick (never used by the
   port) and the least time the card could take (bytes at 3.35 TB/s or
   operations at the dtype's peak, whichever is larger). ``ms`` times
   back-to-back calls from the host; ``graph_ms`` the same 20 calls
   captured once in a CUDA graph and replayed, for the kernel and for
   the library call: at decode shapes ``ms`` is the host's ~20 µs a
   call, and ``graph_ms`` the card's work. Then the frontend's two f32
   products must give each row the same bits in calls of 1, 5, 10, 16,
   17 rows as in the whole product, and ``StreamingFrontend`` over 30 s
   at pushes of 1600 and of 173 samples must equal ``audio_frames``
   bit for bit (where not, the first stage whose rows differ is named:
   rfft, mel GEMM, pooling, projection GEMM);
3. ``repro_torch.transcribe`` of 30 s of synthetic audio (1500 encoder
   frames, one chunk) at full whisper-tiny.en width, seeded random
   weights, 32 new tokens at 8 decode steps a tick: bf16 weights with a
   bf16 cache, then Q8_0 weights with the q8_0 cache. Each prints
   ``pre_decode_s`` (wall less decode: the frontend, the encoder and the
   prefill);
4. a serve phase: 4 audio requests on 4 slots, 8 decode steps a tick,
   through ``BatchScheduler`` (Q8_0 weights, q8_0 cache);
5. the q4_0 tier and self-speculative decoding, bf16 weights:
   a. ``transcribe`` with the q4_0 self and cross cache;
   b. ``transcribe`` through a reused speculative engine (q4_0 cache,
      ``spec_k=4``: 3 draft steps on Q4_0 weights, one verify of 4
      positions a round, 2 rounds a tick), whose tokens must be a's;
   c. ``BatchScheduler`` over a speculative engine with the q8_0 cache
      (4 requests on 4 slots, ``spec_k=4``), whose tokens must be those
      of a plain (``spec_k=0``) serve of the same requests.
   Each prints its draft steps, verify steps, acceptance rate and host
   syncs per tick, and b and c their replayed ticks' tokens a second
   against a's and the plain serve's;
e. ``transcribe(stream=True)`` of the 30 s (Q8_0 weights, q8_0 cache): 93
   chunks of 16 frames and a tail of 12, one a scheduler tick, 32 new
   tokens at 8 steps a tick. The final transcript must equal the
   one-shot ``transcribe`` of the same chunks (tokens, and logits rows
   bit-equal or within ``CAPTURE_REL_TOL``). It prints the partial
   hypotheses, the wall time from the first chunk's feed to the first
   partial token, from the last chunk's feed to the final transcript,
   and the mean feed of a later chunk (encode, ``cross_attn_kv``, the
   in-place extension);
f. a serve of 2 streams (30 s and 20 s, chunks of 16) beside 2 one-shot
   requests (10 s and 25 s) on 4 slots (Q8_0, q8_0 cache), so the graph
   replays while a stream extends the pool under other active lanes;
   each stream's final tokens must equal a one-shot request of the same
   chunks' states, and every stream be closed and every slot free;
d. xlstm-350m at full width (24 blocks, d_model 1024, seeded random bf16
   weights): 4 token requests (prompts of 64, 128, 192 and 256 ids drawn
   from the seed, 32 new tokens each) on 4 slots through
   ``BatchScheduler``, 8 decode steps a tick. The sLSTM recurrence runs
   on ``slstm_scan`` at prefill and decode, the untied f32 head on
   ``fp16_matmul``. It prints wall seconds, decode tok/s, ticks, host
   syncs and the ``energy_report`` on ``h100-sxm``.

Phase 2 holds each kernel to its plain version within one bf16 rounding
of the largest output (``rel`` below), and adds "tail" cases whose
values live only in the last keys before the end or a lane's length, and
past a lane's length a large poison: a kernel that drops the ragged last
KV tile, stops short of ``length`` or reads past it fails there. The
decode attentions also run at lengths on and one past a boundary of the
chunks their wrapper splits the cache into, at a length of 1, with a
lane of length 0 beside full ones, and over 65,536 positions; the dense
GEMM at every decoder shape (1 and 4 lanes, the 16-row verify), on rows
that are not 16-byte aligned, and at the xLSTM head with f32 x and the
bf16 weight as stored; the dense and Q8_0 GEMMs and flash attention at
a streamed encoder chunk of 16 rows and its tail of 12.

The f32 cases of phase 2 (the frontend GEMMs, the xLSTM head at a
decode step and at prefill of every prompt position, the sLSTM
recurrence) hold each output to f32 summation order (``F32_REL`` of the
largest value); the sLSTM cases include a decode step from a random
non-initial state, with R in f32 and in bf16, and a case with saturated
gates, and each counts the outputs that differ from the plain version
bit for bit (``bit_diff``, at most ``SLSTM_TIES``). The Q4_0 GEMM's
cases print the plan each shape took.

Every phase of 3, 4, 5, e, f and d runs twice with the same engine
settings:
captured (the default: the engine's first tick of a size runs eagerly,
the second captures it in a CUDA graph, every later one replays it) and
eager (``cuda_graph=False``). The captured run must have made one
capture per tick size and replayed from each size's second tick on; its
tokens must equal the eager run's, and its logits rows be bit-equal to
them or within ``CAPTURE_REL_TOL`` of the largest logit. Each run prints
its captures, replays, tick times and the decode tokens a second of its
replayed (or eager) ticks. Every decode tick of both runs is watched
with ``torch.cuda``'s sync debug mode: one synchronising CUDA call (the
token block's fetch) and one host fetch a tick, no more.

Before each run every kernel's launch count is set to 0 and the
dispatch log cleared; after it the script requires that each kernel of
that path launched and that every call of the seven ops was routed
``("accel", "cuda")``, and the captured run's counts (its replays add
what the capture pass recorded) must equal the eager run's. The engine
of each phase keeps the logits
row each token was chosen from; the same phase is then run again on the
plain versions (forced, on the card) and the two runs' rows must agree
within ``LOGIT_REL_TOL`` of the largest logit (``LOGIT_REL_TOL_Q4`` with a
q4_0 cache, ``LOGIT_REL_TOL_XLSTM`` in phase d), request by request, up to
the first token where the runs differ, which must be a near-tie
(``TIE_MARGIN``). Token lists held against each other (b against a, c
against the plain serve) follow the same near-tie rule. Any failure
raises and exits non-zero. The last line is the JSON result; the line
before it the card's name and power limit, the one before that the
kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM datasheet
PEAK = {"bf16": 989e12, "f16": 989e12, "f32": 67e12, "int8": 1979e12}
BF16_REL = 2 ** -7   # one bf16 rounding of each side, at the largest value
F32_REL = 1e-5       # f32 outputs: summation order only
# kernel-vs-plain logits over the largest logit: 0.0062-0.0074 measured on
# an H100 (about one bf16 ulp of a logit near 5), with ~3x headroom
LOGIT_REL_TOL = 0.02
# the same with a q4_0 cache: 0.0169-0.0182 measured on an NVIDIA H100
# 80GB HBM3 at 700 W. A q4_0 code step is a block's max / 7, so a
# last-bit difference in a new K/V row that lands on a rounding boundary
# moves that entry by a whole step
LOGIT_REL_TOL_Q4 = 0.05
# phase d's kernel-vs-plain logits over the largest logit: 7.8e-7
# measured on an NVIDIA H100 80GB HBM3 at 700 W, the head's f32
# summation order only (slstm_scan is bit-equal to its plain version; the
# rest of the model runs the same torch ops in both runs), ~13x headroom
LOGIT_REL_TOL_XLSTM = 1e-5
TIE_MARGIN = 0.25    # a token flip is allowed only below this logit gap
# a phase's captured logits rows against its eager run's, over the largest
# logit, where they are not bit-equal
CAPTURE_REL_TOL = 1e-5
# slstm_scan outputs of a phase-2 case that may differ from the plain
# version bit for bit. The dot's exact products are summed in f64 in the
# kernel's own order and rounded once to f32, so the two round apart only
# where the f64 sum lies within its ~2^-45 relative error of an f32
# rounding boundary (a tie; none seen in PRs 13-15). One tie at a case's
# last step moves the 5 outputs of its (lane, column): hs, c, n, h, m
SLSTM_TIES = 5
ARCH = "whisper-tiny-en"
MAX_NEW = 32
SEED = 0


def _log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    CUDA events (inputs stay warm in L2 where they fit)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured once in a
    ``torch.cuda.CUDAGraph`` and replayed: the card's work without the
    host's ~20 µs a call, which ``cuda_ms`` measures at small shapes."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """(least ms, what bounds it) for moving ``nbytes`` and doing ``ops``."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / PEAK[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ----------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at main-path shapes
# ----------------------------------------------------------------------------

def kernel_cases():
    """Per kernel, its main-path cases; the first is the kernel's line in
    the JSON. Each case: (label, kernel fn, plain fn, library fn or None,
    bytes, ops, dtype, rel): the kernel must agree with the plain version
    within ``rel`` times the plain version's largest magnitude."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build, decode
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import plain as fa_plain
    from repro_torch.kernels.fp16_matmul import ops as mm_ops
    from repro_torch.kernels.fp16_matmul import plain as mm_plain
    from repro_torch.kernels.q4_attention import ops as q4a_ops
    from repro_torch.kernels.q4_attention import plain as q4a_plain
    from repro_torch.kernels.q4_matmul import ops as q4_ops
    from repro_torch.kernels.q4_matmul import plain as q4_plain
    from repro_torch.kernels.q8_attention import ops as qa_ops
    from repro_torch.kernels.q8_attention import plain as qa_plain
    from repro_torch.kernels.q8_matmul import ops as q8_ops
    from repro_torch.kernels.q8_matmul import plain as q8_plain
    from repro_torch.kernels.slstm_scan import ops as sl_ops
    from repro_torch.kernels.slstm_scan import plain as sl_plain
    from repro_torch.quantize import (dequantize_q4_0, dequantize_q8_0,
                                      quantize_q4_0, quantize_q8_0)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    bf = torch.bfloat16

    def randn(shape, dtype=bf, scale=1.0):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return (x * scale).to(dev).to(dtype)

    cases = {}

    mm = []
    for label, m, k, n, dt in (
            ("encoder MLP up", 1500, 384, 1536, bf),
            ("encoder MLP down", 1500, 1536, 384, bf),
            ("encoder wo", 1500, 384, 384, bf),
            ("prefill MLP up", 32, 384, 1536, bf),
            ("decode MLP up, 4 lanes", 4, 384, 1536, bf),
            ("decode wo, 1 lane", 1, 384, 384, bf),
            ("decode MLP up, 1 lane", 1, 384, 1536, bf),
            ("decode MLP down, 1 lane", 1, 1536, 384, bf),
            ("decode MLP down, 4 lanes", 4, 1536, 384, bf),
            ("verify MLP down, 16 rows", 16, 1536, 384, bf),
            ("ragged, rows not 16-byte aligned", 33, 45, 70, bf),
            ("encoder chunk MLP up", 16, 384, 1536, bf),
            ("encoder chunk MLP down", 16, 1536, 384, bf),
            ("encoder chunk wo", 16, 384, 384, bf),
            ("encoder tail chunk MLP up", 12, 384, 1536, bf),
            ("encoder tail chunk MLP down", 12, 1536, 384, bf),
            ("encoder tail chunk wo", 12, 384, 384, bf),
            ("frontend mel (f32)", 3000, 201, 80, torch.float32),
            ("frontend projection (f32)", 1500, 80, 384, torch.float32)):
        x, w = randn((m, k), dt), randn((k, n), dt, k ** -0.5)
        out = bf if dt == bf else torch.float32
        y = torch.empty((m, n), dtype=out, device=dev)
        mm.append((f"{label} ({m},{k})@({k},{n})",
                   lambda x=x, w=w, o=out: mm_ops.fp16_matmul(x, w,
                                                              out_dtype=o),
                   lambda x=x, w=w, o=out: mm_plain.fp16_matmul(x, w, o),
                   lambda x=x, w=w: torch.matmul(x, w),
                   _nbytes(x, w, y), 2.0 * m * n * k,
                   "bf16" if dt == bf else "f32",
                   BF16_REL if dt == bf else F32_REL))
    # the xLSTM head: f32 activations @ the f32-cast lm_head over the
    # padded vocab, at phase d's decode step (4 lanes) and prefill (every
    # position of a prompt: its longest, 256, and a ragged 77)
    k, n = 1024, 51200
    for label, m in (("decode, 4 lanes", 4), ("prefill S=256", 256),
                     ("prefill S=77 (ragged)", 77)):
        x, w = randn((m, k), torch.float32), randn((k, n), torch.float32,
                                                   k ** -0.5)
        y = torch.empty((m, n), dtype=torch.float32, device=dev)
        mm.append((f"xlstm head, {label} (f32) ({m},{k})@({k},{n})",
                   lambda x=x, w=w: mm_ops.fp16_matmul(x, w),
                   lambda x=x, w=w: mm_plain.fp16_matmul(x, w),
                   lambda x=x, w=w: torch.matmul(x, w),
                   _nbytes(x, w, y), 2.0 * m * n * k, "f32", F32_REL))
    # the head as phase d runs it: f32 activations @ the bf16 lm_head as
    # it is stored, widened in the kernel; the library call multiplies
    # the f32-widened weight, as the head did before
    x = randn((4, k), torch.float32)
    w = randn((k, n), torch.float32, k ** -0.5)
    wb = w.to(bf)
    y = torch.empty((4, n), dtype=torch.float32, device=dev)
    mm.append((f"xlstm head, decode, 4 lanes (f32 x, bf16 w) (4,{k})@({k},"
               f"{n})",
               lambda x=x, wb=wb: mm_ops.fp16_matmul(x, wb),
               lambda x=x, wb=wb: mm_plain.fp16_matmul(x, wb),
               lambda x=x, w=wb.float(): torch.matmul(x, w),
               _nbytes(x, wb, y), 2.0 * 4 * n * k, "f32", F32_REL))
    cases["fp16_matmul"] = mm

    # the main path's shapes (bf16 x and out); the verify's rows at the
    # GEMV/tile threshold (q8_ops.GEMV_MAX_M = 16) and one on each side;
    # f16 x (tensor cores on f16 operands) and f32 x (f32 arithmetic)
    q8 = []
    f16, f32 = torch.float16, torch.float32
    for label, m, k, n, dt in (
            ("encoder MLP up", 1500, 384, 1536, bf),
            ("encoder MLP down", 1500, 1536, 384, bf),
            ("encoder wo", 1500, 384, 384, bf),
            ("prefill MLP up", 32, 384, 1536, bf),
            ("decode MLP up, 4 lanes", 4, 384, 1536, bf),
            ("decode MLP down, 4 lanes", 4, 1536, 384, bf),
            ("decode wo, 1 lane", 1, 384, 384, bf),
            ("verify MLP down, 15 rows", 15, 1536, 384, bf),
            ("verify MLP down, 16 rows", 16, 1536, 384, bf),
            ("verify MLP down, 17 rows", 17, 1536, 384, bf),
            ("verify MLP up, 16 rows", 16, 1536, 1536, bf),
            ("encoder chunk MLP up", 16, 384, 1536, bf),
            ("encoder chunk MLP down", 16, 1536, 384, bf),
            ("encoder chunk wo, cross_attn_kv", 16, 384, 384, bf),
            ("encoder tail chunk MLP up", 12, 384, 1536, bf),
            ("encoder tail chunk MLP down", 12, 1536, 384, bf),
            ("encoder tail chunk wo, cross_attn_kv", 12, 384, 384, bf),
            ("encoder MLP down (f16 x)", 1500, 1536, 384, f16),
            ("decode MLP down, 4 lanes (f16 x)", 4, 1536, 384, f16),
            ("encoder MLP down (f32 x)", 1500, 1536, 384, f32),
            ("decode MLP down, 4 lanes (f32 x)", 4, 1536, 384, f32)):
        x = randn((m, k), dt)
        w = quantize_q8_0(randn((k, n), f32, k ** -0.5), axis=0)
        wd = dequantize_q8_0(w, dt, axis=0)
        y = torch.empty((m, n), dtype=dt, device=dev)
        q8.append((f"{label} ({m},{k})@({k},{n})",
                   lambda x=x, w=w, o=dt: q8_ops.q8_matmul(x, w, out_dtype=o),
                   lambda x=x, w=w, o=dt: q8_plain.q8_matmul(x, w.q, w.scale,
                                                             o),
                   lambda x=x, wd=wd: torch.matmul(x, wd),
                   _nbytes(x, w.q, w.scale, y), 2.0 * m * n * k,
                   {bf: "bf16", f16: "f16", f32: "f32"}[dt],
                   F32_REL if dt == f32 else BF16_REL))
    cases["q8_matmul"] = q8

    def pairs(sq, skv, causal, window):
        """Unmasked (query, key) pairs: the products the masks leave."""
        qp = np.arange(sq)[:, None]
        kp = np.arange(skv)[None, :]
        keep = np.ones((sq, skv), bool)
        if causal:
            keep &= kp <= qp
        if window:
            keep &= (qp - kp) < window
        return float(keep.sum())

    # the main path's three (B*H = 6, D = 64); then the KV-split path:
    # few queries against the 1500 encoder frames, a ragged Skv whose
    # last tile holds 1 key (65) or 29 (1501), GQA, a window (with rows
    # whose every key is masked: Sq > Skv), softcap and D = 32. Each also
    # with V only on the last 3 keys a row sees: the output is what the
    # ragged last KV tile holds, so dropping or mis-masking it fails
    fa = []
    for label, b, sq, skv, h, hkv, d, causal, window, softcap in (
            ("encoder self, bidirectional", 1, 1500, 1500, 6, 6, 64, False,
             None, None),
            ("decoder prefill, causal", 1, 32, 32, 6, 6, 64, True, None,
             None),
            ("encoder chunk, bidirectional", 1, 16, 16, 6, 6, 64, False,
             None, None),
            ("encoder tail chunk, bidirectional", 1, 12, 12, 6, 6, 64, False,
             None, None),
            ("cross prefill", 1, 32, 1500, 6, 6, 64, False, None, None),
            ("split KV", 1, 1, 1500, 6, 6, 64, False, None, None),
            ("split KV", 1, 16, 1500, 6, 6, 64, False, None, None),
            ("split KV", 1, 33, 1500, 6, 6, 64, False, None, None),
            ("split KV, ragged", 1, 32, 1501, 6, 6, 64, False, None, None),
            ("split KV, ragged", 2, 40, 65, 6, 6, 64, False, None, None),
            ("split KV, GQA", 2, 16, 1500, 4, 2, 32, False, None, None),
            ("split KV, causal window", 1, 33, 1500, 6, 6, 64, True, 100,
             None),
            ("split KV, causal window, masked rows", 1, 200, 65, 2, 1, 32,
             True, 16, None),
            ("split KV, softcap", 1, 16, 1500, 4, 1, 64, False, None,
             5.0)):
        q, k, v = randn((b, sq, h, d)), randn((b, skv, hkv, d)), \
            randn((b, skv, hkv, d))
        kw = dict(causal=causal, window=window, softcap=softcap)
        plain_only = hkv != h or window or softcap
        # causal: the last keys a row sees are those before min(Sq, Skv);
        # the keys after them keep V and must weigh 0
        vtail = v.clone()
        vtail[:, :(min(sq, skv) if causal else skv) - 3] = 0
        for tag, vv in (("", v), (", V on the last 3 keys seen", vtail)):
            lib = None
            if not (tag or plain_only):
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                lib = (lambda qt=qt, kt=kt, vt=vt, c=causal:
                       F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=c))
            opts = "".join(f" {n}={kw[n]}" for n in ("window", "softcap")
                           if kw[n])
            fa.append((f"{label} B*H={b * h} Hkv={hkv} Sq={sq} Skv={skv} "
                       f"D={d}{' causal' if causal else ''}{opts}{tag}",
                       lambda q=q, k=k, v=vv, kw=kw:
                           fa_ops.flash_attention(q, k, v, **kw),
                       lambda q=q, k=k, v=vv, kw=kw:
                           fa_plain.flash_attention(q, k, v, **kw),
                       lib, _nbytes(q, k, v, q),
                       4.0 * pairs(sq, skv, causal, window) * b * h * d,
                       "bf16", BF16_REL))
    cases["flash_attention"] = fa

    # each draft shape prints the GEMV plan it took: (layout, column
    # groups a warp, warps a CTA, CTAs a cluster splitting K)
    q4 = []
    sms = build.sm_count(dev)
    for label, m, k, n in (("draft MLP up, 4 lanes", 4, 384, 1536),
                           ("draft MLP down, 4 lanes", 4, 1536, 384),
                           ("draft wo, 4 lanes", 4, 384, 384),
                           ("draft MLP up, 1 lane", 1, 384, 1536),
                           ("draft MLP down, 1 lane", 1, 1536, 384),
                           ("draft wo, 1 lane", 1, 384, 384)):
        x = randn((m, k))
        w = quantize_q4_0(randn((k, n), torch.float32, k ** -0.5), axis=0)
        wd = dequantize_q4_0(w, bf, axis=0)
        y = torch.empty((m, n), dtype=bf, device=dev)
        q4.append((f"{label} ({m},{k})@({k},{n}) plan="
                   f"{q4_ops.plan(m, n, k, sms)}",
                   lambda x=x, w=w: q4_ops.q4_matmul(x, w, out_dtype=bf),
                   lambda x=x, w=w: q4_plain.q4_matmul(x, w.q, w.scale, bf),
                   lambda x=x, wd=wd: torch.matmul(x, wd),
                   _nbytes(x, w.q, w.scale, y), 2.0 * m * n * k, "bf16",
                   BF16_REL))
    cases["q4_matmul"] = q4

    def decode_cases(tier, specs):
        """Decode attention over one layer of a stacked cache of
        ``tier``; each spec: (label, lanes, queries, S, lengths (B,) or
        (B, Q)). Each case also runs with V only on the 3 positions
        before each lane's first length and a large poison past it."""
        quant = quantize_q8_0 if tier == "q8_0" else quantize_q4_0
        deq = dequantize_q8_0 if tier == "q8_0" else dequantize_q4_0
        kern, plain = ((qa_ops.q8_decode_attention_cache,
                        qa_plain.q8_decode_attention_cache)
                       if tier == "q8_0" else
                       (q4a_ops.q4_decode_attention_cache,
                        q4a_plain.q4_decode_attention_cache))
        # bytes of one cached position of one head: K and V codes, scales
        code_b = 1.0 if tier == "q8_0" else 0.5
        row_b = 2 * 64 * code_b + 2 * 2 * 64 // 32
        out = []
        for label, b, nq, s_len, lens in specs:
            # the stacked layers of a long cache: one is enough
            L, h, d = (4 if s_len <= 4096 else 1), 6, 64
            ln = torch.tensor(lens, device=dev)
            ln2 = ln if ln.dim() == 2 else ln[:, None].expand(b, nq)
            first = ln2[:, 0].tolist()
            kf = randn((L, b, s_len, h, d), torch.float32)
            vf = randn((L, b, s_len, h, d), torch.float32)
            vtail = torch.zeros_like(vf)
            for i, n0 in enumerate(first):
                lo = max(n0 - 3, 0)
                vtail[:, i, lo:n0] = vf[:, i, lo:n0]
                vtail[:, i, n0:] = 8.0 * vf[:, i, n0:]
            kt = quant(kf, axis=-1)
            q = randn((b, nq, h, d))
            mask = (torch.arange(s_len, device=dev)[None, None, :]
                    < ln2[:, :, None])[:, None]          # (B, 1, Q, S)
            qh = q.transpose(1, 2).contiguous()
            # each lane's cache rows are read once for all its queries
            read = float(ln2.max(dim=1).values.sum()) * h * row_b
            ops = 4.0 * float(ln2.sum()) * h * d
            for tag, vsrc in (("", vf), (", V on the last 3 before length",
                                         vtail)):
                vt = quant(vsrc, axis=-1)
                lib = None
                if not tag:
                    # yardstick: SDPA over the pre-dequantized bf16 layer
                    kd = deq(kt, bf)[0].transpose(1, 2).contiguous()
                    vd = deq(vt, bf)[0].transpose(1, 2).contiguous()
                    lib = (lambda qh=qh, kd=kd, vd=vd, mask=mask:
                           F.scaled_dot_product_attention(qh, kd, vd,
                                                          attn_mask=mask))
                out.append((f"{label} S={s_len} Q={nq} lens={lens} H=6 "
                            f"D=64{tag}",
                            lambda q=q, kt=kt, vt=vt, ln=ln:
                                kern(q, kt.q, kt.scale, vt.q, vt.scale, ln,
                                     0),
                            lambda q=q, kt=kt, vt=vt, ln=ln:
                                plain(q, kt.q, kt.scale, vt.q, vt.scale, ln,
                                      0),
                            lib, read + _nbytes(q, q, ln), ops, "bf16",
                            BF16_REL))
        return out

    cross = [1500, 1000, 500, 1250]
    verify = [[33 + j, 20 + j, 9 + j, 27 + j] for j in range(4)]
    verify = [list(r) for r in zip(*verify)]       # (B, Q): pos + j + 1
    # the cache's chunks as the wrapper splits S=1500 across CTAs: a
    # length that ends on a chunk's last position, one a position past
    # it, a length of 1, a lane of length 0 beside full ones, and an S
    # above the ~58,000 positions a softmax held in one block's shared
    # memory could take
    ch1 = decode.chunk_plan(1, 6, 1, 1500, sms)[0]
    ch4 = decode.chunk_plan(4, 6, 1, 1500, sms)[0]
    edges = (
        ("cross decode, 1 lane, length on a chunk boundary", 1, 1, 1500,
         [10 * ch1]),
        ("cross decode, 1 lane, a position past a chunk boundary", 1, 1,
         1500, [10 * ch1 + 1]),
        ("cross decode, 4 lanes, lengths on and past a chunk boundary", 4,
         1, 1500, [2 * ch4, 2 * ch4 + 1, 1500, 3 * ch4]),
        ("decode, 1 lane, length 1", 1, 1, 1500, [1]),
        ("cross decode, 4 lanes, one of length 0", 4, 1, 1500,
         [1500, 0, 1500, 1500]),
        ("decode, 1 lane, S beyond one block's shared memory", 1, 1, 65536,
         [65536]))
    cases["q8_decode_attention"] = decode_cases("q8_0", (
        ("cross decode, 4 lanes", 4, 1, 1500, cross),
        ("self decode, 4 lanes", 4, 1, 64, [33, 20, 9, 27]),
        ("cross decode, 1 lane", 1, 1, 1500, [1500]),
        ("self verify, 4 lanes x 4 queries", 4, 4, 64, verify),
        ("cross verify, 4 lanes x 4 queries", 4, 4, 1500, cross)) + edges)
    # phases a and b run one slot: S is 35 (a) or 38 (b, spec headroom)
    cases["q4_decode_attention"] = decode_cases("q4_0", (
        ("cross decode, 1 lane", 1, 1, 1500, [1500]),
        ("self decode, 1 lane", 1, 1, 35, [20]),
        ("self verify, 1 lane x 4 queries", 1, 4, 38, [[30, 31, 32, 33]]),
        ("cross verify, 1 lane x 4 queries", 1, 4, 1500, [1500]),
        ("cross decode, 4 lanes", 4, 1, 1500, cross),
        ("self decode, 4 lanes", 4, 1, 64, [33, 20, 9, 27]),
        ("self verify, 4 lanes x 4 queries", 4, 4, 64, verify),
        ("cross verify, 4 lanes x 4 queries", 4, 4, 1500, cross)) + edges)

    # the sLSTM recurrence at xlstm-350m's width (4 heads of 256): the
    # prompts of phase d, its decode step from a lane's state (with R in
    # f32 and in bf16, as the model stores it), and gates driven far into
    # saturation (lane 0: i >> 0, f << 0; lane 1: the reverse). No single
    # PyTorch call computes the recurrence. Each case also counts the
    # outputs that differ from the plain version bit for bit (at most
    # SLSTM_TIES)
    f32 = torch.float32
    sl = []
    h, hd = 4, 256
    for label, S, b, init, sat, rdt in (
            ("prefill B=1 S=256", 256, 1, True, False, f32),
            ("prefill B=1 S=77 (ragged)", 77, 1, True, False, f32),
            ("decode B=4 S=1 from a non-initial state", 1, 4, False, False,
             f32),
            ("decode B=4 S=1 from a non-initial state, bf16 R", 1, 4, False,
             False, bf),
            ("saturated gates B=2 S=64", 64, 2, False, True, f32)):
        wx = randn((S, 4, b, h, hd), f32)
        if sat:
            wx[:, 0, 0] += 60.0
            wx[:, 1, 0] -= 60.0
            wx[:, 0, 1] -= 60.0
            wx[:, 1, 1] += 60.0
        r = randn((4, h, hd, hd), rdt, hd ** -0.5)
        if init:
            st = torch.zeros((4, b, h, hd), device=dev)
            st[3] = -1e30
        else:    # c, n > 0, h and a finite m, as a lane's pool state
            st = torch.stack([randn((b, h, hd), f32),
                              randn((b, h, hd), f32).abs() + 0.5,
                              randn((b, h, hd), f32, 0.5),
                              randn((b, h, hd), f32)])
        out = (torch.empty((S, b, h, hd), device=dev), torch.empty_like(st))
        sl.append((f"{label} H=4 hd=256 plan={sl_ops.plan(b, h, hd)}",
                   lambda wx=wx, r=r, st=st: sl_ops.slstm_scan(wx, r, st),
                   lambda wx=wx, r=r, st=st: sl_plain.slstm_scan(wx, r, st),
                   None, _nbytes(wx, r, st, *out),
                   2.0 * 4 * S * b * h * hd * hd, "f32", F32_REL))
    cases["slstm_scan"] = sl
    return cases


KERNEL_META = {
    "fp16_matmul": ("csrc/fp16_matmul.cu",
                    "src/repro/kernels/fp16_matmul/fp16_matmul.py:44"),
    "q8_matmul": ("csrc/q8_matmul.cu",
                  "src/repro/kernels/q8_matmul/q8_matmul.py:52"),
    "flash_attention": ("csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:74"),
    "q8_decode_attention": ("csrc/q8_attention.cu",
                            "src/repro/kernels/q8_attention/"
                            "q8_attention.py:74"),
    "q4_matmul": ("csrc/q4_matmul.cu",
                  "src/repro/kernels/q4_matmul/q4_matmul.py:60"),
    "q4_decode_attention": ("csrc/q4_attention.cu",
                            "src/repro/kernels/q4_attention/"
                            "q4_attention.py:78"),
    "slstm_scan": ("csrc/slstm_scan.cu",
                   "src/repro/kernels/slstm_scan/slstm_scan.py:68"),
}


def _hold(name: str, label: str, got, want, rel: float) -> tuple:
    """(max |kernel - plain|, tolerance); each output (a tensor, or each
    of a tuple's) within ``rel`` of its own largest plain magnitude."""
    if isinstance(want, tuple):
        errs = [_hold(name, f"{label}, output {j}", g, w, rel)
                for j, (g, w) in enumerate(zip(got, want))]
        return max(e for e, _ in errs), min(t for _, t in errs)
    err = _max_err(got, want)
    tol = rel * float(want.float().abs().max())
    if not (tol > 0 and err <= tol):
        raise AssertionError(f"{name} [{label}]: max |kernel - plain| = "
                             f"{err} > {tol}")
    return err, tol


def check_kernels() -> dict:
    import torch
    rows = {}
    for name, cases in kernel_cases().items():
        for i, (label, kern, plain, lib, nb, ops, dt, rel) in \
                enumerate(cases):
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            err, tol = _hold(name, label, got, want, rel)
            ties = ""
            if name == "slstm_scan":
                n_diff = sum(int((g != w).sum()) for g, w in zip(got, want))
                ties = f" bit_diff={n_diff}"
                if n_diff > SLSTM_TIES:
                    raise AssertionError(f"{name} [{label}]: {n_diff} outputs "
                                         f"differ from the plain version, "
                                         f"more than {SLSTM_TIES}")
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            g_ms = graph_ms(kern)
            lib_ms = lib_g_ms = None
            if lib is not None:
                lib_ms, lib_g_ms = cuda_ms(lib), graph_ms(lib)
            b_ms, b_by = bound(nb, ops, dt)

            def fmt(t):
                return "None" if t is None else f"{t:.4f}"
            _log(f"kernel {name} [{label}]: max_abs_err={err:.3g} "
                 f"(tol {tol:.3g}){ties} ms={ms:.4f} graph_ms={g_ms:.4f} "
                 f"plain_ms={plain_ms:.4f} library_ms={fmt(lib_ms)} "
                 f"library_graph_ms={fmt(lib_g_ms)} bound_ms={b_ms:.5f} "
                 f"({b_by}) bound/graph_ms={b_ms / g_ms:.3f}")
            if i == 0:
                rows[name] = dict(max_abs_err=err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms)
    return rows


def check_frontend_rows() -> None:
    """The frontend's two f32 x f32 products give each row the same bits
    in a call of 1, 5, 10, 16, 17 rows as in the whole product (3000 or
    1500 rows): the streaming frontend makes them over a push's rows."""
    import numpy as np
    import torch

    from repro_torch.kernels.fp16_matmul import ops as mm_ops
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for m, k, n in ((3000, 201, 80), (1500, 80, 384)):
        x = torch.from_numpy(rng.random((m, k)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                             * k ** -0.5).to(dev)
        full = mm_ops.fp16_matmul(x, w)
        for rows in (1, 5, 10, 16, 17, m):
            for at in sorted({0, 7 % (m - rows + 1), m - rows}):
                part = mm_ops.fp16_matmul(x[at:at + rows].contiguous(), w)
                if not torch.equal(part, full[at:at + rows]):
                    raise AssertionError(f"fp16_matmul ({m},{k})@({k},{n}): "
                                         f"rows {at}..{at + rows} differ "
                                         f"from the whole product's")
        _log(f"frontend rows ({m},{k})@({k},{n}): calls of 1, 5, 10, 16, "
             f"17 and {m} rows bit-equal to the whole product's rows")


# ----------------------------------------------------------------------------
# The streaming frontend on the card
# ----------------------------------------------------------------------------

def frontend_stage_diff(x, d_model: int, ranges: list):
    """The first stage of the frontend (rfft, mel GEMM, pooling,
    projection GEMM) whose rows differ between the whole audio at once
    and the mel-frame ranges a streaming run computed them in, each
    stage fed the whole run's input; None where none differs."""
    import torch

    from repro_torch.audio import features as fe
    from repro_torch.kernels.fp16_matmul import ops as mm_ops
    dev = torch.device("cuda")
    cfg = fe.FrontendConfig()
    win = torch.from_numpy(fe.hann_window(cfg.n_fft)).to(dev)
    fb = torch.from_numpy(fe.mel_filterbank(cfg).copy()).to(dev)
    proj = torch.from_numpy(fe._cosine_projection(cfg.n_mels, d_model)
                            .copy()).to(dev)
    frames = torch.from_numpy(fe._frame_signal_np(x, cfg)).to(dev)

    def rfft(f):
        return torch.fft.rfft(f * win[None, :], dim=-1)

    def mel(spec):
        return mm_ops.fp16_matmul((spec.abs() ** 2).float().contiguous(), fb)

    def pool(lm):
        pad = -lm.shape[0] % cfg.stride
        lm = torch.nn.functional.pad(lm, (0, 0, 0, pad))
        return lm.reshape(-1, cfg.stride, cfg.n_mels).mean(dim=1)

    def project(pooled):
        return mm_ops.fp16_matmul(pooled.contiguous(), proj)

    spec = rfft(frames)
    mels = mel(spec)
    lm = (torch.log10(torch.clamp(mels, min=fe.MEL_EPS)).clamp(
        min=fe.LOG_FLOOR) + 4.0) / 4.0
    pooled = pool(lm)
    st = cfg.stride
    # (stage, its function, its input and output over the whole audio,
    # mel frames a row of each)
    stages = (("rfft", rfft, frames, spec, 1, 1),
              ("mel GEMM", mel, spec, mels, 1, 1),
              ("pooling", pool, lm, pooled, 1, st),
              ("projection GEMM", project, pooled, project(pooled), st, st))
    for name, fn, inp, whole, p_in, p_out in stages:
        for a, b in ranges:
            got = fn(inp[a // p_in:-(-b // p_in)])
            if not torch.equal(got, whole[a // p_out:-(-b // p_out)]):
                return f"{name} (mel frames {a}..{b})"
    return None


def check_stream_frontend(x, d_model: int) -> None:
    """``StreamingFrontend`` over the audio at pushes of 1600 samples
    (100 ms packets) and of 173, then ``flush``, equals the one-shot
    ``audio_frames`` on the card bit for bit."""
    import torch

    from repro_torch.audio.features import FrontendConfig, audio_frames
    from repro_torch.audio.stream import StreamingFrontend
    one = audio_frames(x, d_model, device="cuda")
    n_mel = FrontendConfig().n_frames(len(x))
    for step in (1600, 173):
        t0 = time.monotonic()
        sf = StreamingFrontend(d_model, device="cuda")
        outs = [sf.push(x[i:i + step]) for i in range(0, len(x), step)]
        outs.append(sf.flush())
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = torch.cat(outs)
        if got.shape == one.shape and torch.equal(got, one):
            _log(f"streaming frontend, pushes of {step} samples: "
                 f"{len(outs) - 1} pushes, {got.shape[0]} frames bit-equal "
                 f"to audio_frames ({wall:.3f} s wall)")
            continue
        ranges, e0 = [], 0
        for o in outs:
            if o.shape[0]:
                e1 = e0 + o.shape[0]
                ranges.append((2 * e0, min(2 * e1, n_mel)))
                e0 = e1
        stage = frontend_stage_diff(x, d_model, ranges)
        raise AssertionError(f"streaming frontend, pushes of {step}: "
                             f"{tuple(got.shape)} frames not bit-equal to "
                             f"audio_frames {tuple(one.shape)}; first stage "
                             f"whose rows differ: {stage}")


# ----------------------------------------------------------------------------
# Phases 3-4: the main path
# ----------------------------------------------------------------------------

def launch_counters():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fp16_matmul import ops as mm_ops
    from repro_torch.kernels.q4_attention import ops as q4a_ops
    from repro_torch.kernels.q4_matmul import ops as q4_ops
    from repro_torch.kernels.q8_attention import ops as qa_ops
    from repro_torch.kernels.q8_matmul import ops as q8_ops
    from repro_torch.kernels.slstm_scan import ops as sl_ops
    return {"fp16_matmul": mm_ops.fp16_matmul,
            "q8_matmul": q8_ops.q8_matmul,
            "flash_attention": fa_ops.flash_attention,
            "q8_decode_attention": qa_ops.q8_decode_attention,
            "q4_matmul": q4_ops.q4_matmul,
            "q4_decode_attention": q4a_ops.q4_decode_attention,
            "slstm_scan": sl_ops.slstm_scan}


def zero_counts() -> None:
    from repro_torch.kernels.api import reset_dispatch_log
    for fn in launch_counters().values():
        fn.launches = 0
    reset_dispatch_log()


def read_counts(phase: str, expect: tuple) -> tuple:
    """Launch counts and routing counters of this phase; every expected
    kernel launched and every dispatched call of the seven ops went
    ("accel", "cuda")."""
    from repro_torch.kernels.api import dispatch_counters
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    routing = dispatch_counters()
    _log(f"[{phase}] launches {counts}")
    _log(f"[{phase}] dispatch {dict(routing)}")
    for k in expect:
        if counts[k] <= 0:
            raise AssertionError(f"[{phase}] kernel {k} never launched")
    bad = {key: n for key, n in routing.items()
           if key[1:] != ("accel", "cuda")}
    if bad:
        raise AssertionError(f"[{phase}] calls not routed accel/cuda: {bad}")
    if not routing:
        raise AssertionError(f"[{phase}] no dispatched call at all")
    return counts, routing


_SYNCS = {"in_step": False, "sites": []}


@contextlib.contextmanager
def sync_debug():
    """Count every synchronising CUDA call made inside a watched tick
    (``watch_ticks``), with ``torch.cuda``'s sync debug mode, and note
    the innermost frame of the port that made it."""
    import traceback
    import warnings

    import torch

    def show(message, category, filename, lineno, *_a, **_k):
        if _SYNCS["in_step"] and "synchroniz" in str(message):
            port = [f for f in traceback.extract_stack()
                    if "repro_torch" in f.filename]
            _SYNCS["sites"].append(
                f"{os.path.basename(port[-1].filename)}:{port[-1].lineno}"
                if port else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")


def watch_ticks(eng) -> list:
    """Wrap ``eng.step``: for each tick with an active lane, (its tick
    size, synchronising CUDA calls, host seconds, tokens emitted, whether
    it replayed a graph it did not capture in the same tick, active lanes
    at its start)."""
    ticks = []
    step = eng.step

    def watched(k=None):
        active, n0 = eng.n_active, len(_SYNCS["sites"])
        r0, c0, g0 = eng.replays, eng.captures, eng._generated
        _SYNCS["in_step"] = True
        t0 = time.monotonic()
        try:
            return step(k)
        finally:
            _SYNCS["in_step"] = False
            if active:
                ticks.append((eng.decode_block if k is None else k,
                              len(_SYNCS["sites"]) - n0,
                              time.monotonic() - t0, eng._generated - g0,
                              eng.replays > r0 and eng.captures == c0,
                              active))

    eng.step = watched
    return ticks


def tick_gate(phase: str, eng, ticks: list, captured: bool) -> None:
    """One host fetch and one synchronising CUDA call a tick; a captured
    engine replays from its second tick of each size on, with one
    capture per size. Prints the ticks and, eager, the decode tokens a
    second over them."""
    syncs = [t[1] for t in ticks]
    if eng._host_syncs != eng._ticks or len(ticks) != eng._ticks \
            or any(n != 1 for n in syncs):
        raise AssertionError(f"[{phase}] decode ticks {eng._ticks}, host "
                             f"fetches {eng._host_syncs}, device syncs a "
                             f"tick {syncs} (at {_SYNCS['sites'][-8:]}): "
                             f"expected one each")
    sizes = [t[0] for t in ticks]
    repeated = {k for k in sizes if sizes.count(k) > 1}
    if captured and (eng.captures != len(repeated)
                     or eng.replays != len(ticks) - len(set(sizes))
                     or not any(t[4] for t in ticks)):
        raise AssertionError(f"[{phase}] {eng.captures} captures, "
                             f"{eng.replays} replays for ticks of "
                             f"{sizes}: expected one capture per size and "
                             f"a replay from each size's second tick on")
    if not captured and (eng.captures or eng.replays):
        raise AssertionError(f"[{phase}] the eager engine captured")
    tps = sum(t[3] for t in ticks) / sum(t[2] for t in ticks)
    _log(f"[{phase}] {'captured' if captured else 'eager'}: captures="
         f"{eng.captures} replays={eng.replays} tick_ms="
         f"{[round(t[2] * 1e3, 3) for t in ticks]} device_syncs_per_tick="
         f"{syncs}" + ("" if captured else f" tok_per_s={tps:.1f}"))


def steady(phase: str, eng, ticks: list, again):
    """The phase's work once more through its captured engine, whose
    graphs it must only replay: every tick replays without a capture and
    makes one synchronising CUDA call. Returns (what ``again`` returns,
    decode tokens a second, the same per active lane)."""
    import torch
    c0 = eng.captures
    ticks.clear()
    out = again()
    torch.cuda.synchronize()
    if eng.captures != c0 or not ticks \
            or not all(t[4] and t[1] == 1 for t in ticks):
        raise AssertionError(f"[{phase}] the rerun captured ({c0} -> "
                             f"{eng.captures}) or a tick did not replay "
                             f"once with one sync: {ticks}")
    emitted = sum(t[3] for t in ticks)
    tps = emitted / sum(t[2] for t in ticks)
    lane_tps = emitted / sum(t[2] * t[5] for t in ticks)
    _log(f"[{phase}] steady (the same work again, every tick replayed): "
         f"tick_ms={[round(t[2] * 1e3, 3) for t in ticks]} "
         f"decode_tok_per_s={tps:.1f} per_lane={lane_tps:.1f}")
    return out, tps, lane_tps


def capture_check(phase: str, got: list, want: list,
                  what=("captured", "eager")) -> None:
    """The captured run against the eager one (``cuda_graph=False``) with
    the same engine settings (or the two runs ``what`` names): per
    request the same tokens, and the same logits rows bit for bit or
    within ``CAPTURE_REL_TOL`` of the largest logit. ``got`` / ``want``:
    (tokens, logits rows) per request."""
    import torch
    err, top, unequal = 0.0, 0.0, 0
    for (gt, gl), (wt, wl) in zip(got, want):
        if gt != wt or len(gl) != len(wl):
            raise AssertionError(f"[{phase}] {what[0]} tokens {gt} differ "
                                 f"from the {what[1]} run's {wt}")
        for g, w in zip(gl, wl):
            unequal += not torch.equal(g, w)
            err = max(err, float((g.float() - w.float()).abs().max()))
            top = max(top, float(w.float().abs().max()))
    _log(f"[{phase}] {what[0]} vs {what[1]}: tokens equal, logits rows "
         f"bit-equal {sum(len(w[1]) for w in want) - unequal} of "
         f"{sum(len(w[1]) for w in want)}, max_abs_err={err:.4g} "
         f"rel={err / top:.4g} (tol {CAPTURE_REL_TOL})")
    if err > CAPTURE_REL_TOL * top:
        raise AssertionError(f"[{phase}] {what[0]} logits off the {what[1]} "
                             f"run's by {err / top:.4g} of the largest")


def same_counts(phase: str, counts: dict, routing, want: tuple) -> None:
    """The launches and routing counters a captured run counted (the
    replays' recorded ones) equal those of the eager run."""
    if counts != want[0] or routing != want[1]:
        raise AssertionError(f"[{phase}] captured run counted {counts} "
                             f"{dict(routing)}; the eager run {want[0]} "
                             f"{dict(want[1])}")


def plain_context():
    """Every op forced onto its plain version, on the card."""
    from repro_torch.kernels.api import DispatchContext
    return DispatchContext(force_backend="torch", allow_plain_on_cuda=True)


def _first_diff(got: list, want: list):
    return next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                None)


def _tie_gap(row, want_tok: int, got_tok: int) -> float:
    """How far below ``want_tok`` the row puts ``got_tok``."""
    return float(row[want_tok] - row[got_tok])


def tokens_check(phase: str, got: list, want: list, want_rows: list) -> None:
    """``got`` equals ``want`` up to the first difference, where ``got``'s
    pick must be within TIE_MARGIN of ``want``'s on ``want``'s row."""
    if len(got) != len(want):
        raise AssertionError(f"[{phase}] {len(got)} tokens vs {len(want)}")
    i = _first_diff(got, want)
    if i is not None:
        gap = _tie_gap(want_rows[i].float(), want[i], got[i])
        if gap >= TIE_MARGIN:
            raise AssertionError(f"[{phase}] token {i}: {got[i]} vs "
                                 f"{want[i]}, {gap:.4f} below it")
        _log(f"[{phase}] tokens differ from token {i} on, at a near-tie "
             f"(gap {gap:.4f} < {TIE_MARGIN})")


def logits_check(phase: str, runs: list, vocab: int,
                 tol: float = LOGIT_REL_TOL) -> float:
    """Hold each request's logits rows (the row each token was chosen
    from) of the kernel run against the plain run's, over the ``vocab``
    real ids (padding ids carry -1e9), up to and including the first
    token at which the two runs differ (a near-tie of the plain run, see
    ``tokens_check``). ``runs``: (kernel tokens, kernel rows, plain
    tokens, plain rows) per request. Returns max |kernel - plain| over
    the largest plain logit."""
    import torch
    err, top, n, total = 0.0, 0.0, 0, 0
    for got_tok, got, want_tok, want in runs:
        tokens_check(phase, got_tok, want_tok, want)
        if len(got) != len(got_tok) or len(want) != len(want_tok) \
                or not got:
            raise AssertionError(f"[{phase}] {len(got)} and {len(want)} "
                                 f"logits rows for {len(got_tok)} tokens")
        stop = _first_diff(got_tok, want_tok)
        stop = len(got) if stop is None else stop + 1
        for g, w in zip(got[:stop], want[:stop]):
            g, w = g[:vocab].float(), w[:vocab].float()
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"[{phase}] logits not finite")
            err = max(err, float((g - w).abs().max()))
            top = max(top, float(w.abs().max()))
            n += 1
        total += len(got)
    rel = err / top
    _log(f"[{phase}] logits vs plain run: max_abs_err={err:.4g} "
         f"max_abs_logit={top:.4g} rel={rel:.4g} (tol {tol}) "
         f"over {n} of {total} rows")
    if not rel <= tol:
        raise AssertionError(f"[{phase}] logits off the plain run by "
                             f"{rel:.4g} of the largest > {tol}")
    return rel


def _logit_tol(cache_dtype: str) -> float:
    return LOGIT_REL_TOL_Q4 if cache_dtype == "q4_0" else LOGIT_REL_TOL


def check_tokens(phase: str, tokens, vocab: int) -> None:
    if len(tokens) != MAX_NEW or not all(0 <= t < vocab for t in tokens):
        raise AssertionError(f"[{phase}] bad tokens {tokens}")


def spec_line(phase: str, eng) -> None:
    if eng.spec_k:
        _log(f"[{phase}] spec_k={eng.spec_k} draft_steps={eng._draft_steps} "
             f"verify_steps={eng._verify_steps} rounds={eng._spec_rounds} "
             f"acceptance_rate={eng.acceptance_rate:.4f} "
             f"host_syncs_per_tick={eng._host_syncs / eng._ticks:.2f}")


def run_transcribe(model, params, x, phase: str, expect: tuple,
                   cache_dtype: str, spec_k: int = 0, draft=None):
    """One transcription through the engine ``transcribe`` would build
    (or, with ``spec_k``, a reused speculative engine), keeping its
    logits, its ticks replayed from a CUDA graph; the same eagerly
    (``cuda_graph=False``), which it must equal; the captured engine's
    transcription again (``steady``); then the same on the plain
    versions. Returns (result, launch counts, steady decode tok/s)."""
    import torch

    import repro_torch
    from repro_torch.kernels.api import use_context
    from repro_torch.serving.engine import ServeEngine

    def engine(platform, cuda_graph=None):
        eng = ServeEngine(model, params, n_slots=1,
                          max_len=1 + MAX_NEW + 2 + max(spec_k - 1, 0),
                          enc_len=1500, cache_dtype=cache_dtype,
                          decode_block=8, platform=platform,
                          keep_logits=True, spec_k=spec_k,
                          draft_params=draft, cuda_graph=cuda_graph)
        ticks = watch_ticks(eng)

        def go():
            with sync_debug():
                r = repro_torch.transcribe(x, model=model, params=params,
                                           engine=eng, chunk_frames=1500,
                                           max_new=MAX_NEW)
            torch.cuda.synchronize()
            return r
        return go, ticks

    results = {}
    for captured in (True, False):
        zero_counts()
        go, ticks = engine("h100-sxm", None if captured else False)
        r = go()
        counts = read_counts(phase, expect)
        check_tokens(phase, r.tokens, model.cfg.vocab)
        if r.n_frames != 1500 or r.host_syncs != r.ticks:
            raise AssertionError(f"[{phase}] frames {r.n_frames}, host "
                                 f"syncs {r.host_syncs} vs ticks {r.ticks}")
        tick_gate(phase, r.engine, ticks, captured)
        results[captured] = (r, counts, go, ticks)
    r, (counts, routing), go, ticks = results[True]
    e, eager_counts, _, _ = results[False]
    same_counts(phase, counts, routing, eager_counts)
    capture_check(phase, [(r.tokens, r.logits)], [(e.tokens, e.logits)])
    r2, tps, _ = steady(phase, r.engine, ticks, go)
    if r2.tokens != r.tokens:
        raise AssertionError(f"[{phase}] the rerun's tokens differ")
    _log(f"[{phase}] tokens {r.tokens}")
    # encode and prefill: what the encoder's flash attention and GEMMs set
    for tag, t in (("captured", r), ("eager", e), ("captured again", r2)):
        _log(f"[{phase}] {tag}: wall_s={t.wall_s:.4f} decode_s="
             f"{t.decode_s:.4f} pre_decode_s={t.wall_s - t.decode_s:.4f} "
             f"decode_tok_per_s={(len(t.tokens) - 1) / t.decode_s:.1f} "
             f"ticks={t.ticks} host_syncs={t.host_syncs} decode_steps="
             f"{t.decode_steps} modeled_j_per_audio_s="
             f"{t.energy['joules_per_audio_s']:.4g}")
    spec_line(phase, r.engine)
    with use_context(plain_context()):
        ref = engine(None)[0]()
    logits_check(phase, [(r.tokens, r.logits, ref.tokens, ref.logits)],
                 model.cfg.vocab, _logit_tol(cache_dtype))
    return r, counts, tps


STREAM_CHUNK = 16    # encoder frames a streamed chunk (the default)


def watch_feeds(eng) -> list:
    """Wrap ``eng.stream_feed``: for each feed, its host start and end and
    CUDA events recorded around it on the stream."""
    import torch
    feeds, feed = [], eng.stream_feed

    def timed(st, frames):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.monotonic()
        ev[0].record()
        try:
            return feed(st, frames)
        finally:
            ev[1].record()
            feeds.append((t0, time.monotonic(), *ev))

    eng.stream_feed = timed
    return feeds


def run_stream(model, params, x, phase: str, expect: tuple):
    """Phase e: ``transcribe(stream=True)`` of ``x`` in chunks of
    ``STREAM_CHUNK`` frames, one a scheduler tick, through the engine
    ``transcribe`` would build (q8_0 cache, 8 steps a tick), keeping its
    logits, its ticks replayed from a CUDA graph; the same eagerly,
    which it must equal; the captured engine's stream again
    (``steady``); the one-shot ``transcribe`` of the same chunks on that
    engine, whose tokens and logits rows the stream's final transcript
    must equal; then the stream on the plain versions. Returns the
    captured run's launch counts."""
    import torch

    import repro_torch
    from repro_torch.kernels.api import use_context
    from repro_torch.serving.engine import ServeEngine

    def engine(platform, cuda_graph=None):
        eng = ServeEngine(model, params, n_slots=1, max_len=1 + MAX_NEW + 2,
                          enc_len=1500, cache_dtype="q8_0", decode_block=8,
                          platform=platform, keep_logits=True,
                          cuda_graph=cuda_graph)
        ticks, feeds = watch_ticks(eng), watch_feeds(eng)

        def go(stream=True):
            feeds.clear()
            with sync_debug():
                r = repro_torch.transcribe(x, model=model, params=params,
                                           engine=eng, max_new=MAX_NEW,
                                           chunk_frames=STREAM_CHUNK,
                                           stream=stream)
            torch.cuda.synchronize()
            return r, time.monotonic()
        return go, ticks, feeds

    def timings(tag, r, t_end, feeds):
        """The stream's latencies: the first chunk's feed to its first
        partial token (the feed ends in the anchor's fetch), the last
        chunk's feed to the final transcript (finalize and its decode),
        the mean feed of a later chunk (encode, cross_attn_kv and the
        extension; CUDA events around it, and the host's enqueue)."""
        first = feeds[0][1] - feeds[0][0]
        last = t_end - feeds[-1][0]
        ext = feeds[1:]
        ev_ms = sum(a.elapsed_time(b) for *_, a, b in ext) / len(ext)
        host_ms = sum(t1 - t0 for t0, t1, *_ in ext) / len(ext) * 1e3
        _log(f"[{phase}] {tag}: feeds={len(feeds)} partials="
             f"{len(r.partials)} first_partial_s={first:.4f} "
             f"last_chunk_to_final_s={last:.4f} stream_feed_ms={ev_ms:.4f} "
             f"(host {host_ms:.4f}) wall_s={r.wall_s:.4f} ticks={r.ticks} "
             f"host_syncs={r.host_syncs}")

    results = {}
    for captured in (True, False):
        zero_counts()
        go, ticks, feeds = engine("h100-sxm", None if captured else False)
        r, t_end = go()
        counts = read_counts(phase, expect)
        check_tokens(phase, r.tokens, model.cfg.vocab)
        n_chunks = -(-r.n_frames // STREAM_CHUNK)
        if r.n_frames != 1500 or len(feeds) != n_chunks \
                or len(r.partials) != n_chunks + 1 \
                or r.engine.n_streams or len(r.engine.free) != 1:
            raise AssertionError(f"[{phase}] frames {r.n_frames}, feeds "
                                 f"{len(feeds)}, partials "
                                 f"{len(r.partials)}, open streams "
                                 f"{r.engine.n_streams}")
        tick_gate(phase, r.engine, ticks, captured)
        timings("captured" if captured else "eager", r, t_end, feeds)
        results[captured] = (r, counts, go, ticks, feeds)
    r, (counts, routing), go, ticks, feeds = results[True]
    e, eager_counts, *_ = results[False]
    same_counts(phase, counts, routing, eager_counts)
    capture_check(phase, [(r.tokens, r.logits)], [(e.tokens, e.logits)])
    (r2, t_end), _, _ = steady(phase, r.engine, ticks, go)
    if r2.tokens != r.tokens or r2.partials != r.partials:
        raise AssertionError(f"[{phase}] the rerun's tokens differ")
    timings("captured again", r2, t_end, feeds)
    _log(f"[{phase}] tokens {r.tokens}")
    one, _ = go(stream=False)
    capture_check(phase, [(r.tokens, r.logits)], [(one.tokens, one.logits)],
                  ("streamed", f"one-shot (chunks of {STREAM_CHUNK})"))
    with use_context(plain_context()):
        ref, _ = engine(None)[0]()
    logits_check(phase, [(r.tokens, r.logits, ref.tokens, ref.logits)],
                 model.cfg.vocab)
    return counts


SERVE_SECONDS = (30.0, 20.0, 10.0, 25.0)


def serve(model, params, frames, platform, cache_dtype: str,
          spec_k: int = 0, draft=None, cuda_graph=None, streamed=()):
    """4 audio requests on 4 slots through ``BatchScheduler``, 8 decode
    steps a tick; those of the indices ``streamed`` stream their frames
    in chunks of ``STREAM_CHUNK``, one a tick. Returns the engine, the
    watched ticks and ``drain``, which serves the requests (uids from its
    argument on) and returns their states; it has run once, for uids
    0-3."""
    from repro_torch.audio.stream import chunk_list
    from repro_torch.serving.engine import (AudioRequest, ServeEngine,
                                            StreamingAudioRequest)
    from repro_torch.serving.scheduler import BatchScheduler
    eng = ServeEngine(model, params, n_slots=4, max_len=64, enc_len=1500,
                      cache_dtype=cache_dtype, decode_block=8,
                      platform=platform, keep_logits=True, spec_k=spec_k,
                      draft_params=draft, cuda_graph=cuda_graph)
    ticks = watch_ticks(eng)
    sched = BatchScheduler(eng, max_admit_per_tick=4)

    def drain(uid0: int = 0) -> list:
        for i, fr in enumerate(frames):
            kw = dict(uid=uid0 + i, tokens=[1], max_new=MAX_NEW, eos_id=-1)
            sched.submit(StreamingAudioRequest(
                chunks=chunk_list(fr, STREAM_CHUNK), **kw) if i in streamed
                else AudioRequest(enc_frames=fr, **kw))
        with sync_debug():
            sched.run_until_drained(max_ticks=256)
        return [sched.results[uid0 + i] for i in range(len(frames))]

    drain.first = drain()
    return eng, ticks, drain


def rerun(phase: str, eng, ticks, drain) -> float:
    """``drain`` again through the captured engine (``steady``): the same
    tokens as its first run. Returns the decode tokens a second of an
    active lane."""
    again, _, lane_tps = steady(phase, eng, ticks,
                                lambda: drain(len(drain.first)))
    if [st.out for st in again] != [st.out for st in drain.first]:
        raise AssertionError(f"[{phase}] the rerun's tokens differ")
    return lane_tps


def run_serve(model, params, phase: str, expect: tuple, cache_dtype: str,
              spec_k: int = 0, draft=None, streamed=()):
    """The serve phase on the kernels, its ticks replayed from a CUDA
    graph, checked; the same eagerly, which it must equal; the captured
    engine's requests again (``rerun``); with ``streamed`` requests, the
    streams' final tokens against one-shot requests of the same chunks'
    states (``stream_gate``); then on the plain versions. Returns (the
    request states, the frames, launch counts, tok/s, the steady decode
    tok/s of an active lane)."""
    import torch

    from repro_torch.audio.features import audio_frames
    from repro_torch.audio.stream import synth_waveform
    from repro_torch.kernels.api import use_context
    waves = [synth_waveform(s, seed=i + 1)
             for i, s in enumerate(SERVE_SECONDS)]
    n = len(waves)
    runs = {}
    for captured in (True, False):
        zero_counts()
        t0 = time.monotonic()
        frames = [audio_frames(w, model.cfg.d_model, device="cuda")
                  for w in waves]
        eng, ticks, drain = serve(model, params, frames, "h100-sxm",
                                  cache_dtype, spec_k, draft,
                                  None if captured else False, streamed)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts(phase, expect)
        res = drain.first
        for st in res:
            if st.error:
                raise AssertionError(f"[{phase}] request {st.req.uid}: "
                                     f"{st.error}")
            check_tokens(phase, st.out, model.cfg.vocab)
        tick_gate(phase, eng, ticks, captured)
        n_tok = sum(len(st.out) for st in res)
        _log(f"[{phase}] {'captured' if captured else 'eager'}: wall_s="
             f"{wall:.4f} tokens={n_tok} tok_per_s={n_tok / wall:.1f} "
             f"ticks={eng._ticks} host_syncs={eng._host_syncs}")
        runs[captured] = (eng, res, counts, n_tok / wall, frames, ticks,
                          drain)
    eng, res, (counts, routing), tps, frames, ticks, drain = runs[True]
    _, eager_res, eager_counts, *_ = runs[False]
    same_counts(phase, counts, routing, eager_counts)
    capture_check(phase, [(st.out, st.logits) for st in res],
                  [(st.out, st.logits) for st in eager_res])
    lane_tps = rerun(phase, eng, ticks, drain)
    spec_line(phase, eng)
    if streamed:
        stream_gate(phase, eng, frames, streamed, res)
    with use_context(plain_context()):
        ref = serve(model, params, frames, None, cache_dtype, spec_k,
                    draft, streamed=streamed)[2].first
    logits_check(phase, [(st.out, st.logits, w.out, w.logits)
                         for st, w in zip(res, ref)], model.cfg.vocab,
                 _logit_tol(cache_dtype))
    return res, frames, counts, tps, lane_tps


def stream_gate(phase: str, eng, frames, streamed, res) -> None:
    """Every stream closed and every slot free; each stream's final
    tokens equal those of a one-shot request with ``enc_states`` the
    engine's ``encode_chunks`` of the same chunks, served on the same
    engine."""
    from repro_torch.audio.stream import chunk_list
    from repro_torch.serving.engine import AudioRequest
    from repro_torch.serving.scheduler import BatchScheduler
    if eng.n_streams or len(eng.free) != eng.n_slots \
            or not eng.lanestate.drained:
        raise AssertionError(f"[{phase}] {eng.n_streams} open streams, "
                             f"{len(eng.free)} free slots of {eng.n_slots}")
    sched = BatchScheduler(eng, max_admit_per_tick=4)
    for i in streamed:
        states = eng.encode_chunks(chunk_list(frames[i], STREAM_CHUNK))
        sched.submit(AudioRequest(uid=i, tokens=[1], max_new=MAX_NEW,
                                  eos_id=-1, enc_states=states[0]))
    sched.run_until_drained(max_ticks=64)
    capture_check(phase, [(res[i].out, res[i].logits) for i in streamed],
                  [(sched.results[i].out, sched.results[i].logits)
                   for i in streamed],
                  ("streamed", "one-shot (the same chunks' states)"))
    _log(f"[{phase}] streams: partials "
         f"{[len(res[i].partials) for i in streamed]}; open streams "
         f"{eng.n_streams}, free slots {len(eng.free)} of {eng.n_slots}")


# ----------------------------------------------------------------------------
# Phase d: xlstm-350m served at full width
# ----------------------------------------------------------------------------

def xlstm_serve(model, params, prompts, platform, cuda_graph=None):
    """The prompts as token requests on 4 slots through
    ``BatchScheduler``, 8 decode steps a tick, keeping the logits rows.
    Returns (engine, seconds spent in admission, the watched ticks,
    ``drain``: as ``serve``'s, run once for uids 0-3)."""
    from repro_torch.breakdown import XLSTM_MAX_LEN
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.scheduler import BatchScheduler
    eng = ServeEngine(model, params, n_slots=4, max_len=XLSTM_MAX_LEN,
                      decode_block=8, platform=platform, keep_logits=True,
                      cuda_graph=cuda_graph)
    admit_s = [0.0]
    admit = eng.admit

    def timed_admit(req):
        t0 = time.monotonic()
        try:
            return admit(req)     # ends in the first token's fetch
        finally:
            admit_s[0] += time.monotonic() - t0

    eng.admit = timed_admit
    ticks = watch_ticks(eng)
    sched = BatchScheduler(eng, max_admit_per_tick=4)

    def drain(uid0: int = 0) -> list:
        for i, p in enumerate(prompts):
            sched.submit(Request(uid=uid0 + i, tokens=p, max_new=MAX_NEW,
                                 eos_id=-1))
        with sync_debug():
            sched.run_until_drained(max_ticks=64)
        return [sched.results[uid0 + i] for i in range(len(prompts))]

    drain.first = drain()
    return eng, admit_s[0], ticks, drain


def run_xlstm(phase: str) -> tuple:
    """Phase d on the kernels, its ticks replayed from a CUDA graph,
    checked; the same eagerly, which it must equal; the captured engine's
    requests again (``rerun``); then on the plain versions. Returns (the
    launch counts, the steady decode tok/s of an active lane)."""
    import torch

    from repro_torch.breakdown import XLSTM_MAX_LEN, xlstm_setup
    from repro_torch.kernels.api import use_context

    t0 = time.monotonic()
    model, params, prompts = xlstm_setup(SEED)
    cfg = model.cfg
    n_par = sum(t.numel() for t in _tensors(params))
    _log(f"{cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} blocks "
         f"((mLSTM, sLSTM) x {cfg.n_layers // 2}), {cfg.n_heads} heads, "
         f"vocab {cfg.vocab}; {n_par} bf16 parameters, seeded init "
         f"{time.monotonic() - t0:.1f} s; "
         f"{model.lane_state_bytes(XLSTM_MAX_LEN)['state']} B of "
         f"recurrent state a lane")
    xlstm_serve(model, params, [prompts[0][:8]], None)   # warm-up

    runs = {}
    for captured in (True, False):
        zero_counts()
        t0 = time.monotonic()
        eng, admit_s, ticks, drain = xlstm_serve(
            model, params, prompts, "h100-sxm", None if captured else False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts(phase, ("slstm_scan", "fp16_matmul"))
        res = drain.first
        for st in res:
            if st.error:
                raise AssertionError(f"[{phase}] request {st.req.uid}: "
                                     f"{st.error}")
            check_tokens(phase, st.out, cfg.vocab)
        tick_gate(phase, eng, ticks, captured)
        n_tok = sum(len(st.out) for st in res)
        decode_s = wall - admit_s
        _log(f"[{phase}] {'captured' if captured else 'eager'}: wall_s="
             f"{wall:.4f} prefill_s={admit_s:.4f} decode_s={decode_s:.4f} "
             f"tokens={n_tok} decode_tok_per_s="
             f"{(n_tok - len(prompts)) / decode_s:.1f} "
             f"decode_ticks={eng._ticks} host_syncs={eng._host_syncs}")
        runs[captured] = (eng, res, counts, ticks, drain)
    eng, res, (counts, routing), ticks, drain = runs[True]
    _, eager_res, eager_counts, *_ = runs[False]
    same_counts(phase, counts, routing, eager_counts)
    capture_check(phase, [(st.out, st.logits) for st in res],
                  [(st.out, st.logits) for st in eager_res])
    cr = eng.cache_report()
    _log(f"[{phase}] cache: state_bytes_total={cr['state_bytes_total']} "
         f"state_bytes_per_step={cr['state_bytes_per_step']} "
         f"kv_bytes_total={cr['kv_bytes_total']}")
    er = eng.energy_report()
    _log(f"[{phase}] energy_report[{er['platform']}]: " + " ".join(
        f"{k}={er[k]}" for k in ("tokens", "decode_steps", "ticks",
                                 "host_syncs", "weight_bytes",
                                 "cache_bytes_per_step",
                                 "stream_bytes_total", "latency_s",
                                 "bound", "power_w", "joules_per_token",
                                 "accel_flops_share")))
    lane_tps = rerun(phase, eng, ticks, drain)
    with use_context(plain_context()):
        ref = xlstm_serve(model, params, prompts, None)[3].first
    logits_check(phase, [(st.out, st.logits, w.out, w.logits)
                         for st, w in zip(res, ref)], cfg.vocab,
                 LOGIT_REL_TOL_XLSTM)
    return counts, lane_tps


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from repro_torch.audio.stream import synth_waveform
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import build as build_model
    from repro_torch.quantize import quantize_tree

    t_start = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log(f"gpu: {smi}")
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    built = build.build_all()
    _log(f"build: {time.monotonic() - t0:.1f} s wall for {sorted(built)} "
         f"(per library {', '.join(f'{k}={v:.1f}' for k, v in built.items())}"
         f") in {build.build_dir()}")

    rows = check_kernels()
    check_frontend_rows()

    cfg = get_config(ARCH)
    model = build_model(cfg)
    t0 = time.monotonic()
    params = model.init_values(torch.Generator().manual_seed(SEED),
                               device="cuda")
    qparams = quantize_tree(params)
    _log(f"{cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads x "
         f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.enc_layers}+{cfg.n_layers} "
         f"layers, vocab {cfg.vocab}; seeded init + Q8_0 "
         f"{time.monotonic() - t0:.1f} s")
    x = synth_waveform(30.0, seed=SEED)
    check_stream_frontend(x, cfg.d_model)

    # warm-up (CUDA context, cuBLAS/cuFFT handles); not measured
    import repro_torch
    repro_torch.transcribe(x, model=model, params=params, chunk_frames=1500,
                           max_new=4, decode_block=8)

    launches = {k: 0 for k in KERNEL_META}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    mm_fa = ("fp16_matmul", "flash_attention")
    add(run_transcribe(model, params, x, "transcribe bf16", mm_fa,
                       "bf16")[1])
    add(run_transcribe(model, qparams, x, "transcribe q8_0",
                       mm_fa + ("q8_matmul", "q8_decode_attention"),
                       "q8_0")[1])
    add(run_serve(model, qparams, "serve q8_0 4x4",
                  mm_fa + ("q8_matmul", "q8_decode_attention"), "q8_0")[2])

    # the q4_0 tier and self-speculative decoding, bf16 target weights
    draft = quantize_tree(params, tier="q4_0")
    ra, counts, a_tps = run_transcribe(model, params, x,
                                       "a: transcribe q4_0",
                                       mm_fa + ("q4_decode_attention",),
                                       "q4_0")
    add(counts)
    phase = "b: transcribe q4_0 spec_k=4"
    rb, counts, b_tps = run_transcribe(
        model, params, x, phase,
        mm_fa + ("q4_matmul", "q4_decode_attention"), "q4_0", spec_k=4,
        draft=draft)
    add(counts)
    tokens_check(phase, rb.tokens, ra.tokens, ra.logits)
    _log(f"[{phase}] against a, steady decode: {b_tps:.1f} / {a_tps:.1f} "
         f"tok/s = {b_tps / a_tps:.3f}x")
    phase = "c: serve q8_0 spec_k=4 4x4"
    res, frames, counts, c_tps, c_lane = run_serve(
        model, params, phase, mm_fa + ("q4_matmul", "q8_decode_attention"),
        "q8_0", spec_k=4, draft=draft)
    add(counts)
    # c against a plain (spec_k=0) serve of the same requests
    t0 = time.monotonic()
    eng, ticks, drain = serve(model, params, frames, "h100-sxm", "q8_0")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    plain = drain.first
    tick_gate(f"{phase}, its plain serve", eng, ticks, True)
    p_lane = rerun(f"{phase}, its plain serve", eng, ticks, drain)
    n_tok = sum(len(st.out) for st in plain)
    _log(f"[{phase}] the plain serve (spec_k=0): wall_s={wall:.4f} "
         f"tokens={n_tok} tok_per_s={n_tok / wall:.1f}; c against it: "
         f"tok/s {c_tps / (n_tok / wall):.3f}x, steady decode of a lane "
         f"{c_lane:.1f} / {p_lane:.1f} = {c_lane / p_lane:.3f}x")
    for st, w in zip(res, plain):
        tokens_check(phase, st.out, w.out, w.logits)
    _log(f"[{phase}] tokens of the 4 requests equal the plain serve's, "
         f"but for near-ties")

    # streaming: Q8_0 weights, the q8_0 cache, chunks of 16 frames
    q8_path = mm_fa + ("q8_matmul", "q8_decode_attention")
    add(run_stream(model, qparams, x, "e: transcribe stream q8_0", q8_path))
    add(run_serve(model, qparams, "f: serve q8_0 2 streams + 2 audio 4x4",
                  q8_path, "q8_0", streamed=(0, 1))[2])

    del params, qparams, draft, model
    torch.cuda.empty_cache()
    add(run_xlstm("d: serve xlstm-350m 4x4")[0])

    _log(f"chip_smoke: {time.monotonic() - t_start:.1f} s wall")
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
