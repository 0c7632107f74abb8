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
g. f's serve on a page pool (``ServeEngine(paged=True)``, pages of 8
   positions, ``enc_len=1504``): f's four requests (the one-shot ones
   with a 12-id prompt) and two more with the 25 s audio and that
   prompt, which wait for a free slot and share their audio's cross
   pages and full prompt page. Besides f's checks (the streams against
   one-shot requests of their states, the plain run) its tokens and
   logits rows must equal bit for bit those of a slot-pool twin of the
   same lengths (the decode kernels then split the same length into the
   same chunks), the prefix store must have hit, both pools drain to 0
   used pages with every table row on the scratch page and
   ``pages.check()`` clean; it prints the ``cache_report`` paging block
   at its most resident tick and the ``energy_report``;
h. b's speculative transcription (q4_0 cache, ``spec_k=4``) on pages
   (``max_len=40``, ``enc_len=1504``), held the same way to its
   slot-pool twin. In g and h every ``paged_decode_attention`` call must
   route ("accel", "cuda") and launch the q8 / q4 decode-attention
   kernel on the gathered pages;
m. the SLO gateway (``repro_torch.gateway``) over a captured engine on
   the paper's platform ``imax3-28nm/32k`` (Q8_0 weights, q8_0 cache, 4
   slots, 8 steps a tick, ``enc_len`` 1500): 16 requests of seeded
   random frame embeddings (one-shot 750 or 1500 frames, a quarter
   streamed in chunks of 250), 32 new tokens each, offered open-loop at
   20 rps (Poisson) with the default SLO mix; every request served, its
   tokens equal to ``sync_baseline``'s on the same engine (which also
   warms the tick: its capture stays outside the load), every tick of
   the load replayed with no capture, no synchronising call at its
   begin and one at its fetch, which the gateway runs on an executor
   thread. Then the same requests at 200 rps into a queue of 4 with
   shedding on: at least one shed, each under a named ``RejectCode``,
   the rest with the same tokens. It prints TTFT, end-to-end latency,
   stream lag, goodput, the energy report (J/audio-s, J/token, PDP),
   ``accel_flops_share`` beside ``coverage_cdf``'s 32 KB value, and the
   paper's Fig 4/5 table from ``platform_pdp_table`` with its two
   headline ratios;
n. the port's hot-path static checks (``repro_torch.staticcheck``) on
   the card: ``run_all`` over the reference harness's reduced engines
   (whisper-tiny.en at q8_0, q4_0, bf16, ``spec_k=2`` and paged; qwen3-4b,
   qwen3-moe-30b-a3b, zamba2-7b, xlstm-350m), then the program checks and
   SC-RECOMP over whisper-tiny.en at full width (Q8_0 weights with the
   q8_0 cache, and bf16; slot and paged; 4 slots, ``enc_len`` 1504,
   pages of 8). Every report must pass with no CPU-only waiver, every
   program's in-place, sync-free and dtype-plane verdicts hold, no traced
   program makes a synchronising CUDA call (``set_sync_debug_mode
   ("error")``) and every kernel call routes ("accel", "cuda"); it
   prints each report and one JSON line of findings and waivers a check;
i. qwen3-4b at full width and depth (36 layers, d_model 2560, 32/8
   heads of 128, d_ff 9728, vocab 151936, rope 1e6, qk-norm, untied
   head; seeded random bf16 weights drawn on the card): 4 token requests
   (prompts of 64, 128, 192 and 256 ids drawn from the seed, 32 new
   tokens each) on 4 slots through ``BatchScheduler``, 8 decode steps a
   tick, ``max_len`` 512: i1 with bf16 weights and a bf16 cache
   (``flash_attention`` at head_dim 128, ``fp16_matmul``), i2 with Q8_0
   weights (``Model.quantize``) and the q8_0 cache (``q8_matmul``,
   ``q8_decode_attention`` at GQA 4);
j. qwen3-moe-30b-a3b at full width (d_model 2048, 32/4 heads of 128, 128
   experts, top 8, expert d_ff 768, capacity factor 1.25), its first 8
   of 48 layers (the whole model is 61 GB of bf16 weights), bf16 weights
   and the q8_0 cache, the same requests; its ``routing_report`` must
   reconcile: top-8 x 8 layers x (the prefills' buckets + every slot of
   every decode step);
k. gemma2-2b at full width and depth (26 layers, d_model 2304, 8/4 heads
   of 256, d_ff 9216 with gelu, vocab 256000 tied, softcaps 50/30,
   local/global layers with window 4096), bf16 weights and cache, the
   same requests (``flash_attention`` at head_dim 256 with softcap);
l. zamba2-7b at full width and depth (81 layers: 13 segments of 5 mamba
   blocks and the shared attention block, a tail of 3 mamba blocks;
   d_model 3584, 32 heads of 112, d_ff 14336, ssm_state 64, 112 SSM
   heads of 64, conv 4, vocab 32000 untied; seeded random bf16 weights
   drawn on the card, a bf16 cache): 4 token requests with prompts of
   64, 128, 192 and 300 ids (the last over two SSD chunks of 256), 32
   new tokens each on 4 slots, 8 decode steps a tick, ``max_len`` 512
   (``flash_attention`` at head_dim 112 in the shared block's prefill,
   ``fp16_matmul`` for its products and the head; the mamba blocks are
   torch ops, as the reference's are inline jnp);
d. xlstm-350m at full width (24 blocks, d_model 1024, seeded random bf16
   weights), the same requests, ``max_len`` 320. The sLSTM recurrence
   runs on ``slstm_scan`` at prefill and decode, the untied f32 head on
   ``fp16_matmul``.
   Phases i, j, k, l and d print wall seconds, decode tok/s, ticks,
   host syncs, the ``cache_report`` and the captured run's
   ``energy_report`` on ``h100-sxm``, whose ``accel_flops_share`` must
   be above 0;
o. training on the card (``repro_torch.train``), last. The kernels
   define no backward, so the train forward runs under
   ``grad_safe_context`` and launches none:
   o1. whisper-tiny.en at full width and depth (4+4 layers, d_model 384,
   vocab 51865 tied, ``remat``) through the train launcher
   (``repro_torch.launch.train.main``, the default device): f32 weights
   drawn from a CUDA generator, AdamW (lr 1e-3, 5 warmup steps, 20 in
   all), batch 8 of 448 encoder frames and 448 tokens from the synthetic
   pipeline, ``TrainLoop`` with its signal handlers into a temporary
   directory, a checkpoint every 10 steps: 20 steps straight, then a run
   that a SIGINT at step 10 preempts, then a fresh run that resumes from
   its checkpoint to 20. The resumed losses must equal the straight
   run's within ``RESUME_RTOL``, every loss be finite, the mean of the
   last 5 below the first 5's, and the script's SIGTERM handler back in
   place after the loops;
   o2. qwen3-4b at full width, its first 4 of 36 layers (the untied f32
   head over 151,936 ids), batch 4 x 256, 8 steps of ``make_train_step``
   and no checkpoint; steps 2-8 each under the sync debug mode, with no
   synchronising call. In both no kernel's launch count moves and every
   dispatch is ``(op, accel|host, "torch")`` from the grad-safe route;
   each prints its step times (the first apart, the median of the rest,
   tokens a second), ``torch.cuda.max_memory_allocated`` and, for o1, the
   checkpoint's size and the seconds of a save of the final state and of
   a restore. Then a
   ``fp16_matmul`` dispatched on CUDA tensors must route ("accel",
   "cuda") and launch its kernel again.
p. training through the parallel layer, in a process group of one rank
   over ``nccl`` made for the phase and destroyed after it. p1: o1's
   run (whisper-tiny.en) and o2's (qwen3-4b, 4 layers), each
   ``P_STEPS`` steps on a 1x1 ``("data", "model")`` mesh (the state
   DTensors placed by ``state_shardings``), then the same steps
   unsharded from the same seed, the first state freed but for its
   parameters. The sharded step gathers one layer at a time (the
   forward's stack loops gather each layer's slice, ``remat`` gathers
   it again in the backward); on one rank its losses and parameters
   must equal the plain step's bit for bit, and its peak memory above
   the state it started from the plain one's within
   ``P_PEAK_SLACK``; each prints the largest differences, the ms a step
   of both and both peaks. p2:
   the compressed step on a data mesh of 1 against the exact one, 5
   whisper steps (the loss within ``P_COMPRESSED_LOSS`` a step, the
   relative drift below ``P_COMPRESSED_DRIFT``, residuals non-zero). p3:
   p1's sharded whisper state saved, restored onto a plain state and
   back onto the mesh, bit for bit. p4: ``launch.train`` with
   ``--devices 1 --mesh 1x1``, 4 steps on ``cuda``. No kernel launches
   (the grad-safe route); the ``fp16_matmul`` check follows again.
q. the dry-run (``repro_torch.launch.dryrun``, ``repro_torch.analysis``)
   against the card. q1: p1's two runs, the plain step and the step on
   the one-rank 1x1 mesh, each traced on fake ``cuda`` tensors
   (``dryrun.trace_train``: FlopCounterMode, MemTracker) and run for
   real: the traced FLOPs must equal ``FlopCounterMode``'s count of the
   real step exactly, and the traced peak above the state lie within
   [``Q1_PEAK_LO``, ``Q1_PEAK_HI``] of ``torch.cuda.max_memory_allocated``'s
   rise over the step; it prints the roofline's bound on ``h100-sxm``
   beside the median of ``Q1_TIMED`` steps. q2: ``dryrun_cell(Q2_ARCH,
   "train_4k")`` on fake ``cuda`` tensors over a ``fake`` group of 256
   ranks (the 16x16 production mesh, 4 microbatches), in a process of
   its own beside a second that traces the same cell with the whole
   parameter tree gathered at the forward's start (the step before the
   per-layer gather), both started before q1 and read after it: both
   must end ``status: ok``; it prints a rank's peak under each and
   whether it is under 80 GB and under the card's memory.
r. the meshed serving steps (``make_prefill_step`` / ``make_decode_step``
   with a mesh: a rank runs its rows, the cache stays sharded, a decode
   step gathers one layer's cache at a time). r1, in a one-rank group:
   qwen3-4b at full width and depth (bf16 weights drawn on the card) and
   whisper-tiny.en (1500 frames a lane), each 4 lanes, a prefill and 8
   greedy decode steps on the 1x1 mesh against the unmeshed steps from
   the same weights: logits and ids bit-equal, the cache DTensors in
   their ``cache_shardings`` placements with their storages kept by
   every step, each step's rise of ``torch.cuda.max_memory_allocated``
   within one layer's cache and weights plus ``R_PEAK_SLACK`` of the
   unmeshed step's, and ``fp16_matmul`` / ``flash_attention`` launched
   as often as unmeshed (a one-rank mesh splits nothing). r2:
   ``launch.dryrun`` of the ``R2_CELLS`` on fake ``cuda`` over the 16x16
   fake group (qwen3-4b decode_32k and prefill_32k, qwen3-moe-30b-a3b
   prefill_32k and decode_32k, mixtral-8x7b, zamba2-7b, gemma2-2b and
   xlstm-350m decode_32k, llava-next-34b decode_32k and prefill_32k),
   where the serving steps split the heads, the MLP's columns, the
   vocabulary, the MoE experts (``experts`` or ``expert_ff`` form), the
   mamba blocks (``inner`` form) and, where the heads do not divide
   ``model`` (``R2_ROW_TP``), every product along d_model
   (``param_embed``) over ``model``, a prefill's attention on the
   rank's block of the query positions (context parallelism); ten
   processes started before r1:
   each ends ``ok``, a rank's peak under its bound and the card's
   memory, the traced FLOPs under its bound times the model FLOPs, and
   an ``R2_ROW_TP`` cell takes no attention, MLP, head or xLSTM unit
   whole and holds no op on a global cache leaf's shape, and an
   ``R2_HEAD_DIM`` cell gathers no ``wk``, ``wv``, ``bk`` or ``bv``
   whole; it prints the peaks, the FLOPs, the roofline's compute,
   memory and collective terms, the collective bytes by kind, the flash
   attention's share of a rank's FLOPs, the units split, the leaves
   gathered whole, and the figures before the split.
   r3: one qwen3-4b layer at full width split over 16
   ranks of ``model`` (head_dim form) and over 8 (heads form), shard by
   shard in one process (a thread a shard, the collectives met in
   memory) through the kernels: the prefill of 4 lanes x 256 ids, a
   decode step, the MLP, the embedding and the head against the unsplit
   layer (``run_r3``: the row-parallel f32 sums within ``R3_REL``; in
   the head_dim form the fused Q/K/V product of the rank's heads and
   head_dim slice, one ``fp16_matmul`` of (2560, 384), the exact
   product rounded once but at near-ties, and the cache slices within
   ``R3_REL`` of the unsplit K/V path run on the shards' products);
   ``fp16_matmul`` and ``flash_attention`` must launch. r4: r1's
   qwen3-4b (36 layers) split over 4 ranks of ``model`` shard by shard
   on the card, as a four-card 1x4 mesh splits it, against the unmeshed
   steps (``run_r4``: logits within ``LOGIT_REL_TOL_DECODER``, ids equal
   but at near-ties); then qwen3-moe-30b-a3b at 8 layers (32 experts a
   shard, ``LOGIT_REL_TOL_MOE``) and zamba2-7b at ``R4_HYBRID_LAYERS``
   (28 SSM heads a shard, ``LOGIT_REL_TOL_HYBRID``) the same way, every
   MoE and mamba unit split, then ``R4_SPLIT``: xlstm-350m (24 blocks)
   over 4 in its heads forms, whisper-tiny.en over 4 and gemma2-2b
   (``R4_GEMMA_LAYERS``) over 16 in the ``param_embed`` form, each within
   ``LOGIT_REL_TOL_DECODER``, each shard's prefill attention its block
   of the query positions at its ``q_offset``; it prints each step's
   gap. r5: one MoE
   layer or mamba block at full width shard by shard (``R5_SPLITS``:
   qwen3-moe-30b-a3b's experts over 16 and 4, mixtral-8x7b's FFN columns
   over 16, a zamba2-7b mamba block over 16), a prefill of 4 lanes x 256
   positions and a decode step (``run_r5``: the all-reduced sums within
   ``R3_REL`` of the exact sum of the shards' inputs, outputs within
   ``R3_OUT_REL``, the mamba state within ``BF16_REL``, the routing
   counts equal, the unsplit gather-sum combine within ``F32_REL`` of
   its f64 sum), then ``R5_UNITS`` (``run_r5_units``: a llava-next-34b
   layer and gemma2-2b's local and global layers over 16, xlstm-350m's
   mLSTM and sLSTM blocks over 16 and 4; the sums within ``R3_REL`` of
   exact, outputs within ``R3_OUT_REL``, KV slices and states within
   ``BF16_REL``, each shard's prefill attention its block of the query
   positions at its ``q_offset``).

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
a streamed encoder chunk of 16 rows and its tail of 12. For phases i, j
and k: flash attention at head_dim 128 (qwen3-4b's and qwen3-moe's
prefill buckets, GQA 4 and 8, ragged, the KV split) and 256 (gemma2-2b's
prefill with softcap 50 on a local and a global layer, a window of 128
that binds, ragged, the KV split); for phase l flash attention at head_dim
112 (zamba2-7b's prefill at its prompt lengths, the ragged S = 300, the
KV split, masked rows); ``q8_decode_attention`` at head_dim
128 with GQA 4 and 8 over 512 positions; the dense and Q8_0 GEMMs at
qwen3-4b's decode (4 lanes) and prefill (256 rows) shapes and its head;
the dense GEMM at zamba2-7b's shared block (4 lanes, 300 rows) and head.

The f32 cases of phase 2 (the frontend GEMMs, the xLSTM head at a
decode step and at prefill of every prompt position, the sLSTM
recurrence) hold each output to f32 summation order (``F32_REL`` of the
largest value); the sLSTM cases include a decode step from a random
non-initial state, with R in f32 and in bf16, and a case with saturated
gates, and each counts the outputs that differ from the plain version
bit for bit (``bit_diff``, at most ``SLSTM_TIES``). The Q4_0 GEMM's
cases print the plan each shape took.
The shard shapes of phase r3 (qwen3-4b's products and prefill attention
split over 16 or 8 ranks of ``model``) are cases of the dense GEMM and
flash attention too, and so are a context-parallel prefill's blocks of
query positions at their ``q_offset`` (``FA_OFFSET``: far from 0, near
0 with KV splits that read no tile, past Skv, and r4's and r5's blocks).

Every phase of 3, 4, 5, e, f, g, h, i, j, k, l and d (not m, whose
tick is captured before its load, nor n, which checks one capture per
tick size itself) runs twice with the same engine settings:
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
``("accel", "cuda")`` (in phase l, zamba2-7b's MLP down, K = 14336, is
over the h100-sxm budget of the paper's ACCEL/HOST law, so the law
decides it ``"host"``; it must still run on the kernel, ``("host",
"cuda")``), and the captured run's counts (its replays add
what the capture pass recorded) must equal the eager run's. The engine
of each phase keeps the logits
row each token was chosen from; the same phase is then run again on the
plain versions (forced, on the card) and the two runs' rows must agree
within ``LOGIT_REL_TOL`` of the largest logit (``LOGIT_REL_TOL_Q4`` with a
q4_0 cache, ``LOGIT_REL_TOL_DECODER`` in phases i and k,
``LOGIT_REL_TOL_MOE`` in j, ``LOGIT_REL_TOL_HYBRID`` in l,
``LOGIT_REL_TOL_XLSTM`` in d), request by
request, up to
the first token where the runs differ, which must be a near-tie
(``TIE_MARGIN``). Token lists held against each other (b against a, c
against the plain serve) follow the same near-tie rule. Any failure
raises and exits non-zero. Before its result lines the script requires
that no process it started is still running (the kernel build and
``nvidia-smi`` wait for their own, and the build kills an unfinished
``nvcc`` with its compiler stages when it raises); on any exit, SIGTERM
included, it kills whatever is left below it, and after the last line it
leaves at once. The last line is the JSON result; the line
before it the card's name and power limit, the one before that the
kernels.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import signal
import subprocess
import sys
import threading
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
# phases i and k: the decoder-only models' kernel-vs-plain logits over the
# largest logit: 0.0184-0.0218 measured on an NVIDIA H100 80GB HBM3 at
# 700 W (26-36 layers carry a bf16 rounding that tips early further than
# Whisper's 4), ~2.3x headroom
LOGIT_REL_TOL_DECODER = 0.05
# phase j: the same for qwen3-moe-30b-a3b, 0.116 measured (same card):
# its top-8 router and the binding capacity of its prefill (20 tokens an
# expert at S=256) are discontinuous, so a last-bit difference in a
# hidden state can send a token to another expert, or out of one
LOGIT_REL_TOL_MOE = 0.25
# phase l: the same for zamba2-7b, 0.0712 measured on an NVIDIA H100 80GB
# HBM3 at 700 W, ~2.1x headroom. The two runs differ only in the shared
# block (flash attention, fp16_matmul) and the head, but the 68 mamba
# blocks carry a difference on through 81 layers, each adding its own
# tipped bf16 roundings (~4e-3 of the stream a block, on the CPU)
LOGIT_REL_TOL_HYBRID = 0.15
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
#: the qwen3-4b products of phases i1 (fp16_matmul) and i2 (q8_matmul):
#: a decode step of 4 lanes and the prefill of the longest prompt
QWEN3_GEMMS = tuple(
    (f"qwen3-4b {what}", m, k, n, None)
    for what, m, k, n in (
        ("decode wo, 4 lanes", 4, 4096, 2560),
        ("decode MLP up / gate, 4 lanes", 4, 2560, 9728),
        ("decode MLP down, 4 lanes", 4, 9728, 2560),
        ("prefill wo, S=256", 256, 4096, 2560),
        ("prefill MLP up / gate, S=256", 256, 2560, 9728),
        ("prefill MLP down, S=256", 256, 9728, 2560)))
#: the zamba2-7b shared block's products of phase l (fp16_matmul): a
#: decode step of 4 lanes and the prefill of the longest prompt
ZAMBA2_GEMMS = tuple(
    (f"zamba2-7b {what}", m, k, n, None)
    for what, m, k, n in (
        ("decode wo, 4 lanes", 4, 3584, 3584),
        ("decode MLP up / gate, 4 lanes", 4, 3584, 14336),
        ("decode MLP down, 4 lanes", 4, 14336, 3584),
        ("prefill wo, S=300", 300, 3584, 3584),
        ("prefill MLP up / gate, S=300", 300, 3584, 14336),
        ("prefill MLP down, S=300", 300, 14336, 3584)))
#: phase 2's flash attention at a q_offset (query row i at position off +
#: i): a context-parallel prefill's blocks, (label, B, Sq, Skv, H, Hkv, D,
#: causal, window, softcap, off): a causal block at D = 128 far from 0;
#: gemma2-2b's window and softcap at D = 256; the KV split near 0, where
#: the block's causal range is 3 KV tiles and 21 of its 24 splits read
#: none; rows past Skv (a short last block's padding); the blocks r4 and
#: r5 run (whisper-tiny.en over 4; llava-next-34b and gemma2-2b over 16,
#: 4 lanes of 256 positions, the last rank's block)
FA_OFFSET = (
    ("llava-next-34b prefill block, causal", 1, 256, 1024, 56, 8, 128,
     True, None, None, 768),
    ("gemma2-2b prefill block, binding window", 1, 256, 1024, 8, 4, 256,
     True, 128, 50.0, 768),
    ("split KV, causal block near 0", 1, 16, 1500, 6, 6, 64, True, None,
     None, 16),
    ("padded block past Skv, causal", 2, 8, 24, 6, 2, 64, True, None, None,
     20),
    ("whisper encoder block, tp=4, bidirectional", 1, 375, 1500, 6, 6, 64,
     False, None, None, 375),
    ("whisper decoder prefill block, tp=4, causal", 4, 4, 16, 6, 6, 64,
     True, None, None, 12),
    ("llava-next-34b shard block, tp=16, causal", 4, 16, 256, 56, 8, 128,
     True, None, None, 240),
    ("gemma2-2b shard block, tp=16, local layer", 4, 16, 256, 8, 4, 256,
     True, 4096, 50.0, 240))


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
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import plain as pa_plain
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
            ("frontend projection (f32)", 1500, 80, 384, torch.float32),
            *QWEN3_GEMMS, *ZAMBA2_GEMMS):
        dt = dt or bf
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
    # the qwen3-4b head (phase i1): bf16 activations @ the bf16 lm_head
    # over the padded vocab, to f32, at a decode step of 4 lanes
    k, n = 2560, 153600
    x, wb = randn((4, k)), randn((k, n), bf, k ** -0.5)
    y = torch.empty((4, n), dtype=torch.float32, device=dev)
    mm.append((f"qwen3-4b head, decode, 4 lanes (bf16 x, bf16 w, f32 out) "
               f"(4,{k})@({k},{n})",
               lambda x=x, wb=wb: mm_ops.fp16_matmul(x, wb,
                                                     out_dtype=torch.float32),
               lambda x=x, wb=wb: mm_plain.fp16_matmul(x, wb, torch.float32),
               lambda x=x, w=wb: torch.matmul(x, w).float(),
               _nbytes(x, wb, y), 2.0 * 4 * n * k, "bf16", BF16_REL))
    # phase r3's shard shapes: qwen3-4b split over 16 (8 for the heads
    # form's wo) ranks of ``model``, 4 lanes of 256 ids in prefill and a
    # decode step: the head_dim form's fused product of the rank's query
    # heads beside its head_dim slice of wk and wv and the column-parallel
    # MLP up / gate (bf16 out), the row-parallel wo and MLP down (f32
    # partials), the head's vocabulary columns (f32 x, the bf16 weight as
    # stored, f32 out)
    f32 = torch.float32
    for label, m, k, n, xdt, odt in (
            ("prefill Q | K | V, head_dim form, tp=16", 1024, 2560, 384, bf,
             bf),
            ("decode Q | K | V, 4 lanes, head_dim form, tp=16", 4, 2560, 384,
             bf, bf),
            ("prefill wo, tp=16", 1024, 256, 2560, bf, f32),
            ("prefill wo, tp=8", 1024, 512, 2560, bf, f32),
            ("prefill MLP up / gate, tp=16", 1024, 2560, 608, bf, bf),
            ("prefill MLP down, tp=16", 1024, 608, 2560, bf, f32),
            ("decode wo, 4 lanes, tp=16", 4, 256, 2560, bf, f32),
            ("decode MLP up / gate, 4 lanes, tp=16", 4, 2560, 608, bf, bf),
            ("decode MLP down, 4 lanes, tp=16", 4, 608, 2560, bf, f32),
            ("head, 4 lanes, tp=16", 4, 2560, 9600, f32, f32)):
        x, wb = randn((m, k), xdt), randn((k, n), bf, k ** -0.5)
        y = torch.empty((m, n), dtype=odt, device=dev)
        mm.append((f"qwen3-4b shard: {label} ({m},{k})@({k},{n}) "
                   f"{str(xdt)[6:]} x, {str(odt)[6:]} out",
                   lambda x=x, wb=wb, o=odt: mm_ops.fp16_matmul(
                       x, wb, out_dtype=o),
                   lambda x=x, wb=wb, o=odt: mm_plain.fp16_matmul(x, wb, o),
                   lambda x=x, w=wb.to(xdt), o=odt: torch.matmul(x, w).to(o),
                   _nbytes(x, wb, y), 2.0 * m * n * k,
                   "bf16" if xdt == bf else "f32",
                   BF16_REL if xdt == bf else F32_REL))
    # phase r5's serve_row_tp shard shapes: the row-parallel products of
    # llava-next-34b and gemma2-2b split along d_model over 16 ranks of
    # ``model`` (their f32 partials, 4 lanes of 256 ids and a decode
    # step), and xlstm-350m's mLSTM Q/K/V over its inner channels
    for label, m, k, n in (
            ("llava-next-34b Q/K/V, tp=16", 1024, 448, 9216),
            ("llava-next-34b MLP down, tp=16", 1024, 1280, 7168),
            ("gemma2-2b MLP up, decode, tp=16", 4, 144, 9216),
            ("xlstm-350m mLSTM Q/K/V, decode, tp=16", 4, 128, 6144)):
        x, wb = randn((m, k), bf), randn((k, n), bf, k ** -0.5)
        y = torch.empty((m, n), dtype=f32, device=dev)
        mm.append((f"serve_row_tp shard: {label} ({m},{k})@({k},{n}) "
                   f"bf16 x, float32 out",
                   lambda x=x, wb=wb: mm_ops.fp16_matmul(x, wb,
                                                         out_dtype=f32),
                   lambda x=x, wb=wb: mm_plain.fp16_matmul(x, wb, f32),
                   lambda x=x, w=wb: torch.matmul(x, w).to(f32),
                   _nbytes(x, wb, y), 2.0 * m * n * k, "bf16", BF16_REL))
    # the zamba2-7b head (phase l): the untied head multiplies f32
    # activations by the bf16 lm_head as stored, over the padded vocab
    k, n = 3584, 32768
    x, wb = randn((4, k), torch.float32), randn((k, n), bf, k ** -0.5)
    y = torch.empty((4, n), dtype=torch.float32, device=dev)
    mm.append((f"zamba2-7b head, decode, 4 lanes (f32 x, bf16 w) (4,{k})@"
               f"({k},{n})",
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
            ("decode MLP down, 4 lanes (f32 x)", 4, 1536, 384, f32),
            *QWEN3_GEMMS):
        dt = dt or bf
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

    def pairs(sq, skv, causal, window, off=0):
        """(unmasked (query, key) pairs: the products the masks leave;
        the keys some row keeps: those the function must read), query row
        i at position off + i."""
        qp = np.arange(sq)[:, None] + off
        kp = np.arange(skv)[None, :]
        keep = np.ones((sq, skv), bool)
        if causal:
            keep &= kp <= qp
        if window:
            keep &= (qp - kp) < window
        return float(keep.sum()), int(keep.any(0).sum())

    # the main path's three (B*H = 6, D = 64); then the KV-split path:
    # few queries against the 1500 encoder frames, a ragged Skv whose
    # last tile holds 1 key (65) or 29 (1501), GQA, a window (with rows
    # whose every key is masked: Sq > Skv), softcap and D = 32. Each also
    # with V only on the last 3 keys a row sees: the output is what the
    # ragged last KV tile holds, so dropping or mis-masking it fails.
    # Then a context-parallel prefill's blocks at their q_offset (FA_OFFSET)
    fa = []
    for label, b, sq, skv, h, hkv, d, causal, window, softcap, off in [
            (*c, 0) for c in (
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
             5.0),
            # D = 128: qwen3-4b's prefill at its buckets (GQA 4) and a
            # ragged S, qwen3-moe's (GQA 8), the KV split
            ("qwen3-4b prefill, causal", 1, 256, 256, 32, 8, 128, True,
             None, None),
            ("qwen3-4b prefill, causal, ragged", 1, 200, 200, 32, 8, 128,
             True, None, None),
            ("qwen3-4b prefill, causal", 1, 64, 64, 32, 8, 128, True, None,
             None),
            ("qwen3-moe prefill, causal", 1, 256, 256, 32, 4, 128, True,
             None, None),
            # phase r3's shards of qwen3-4b's prefill, 4 lanes: 16 ranks
            # (2 query heads reading 1 KV head), 8 (4 reading 1)
            ("qwen3-4b shard prefill, tp=16, causal", 4, 256, 256, 2, 1,
             128, True, None, None),
            ("qwen3-4b shard prefill, tp=8, causal", 4, 256, 256, 4, 1,
             128, True, None, None),
            ("split KV, GQA", 1, 33, 1500, 32, 8, 128, False, None, None),
            ("split KV, ragged", 2, 40, 65, 4, 2, 128, False, None, None),
            # D = 256: gemma2-2b's prefill with its softcap of 50, on a
            # local layer (window 4096, as served) and a global one, and
            # with a window of 128 that binds; ragged; the KV split
            ("gemma2-2b prefill, local layer", 1, 256, 256, 8, 4, 256, True,
             4096, 50.0),
            ("gemma2-2b prefill, global layer", 1, 256, 256, 8, 4, 256,
             True, None, 50.0),
            ("gemma2-2b prefill, binding window", 1, 256, 256, 8, 4, 256,
             True, 128, 50.0),
            ("gemma2-2b prefill, binding window, ragged", 1, 200, 200, 8, 4,
             256, True, 128, 50.0),
            ("split KV, GQA", 1, 33, 1500, 8, 4, 256, False, None, None),
            ("split KV, causal window, masked rows", 1, 200, 65, 2, 1, 256,
             True, 16, None),
            # D = 112: zamba2-7b's shared block (32 heads, MHA) at its
            # prompts' lengths, the ragged 300, the KV split, masked rows
            ("zamba2-7b prefill, causal", 1, 64, 64, 32, 32, 112, True,
             None, None),
            ("zamba2-7b prefill, causal", 1, 192, 192, 32, 32, 112, True,
             None, None),
            ("zamba2-7b prefill, causal, ragged", 1, 300, 300, 32, 32, 112,
             True, None, None),
            ("split KV", 1, 33, 1500, 32, 32, 112, False, None, None),
            ("split KV, ragged", 2, 40, 65, 4, 4, 112, False, None, None),
            ("split KV, causal window, masked rows", 1, 200, 65, 2, 1, 112,
             True, 16, None))] + list(FA_OFFSET):
        q, k, v = randn((b, sq, h, d)), randn((b, skv, hkv, d)), \
            randn((b, skv, hkv, d))
        kw = dict(causal=causal, window=window, softcap=softcap)
        # the bound reads q, writes the output, and reads K and V at only
        # the keys the masks leave to some row
        n_pairs, n_keys = pairs(sq, skv, causal, window, off)
        moved = _nbytes(q, q, k[:, :n_keys], v[:, :n_keys])
        if off:
            kw["q_offset"] = off
        # the yardstick takes GQA's K/V repeated to H heads beforehand
        plain_only = window or softcap
        # causal: the last keys a row sees are those before min(off + Sq,
        # Skv); the keys after them keep V and must weigh 0
        vtail = v.clone()
        vtail[:, :(min(off + sq, skv) if causal else skv) - 3] = 0
        for tag, vv in (("", v), (", V on the last 3 keys seen", vtail)):
            lib = None
            if not (tag or plain_only):
                qt, kt, vt = (t.repeat_interleave(h // t.shape[2], dim=2)
                              .transpose(1, 2).contiguous()
                              for t in (q, k, v))
                # an offset block's causal mask is not SDPA's top-left
                # one: the library call takes it as a boolean mask
                mask = None if not (causal and off) else (
                    torch.arange(skv, device=dev)[None, :]
                    <= torch.arange(off, off + sq, device=dev)[:, None])
                lib = (lambda qt=qt, kt=kt, vt=vt, m=mask,
                       c=causal and not off:
                       F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=m,
                                                      is_causal=c))
            opts = "".join(f" {n}={kw[n]}" for n in ("window", "softcap",
                                                     "q_offset")
                           if kw.get(n))
            fa.append((f"{label} B*H={b * h} Hkv={hkv} Sq={sq} Skv={skv} "
                       f"D={d}{' causal' if causal else ''}{opts}{tag}",
                       lambda q=q, k=k, v=vv, kw=kw:
                           fa_ops.flash_attention(q, k, v, **kw),
                       lambda q=q, k=k, v=vv, kw=kw:
                           fa_plain.flash_attention(q, k, v, **kw),
                       lib, moved, 4.0 * n_pairs * b * h * d, "bf16",
                       BF16_REL))
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

    def paged(t, b, s_len):
        """A one-layer stacked plane (1, B, S, H, .) laid out in a page
        pool (B * S / 8 + 1 pages of 8, page 0 the scratch page, each
        lane's pages shuffled over the pool) and the (B, S / 8) table."""
        n = b * s_len // 8
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(
            s_len)).to(dev) + 1
        pool = torch.zeros((n + 1, 8) + t.shape[3:], dtype=t.dtype,
                           device=dev)
        pool[perm] = t[0].reshape((n, 8) + t.shape[3:])
        return pool, perm.reshape(b, s_len // 8)

    def decode_cases(tier, specs, pages=False):
        """Decode attention over one layer of a stacked cache of
        ``tier``; each spec: (label, lanes, queries, S, lengths (B,) or
        (B, Q)) and optionally (H, Hkv, D), else Whisper's (6, 6, 64).
        Each case also runs with V only on the 3 positions
        before each lane's first length and a large poison past it. With
        ``pages`` the cache lies in a page pool and the call is
        ``paged_decode_attention``'s CUDA route (the gather, then this
        kernel) against its plain version."""
        quant = quantize_q8_0 if tier == "q8_0" else quantize_q4_0
        deq = dequantize_q8_0 if tier == "q8_0" else dequantize_q4_0
        kern, plain = ((qa_ops.q8_decode_attention_cache,
                        qa_plain.q8_decode_attention_cache)
                       if tier == "q8_0" else
                       (q4a_ops.q4_decode_attention_cache,
                        q4a_plain.q4_decode_attention_cache))
        code_b = 1.0 if tier == "q8_0" else 0.5
        out = []
        for label, b, nq, s_len, lens, *heads in specs:
            h, hkv, d = heads[0] if heads else (6, 6, 64)
            # bytes of one cached position of one KV head: K and V codes,
            # scales
            row_b = 2 * d * code_b + 2 * 2 * d // 32
            # the stacked layers of a long cache: one is enough
            L = 4 if s_len <= 4096 and not pages else 1
            ln = torch.tensor(lens, device=dev)
            ln2 = ln if ln.dim() == 2 else ln[:, None].expand(b, nq)
            first = ln2[:, 0].tolist()
            kf = randn((L, b, s_len, hkv, d), torch.float32)
            vf = randn((L, b, s_len, hkv, d), torch.float32)
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
            read = float(ln2.max(dim=1).values.sum()) * hkv * row_b
            ops = 4.0 * float(ln2.sum()) * h * d
            for tag, vsrc in (("", vf), (", V on the last 3 before length",
                                         vtail)):
                vt = quant(vsrc, axis=-1)
                lib = None
                if pages:
                    c = "q" if tier == "q8_0" else "p"
                    (kq, table), (ks, _), (vq, _), (vs, _) = (
                        paged(x, b, s_len)
                        for x in (kt.q, kt.scale, vt.q, vt.scale))
                    kc, vc = {c: kq, "s": ks}, {c: vq, "s": vs}
                    out.append((
                        f"{label} S={s_len} Q={nq} lens={lens} H={h} "
                        f"Hkv={hkv} D={d}{tag}",
                        lambda q=q, kc=kc, vc=vc, tb=table, ln=ln:
                            pa_ops.paged_decode_attention(q, kc, vc, tb,
                                                          ln),
                        lambda q=q, kc=kc, vc=vc, tb=table, ln=ln:
                            pa_plain.paged_decode_attention(q, kc, vc, tb,
                                                            ln),
                        None, read + _nbytes(q, q, ln, table), ops, "bf16",
                        BF16_REL))
                    continue
                if not tag:
                    # yardstick: SDPA over the pre-dequantized bf16 layer,
                    # its KV heads repeated to H beforehand
                    kd, vd = (deq(t, bf)[0].repeat_interleave(h // hkv, dim=2)
                              .transpose(1, 2).contiguous()
                              for t in (kt, vt))
                    lib = (lambda qh=qh, kd=kd, vd=vd, mask=mask:
                           F.scaled_dot_product_attention(qh, kd, vd,
                                                          attn_mask=mask))
                out.append((f"{label} S={s_len} Q={nq} lens={lens} H={h} "
                            f"Hkv={hkv} D={d}{tag}",
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
        ("cross verify, 4 lanes x 4 queries", 4, 4, 1500, cross),
        # phases i2 and j: the decoder-only self decode at max_len 512,
        # 4 lanes of GQA 4 (qwen3-4b) and 8 (qwen3-moe-30b-a3b), D = 128
        ("qwen3-4b self decode, 4 lanes", 4, 1, 512, [97, 161, 225, 289],
         (32, 8, 128)),
        ("qwen3-moe self decode, 4 lanes", 4, 1, 512, [97, 161, 225, 289],
         (32, 4, 128)),
        ("qwen3-4b self decode, 4 lanes, lengths 1 and 512", 4, 1, 512,
         [1, 512, 0, 300], (32, 8, 128))) + edges)
    # phase g: the same kernel on the pages its lanes gather (1504
    # positions of cross block, 64 of self)
    cases["q8_decode_attention"] += decode_cases("q8_0", (
        ("paged cross decode, 4 lanes", 4, 1, 1504, cross),
        ("paged self verify, 4 lanes x 4 queries", 4, 4, 64, verify)),
        pages=True)
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
    # phase h: one lane's gathered pages (1504 cross, 40 self positions)
    cases["q4_decode_attention"] += decode_cases("q4_0", (
        ("paged cross decode, 1 lane", 1, 1, 1504, [1500]),
        ("paged self verify, 1 lane x 4 queries", 1, 4, 40,
         [[30, 31, 32, 33]])), pages=True)

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


def read_counts(phase: str, expect: tuple, host_ok: tuple = ()) -> tuple:
    """Launch counts and routing counters of this phase; every expected
    kernel launched (an expected op without a kernel of its own, such as
    ``paged_decode_attention``, was dispatched) and every dispatched call
    went ("accel", "cuda"). An op of ``host_ok`` may also go ("host",
    "cuda"): the paper's ACCEL/HOST law put the call's footprint over the
    platform's budget (phase l's MLP down, K = 14336), and it ran on the
    kernel all the same; each such call in the trace is checked to be
    over the budget."""
    from repro_torch.kernels.api import dispatch_counters, dispatch_trace
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    routing = dispatch_counters()
    _log(f"[{phase}] launches {counts}")
    _log(f"[{phase}] dispatch {dict(routing)}")
    for k in expect:
        if k in counts and counts[k] <= 0:
            raise AssertionError(f"[{phase}] kernel {k} never launched")
        if k not in counts and not any(key[0] == k for key in routing):
            raise AssertionError(f"[{phase}] op {k} never dispatched")
    bad = {key: n for key, n in routing.items()
           if key[1:] != ("accel", "cuda")
           and not (key[0] in host_ok and key[1:] == ("host", "cuda"))}
    if bad:
        raise AssertionError(f"[{phase}] calls not routed accel/cuda: {bad}")
    host = [r for r in dispatch_trace() if r.decision == "host"]
    if host:
        if any(r.footprint <= r.budget or r.backend != "cuda" for r in host):
            raise AssertionError(f"[{phase}] a HOST call within the budget "
                                 f"or off the kernel")
        _log(f"[{phase}] the law's HOST calls, run on the kernel: "
             f"{sum(n for k, n in routing.items() if k[1] == 'host')} "
             f"(K in {sorted({r.spec.k for r in host})}: footprint "
             f"{max(r.footprint for r in host)} B > budget "
             f"{host[0].budget} B)")
    if not routing:
        raise AssertionError(f"[{phase}] no dispatched call at all")
    return counts, routing


_SYNCS = {"in_step": None, "sites": []}


@contextlib.contextmanager
def sync_debug():
    """Count every synchronising CUDA call made inside a watched tick
    (``watch_ticks``, ``watch_split_ticks``) on the thread that runs it,
    with ``torch.cuda``'s sync debug mode, and note the innermost frame
    of the port that made it."""
    import traceback
    import warnings

    import torch

    def show(message, category, filename, lineno, *_a, **_k):
        if _SYNCS["in_step"] == threading.get_ident() \
                and "synchroniz" in str(message):
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
        _SYNCS["in_step"] = threading.get_ident()
        t0 = time.monotonic()
        try:
            return step(k)
        finally:
            _SYNCS["in_step"] = None
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
                  what=("captured", "eager"), exact: bool = False) -> None:
    """The captured run against the eager one (``cuda_graph=False``) with
    the same engine settings (or the two runs ``what`` names): per
    request the same tokens, and the same logits rows bit for bit or
    within ``CAPTURE_REL_TOL`` of the largest logit (bit for bit only,
    ``exact``). ``got`` / ``want``: (tokens, logits rows) per request."""
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
    if err > CAPTURE_REL_TOL * top or (exact and unequal):
        raise AssertionError(f"[{phase}] {what[0]} logits off the {what[1]} "
                             f"run's by {err / top:.4g} of the largest "
                             f"({unequal} rows not bit-equal)")


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
                   cache_dtype: str, spec_k: int = 0, draft=None,
                   engine_kw=None):
    """One transcription through the engine ``transcribe`` would build
    (or, with ``spec_k``, a reused speculative engine), keeping its
    logits, its ticks replayed from a CUDA graph; the same eagerly
    (``cuda_graph=False``), which it must equal; the captured engine's
    transcription again (``steady``); then the same on the plain
    versions. ``engine_kw`` overrides the engine's settings (phase h's
    pages). Returns (result, launch counts, steady decode tok/s)."""
    import torch

    import repro_torch
    from repro_torch.kernels.api import use_context
    from repro_torch.serving.engine import ServeEngine

    def engine(platform, cuda_graph=None):
        kw = dict(n_slots=1, max_len=1 + MAX_NEW + 2 + max(spec_k - 1, 0),
                  enc_len=1500, cache_dtype=cache_dtype, decode_block=8,
                  platform=platform, keep_logits=True, spec_k=spec_k,
                  draft_params=draft, cuda_graph=cuda_graph)
        eng = ServeEngine(model, params, **{**kw, **(engine_kw or {})})
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
          spec_k: int = 0, draft=None, cuda_graph=None, streamed=(),
          prompts=None, engine_kw=None):
    """An audio request a frame tensor of ``frames`` on 4 slots through
    ``BatchScheduler``, 8 decode steps a tick; those of the indices
    ``streamed`` stream their frames in chunks of ``STREAM_CHUNK``, one a
    tick. ``prompts``: each request's prompt (default ``[1]``);
    ``engine_kw`` overrides the engine's settings. A paged engine keeps,
    in ``paging_peak``, its ``cache_report`` paging block at the tick
    start with the most resident bytes of the first run. Returns the
    engine, the watched ticks and ``drain``, which serves the requests
    (uids from its argument on) and returns their states; it has run
    once, for uids from 0."""
    from repro_torch.audio.stream import chunk_list
    from repro_torch.serving.engine import (AudioRequest, ServeEngine,
                                            StreamingAudioRequest)
    from repro_torch.serving.scheduler import BatchScheduler
    kw = dict(n_slots=4, max_len=64, enc_len=1500, cache_dtype=cache_dtype,
              decode_block=8, platform=platform, keep_logits=True,
              spec_k=spec_k, draft_params=draft, cuda_graph=cuda_graph)
    eng = ServeEngine(model, params, **{**kw, **(engine_kw or {})})
    ticks = watch_ticks(eng)
    if eng.paged:
        eng.paging_peak = {"resident_kv_bytes": -1}
        tick = eng.step

        def step(k=None):
            rep = eng.cache_report()["paging"]
            if rep["resident_kv_bytes"] > eng.paging_peak[
                    "resident_kv_bytes"]:
                eng.paging_peak = rep
            return tick(k)
        step.__wrapped__ = tick
        eng.step = step
    sched = BatchScheduler(eng, max_admit_per_tick=4)

    def drain(uid0: int = 0) -> list:
        for i, fr in enumerate(frames):
            kw = dict(uid=uid0 + i, tokens=prompts[i] if prompts else [1],
                      max_new=MAX_NEW, eos_id=-1)
            sched.submit(StreamingAudioRequest(
                chunks=chunk_list(fr, STREAM_CHUNK), **kw) if i in streamed
                else AudioRequest(enc_frames=fr, **kw))
        with sync_debug():
            sched.run_until_drained(max_ticks=256)
        return [sched.results[uid0 + i] for i in range(len(frames))]

    drain.first = drain()
    if eng.paged:
        eng.step = step.__wrapped__
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
              spec_k: int = 0, draft=None, streamed=(),
              waves=(0, 1, 2, 3), prompts=None, engine_kw=None):
    """The serve phase on the kernels, its ticks replayed from a CUDA
    graph, checked; the same eagerly, which it must equal; the captured
    engine's requests again (``rerun``); with ``streamed`` requests, the
    streams' final tokens against one-shot requests of the same chunks'
    states (``stream_gate``); then on the plain versions. A request's
    audio is the wave of ``SERVE_SECONDS`` its entry of ``waves`` names
    (one frame tensor a wave); ``prompts`` and ``engine_kw`` go to
    ``serve``. Returns (the request states, the frames, launch counts,
    tok/s, the steady decode tok/s of an active lane, the captured
    engine)."""
    import torch

    from repro_torch.audio.features import audio_frames
    from repro_torch.audio.stream import synth_waveform
    from repro_torch.kernels.api import use_context
    audio = [synth_waveform(s, seed=i + 1)
             for i, s in enumerate(SERVE_SECONDS)]
    runs = {}
    for captured in (True, False):
        zero_counts()
        t0 = time.monotonic()
        by_wave = [audio_frames(w, model.cfg.d_model, device="cuda")
                   for w in audio]
        frames = [by_wave[i] for i in waves]
        eng, ticks, drain = serve(model, params, frames, "h100-sxm",
                                  cache_dtype, spec_k, draft,
                                  None if captured else False, streamed,
                                  prompts, engine_kw)
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
                    draft, streamed=streamed, prompts=prompts,
                    engine_kw=engine_kw)[2].first
    logits_check(phase, [(st.out, st.logits, w.out, w.logits)
                         for st, w in zip(res, ref)], model.cfg.vocab,
                 _logit_tol(cache_dtype))
    return res, frames, counts, tps, lane_tps, eng


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
# Phases g and h: the paged engine
# ----------------------------------------------------------------------------

PAGE_SIZE = 8
# the slot pool's enc_len of phases 3-f (1500) rounded up to whole pages;
# each phase's slot-pool twin takes it too, so the decode kernels split
# the same gathered length into the same chunks (decode.chunk_plan)
PAGED_ENC_LEN = 1504
# phase g: the 30 s and 20 s streams, the 10 s and 25 s one-shot
# requests, and two more with the 25 s audio (SERVE_SECONDS's indices)
G_WAVES = (0, 1, 2, 3, 3, 3)
# the one-shot requests' prompt: a full page of 8 ids, which lanes with
# the same audio share, and 4 in a private page
G_PROMPT = list(range(1, 13))


def paging_gate(phase: str, eng, shared: bool) -> None:
    """The paged engine after its runs: both pools drained to 0 used
    pages, every table row back on the scratch page, ``check()`` clean,
    and with ``shared`` prefix hits in both stores. Prints the
    ``cache_report`` paging block at the most resident tick of its first
    run (where ``serve`` kept it) and the ``energy_report``."""
    rep = eng.paging_report()
    hits = (rep["prefix"]["self"]["hits"], rep["prefix"]["cross"]["hits"])
    eng.pages.check()
    rows = [t.device() for t in (eng.pages.self_table,
                                 eng.pages.cross_table)]
    if rep["self"]["pages_in_use"] or rep["cross"]["pages_in_use"] \
            or rep["resident_lanes"] or any(bool(t.any()) for t in rows) \
            or (shared and not all(hits)):
        raise AssertionError(f"[{phase}] pools not drained or no prefix "
                             f"hit: {rep}")
    peak = getattr(eng, "paging_peak", None)
    if peak is not None:
        _log(f"[{phase}] cache_report paging at the first run's most "
             f"resident tick: "
             + " ".join(f"{k}={peak[k]}" for k in (
                 "resident_kv_bytes", "self_page_bytes", "cross_page_bytes",
                 "resident_lanes"))
             + f" self={peak['self']} cross={peak['cross']}; the two "
               f"pools hold {eng.cache_report()['kv_bytes_total']} B (the "
               f"slot pool's bytes and a scratch page each)")
    _log(f"[{phase}] paging after the runs: prefix {rep['prefix']}, "
         f"used pages {rep['self']['pages_in_use']} / "
         f"{rep['cross']['pages_in_use']}, check() clean, headroom "
         f"{eng.page_headroom()}")
    er = eng.energy_report()
    _log(f"[{phase}] energy_report[{er['platform']}]: " + " ".join(
        f"{k}={er[k]}" for k in ("tokens", "decode_steps", "ticks",
                                 "host_syncs", "cache_bytes_per_step",
                                 "stream_bytes_total", "latency_s",
                                 "joules_per_token")))


def run_paged_serve(model, params, phase: str, expect: tuple,
                    f_lane: float) -> dict:
    """Phase g: the serve of phase f on pages (6 requests: f's two
    streams and two one-shot requests, and two more one-shot requests
    with the 25 s audio and the same 12-id prompt, which wait for a free
    slot and are admitted while the graph replays), checked as
    ``run_serve`` checks; then the same requests on a slot-pool twin of
    the same lengths, whose tokens and logits rows the paged run must
    equal bit for bit, and its steady decode beside the paged one's (and
    ``f_lane``, phase f's). Returns the launch counts."""
    prompts = [[1], [1]] + [G_PROMPT] * 4
    kw = dict(enc_len=PAGED_ENC_LEN)
    res, frames, counts, _, lane, eng = run_serve(
        model, params, phase, expect, "q8_0", streamed=(0, 1),
        waves=G_WAVES, prompts=prompts,
        engine_kw=dict(kw, paged=True, page_size=PAGE_SIZE))
    paging_gate(phase, eng, shared=True)
    twin, ticks, drain = serve(model, params, frames, "h100-sxm", "q8_0",
                               streamed=(0, 1), prompts=prompts,
                               engine_kw=kw)
    capture_check(phase, [(st.out, st.logits) for st in res],
                  [(st.out, st.logits) for st in drain.first],
                  ("paged", "slot-pool twin"), exact=True)
    slot_lane = rerun(f"{phase}, its slot-pool twin", twin, ticks, drain)
    _log(f"[{phase}] steady decode of a lane: paged {lane:.1f}, slot-pool "
         f"twin {slot_lane:.1f} tok/s = {lane / slot_lane:.3f}x; phase f "
         f"{f_lane:.1f}")
    return counts


def run_paged_spec(model, params, x, phase: str, expect: tuple, draft,
                   b_tps: float) -> dict:
    """Phase h: phase b's speculative transcription (q4_0 cache,
    ``spec_k=4``, the Q4_0 draft) on pages, checked as ``run_transcribe``
    checks; then on a slot-pool twin of the same lengths, whose tokens and
    logits rows it must equal bit for bit, and whose steady decode goes
    beside its own (and ``b_tps``, phase b's). Returns the launch
    counts."""
    import torch

    import repro_torch
    from repro_torch.serving.engine import ServeEngine
    kw = dict(max_len=40, enc_len=PAGED_ENC_LEN)   # 38 positions, paged
    r, counts, tps = run_transcribe(
        model, params, x, phase, expect, "q4_0", spec_k=4, draft=draft,
        engine_kw=dict(kw, paged=True, page_size=PAGE_SIZE))
    paging_gate(phase, r.engine, shared=False)
    eng = ServeEngine(model, params, n_slots=1, cache_dtype="q4_0",
                      decode_block=8, platform="h100-sxm", keep_logits=True,
                      spec_k=4, draft_params=draft, **kw)
    ticks = watch_ticks(eng)

    def go():
        with sync_debug():
            t = repro_torch.transcribe(x, model=model, params=params,
                                       engine=eng, chunk_frames=1500,
                                       max_new=MAX_NEW)
        torch.cuda.synchronize()
        return t
    twin = go()
    capture_check(phase, [(r.tokens, r.logits)],
                  [(twin.tokens, twin.logits)], ("paged", "slot-pool twin"),
                  exact=True)
    _, slot_tps, _ = steady(f"{phase}, its slot-pool twin", eng, ticks, go)
    _log(f"[{phase}] steady decode: paged {tps:.1f}, slot-pool twin "
         f"{slot_tps:.1f} tok/s = {tps / slot_tps:.3f}x; phase b "
         f"{b_tps:.1f}")
    return counts


# ----------------------------------------------------------------------------
# Phase m: the SLO gateway over the captured tick
# ----------------------------------------------------------------------------

M_PLATFORM = "imax3-28nm/32k"
# the load of phase m (``repro_torch.gateway.LoadSpec``), and its overload
M_SPEC = dict(rate_rps=20.0, n_requests=16, seed=SEED, stream_fraction=0.25,
              max_new=MAX_NEW, oneshot_frames=(750, 1500),
              stream_chunk_frames=250, stream_chunks=(2, 3))
M_OVERLOAD = dict(M_SPEC, rate_rps=200.0)


def watch_split_ticks(eng) -> list:
    """Wrap ``eng.step_begin`` and ``eng.step_fetch``, the gateway's split
    tick (its fetch runs on an executor thread): for each tick, the
    synchronising CUDA calls of its begin and of its fetch, each counted
    on the thread that ran it, whether it replayed a graph without a
    capture, and its host seconds from begin to fetched."""
    ticks, begin, fetch = [], eng.step_begin, eng.step_fetch

    def watched_begin(k=None):
        n0, r0, c0 = len(_SYNCS["sites"]), eng.replays, eng.captures
        _SYNCS["in_step"] = threading.get_ident()
        try:
            pending = begin(k)
        finally:
            _SYNCS["in_step"] = None
        if pending is not None:
            pending.watch = (len(_SYNCS["sites"]) - n0,
                             eng.replays > r0 and eng.captures == c0,
                             time.monotonic())
        return pending

    def watched_fetch(pending):
        n0 = len(_SYNCS["sites"])
        _SYNCS["in_step"] = threading.get_ident()
        try:
            return fetch(pending)
        finally:
            _SYNCS["in_step"] = None
            b_syncs, replayed, t0 = pending.watch
            ticks.append((b_syncs, len(_SYNCS["sites"]) - n0, replayed,
                          time.monotonic() - t0))

    eng.step_begin, eng.step_fetch = watched_begin, watched_fetch
    return ticks


def gateway_ticks_gate(phase: str, eng, ticks: list, before: tuple):
    """Every tick of the load: no synchronising call at its begin, one at
    its fetch, one host fetch; replayed from the graph captured before
    the load, with no capture during it. ``before``: the engine's ticks,
    host fetches, captures and replays before the load."""
    t0, s0, c0, r0 = before
    if not ticks or len(ticks) != eng._ticks - t0 \
            or eng._host_syncs - s0 != len(ticks) \
            or any(t[0] != 0 or t[1] != 1 or not t[2] for t in ticks) \
            or eng.captures != c0 or eng.replays - r0 != len(ticks):
        raise AssertionError(
            f"[{phase}] ticks (begin syncs, fetch syncs, replayed, s): "
            f"{ticks[:8]}... ({len(ticks)} ticks), captures {c0} -> "
            f"{eng.captures}, replays {eng.replays - r0}, sites "
            f"{_SYNCS['sites'][-8:]}: expected one sync a tick at the "
            f"fetch and every tick replayed")
    _log(f"[{phase}] {len(ticks)} ticks, every one replayed (captures "
         f"{c0} -> {eng.captures}); synchronising calls a tick: begin "
         f"{sorted({t[0] for t in ticks})}, fetch (executor thread) "
         f"{sorted({t[1] for t in ticks})}; begin-to-fetched ms "
         f"min/median/max {1e3 * min(t[3] for t in ticks):.3f}/"
         f"{1e3 * sorted(t[3] for t in ticks)[len(ticks) // 2]:.3f}/"
         f"{1e3 * max(t[3] for t in ticks):.3f}")


def gateway_load(phase: str, eng, spec: dict, **kw):
    """One ``run_load`` of ``spec`` through a fresh ``Gateway`` over the
    engine, its split ticks and their syncs watched. Returns (the
    results, the summary, the watched ticks)."""
    import torch

    from repro_torch.gateway import LoadSpec, run_load
    before = (eng._ticks, eng._host_syncs, eng.captures, eng.replays)
    ticks = watch_split_ticks(eng)
    try:
        with sync_debug():
            results, summary, _ = run_load(eng, LoadSpec(**spec), **kw)
        torch.cuda.synchronize()
    finally:
        del eng.step_begin, eng.step_fetch
    gateway_ticks_gate(phase, eng, ticks, before)
    return results, summary


def _static_gate(phase: str, label: str, rep) -> dict:
    """One phase-n report: ``report.ok`` with no CPU-only waiver applied,
    every program's donation / sync-free / dtype-plane verdict true,
    every SC-SYNC finding clean without a waiver (no synchronising CUDA
    call in any traced program). Prints the human summary; returns the
    findings and waivers per check."""
    _log(f"[{phase}] {label}:\n{rep.human()}")
    cpu_only = [f.subject for f in rep.findings
                if f.data.get("waiver_device")]
    bad = {name: v for name, v in rep.function_verdicts().items()
           if not all(v.values())}
    syncs = [f.subject for f in rep.findings
             if f.check == "SC-SYNC" and not f.ok]
    if not rep.ok or cpu_only or bad or syncs:
        raise AssertionError(f"[{phase}] {label}: failed "
                             f"{rep.failed_checks()}, CPU-only waivers "
                             f"{cpu_only}, verdicts {bad}, syncs {syncs}")
    return {check: {"findings": len(fs), "waived": sum(f.waived for f in fs)}
            for check, fs in sorted(rep.by_check().items())}


def run_staticcheck(phase: str, expect: tuple) -> dict:
    """Phase n: the port's static checks (``repro_torch.staticcheck``)
    on the card. ``run_all`` over the reference harness's engines (the
    reduced whisper-tiny.en at q8_0, q4_0, bf16, ``spec_k=2`` and paged;
    qwen3-4b, qwen3-moe-30b-a3b, zamba2-7b, xlstm-350m at bf16 and the
    MoE at q8_0), then the program checks and SC-RECOMP over
    whisper-tiny.en at full width (Q8_0 weights with the q8_0 cache, and
    bf16; slot and paged; 4 slots, ``enc_len`` 1504, pages of 8). Every
    traced program runs under ``set_sync_debug_mode("error")``; each
    report must pass ``_static_gate``, and every kernel call route
    ("accel", "cuda"). Prints the summaries and one JSON line of the
    findings and waivers per check; returns the launch counts."""
    import torch

    from repro_torch.staticcheck import StaticcheckConfig, run_all
    from repro_torch.staticcheck.harness import build_full_engines
    from repro_torch.staticcheck.report import Report
    from repro_torch.staticcheck.run import apply_waivers, check_engines

    config = StaticcheckConfig.load()
    zero_counts()
    t0 = time.monotonic()
    reduced = run_all(config=config, device="cuda")
    torch.cuda.synchronize()
    t_reduced = time.monotonic() - t0
    slot, paged = build_full_engines("cuda")
    full = Report(apply_waivers(check_engines(slot, paged), config, "cuda"))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts, _ = read_counts(phase, expect)
    summary = {"reduced": _static_gate(phase, "reduced harness", reduced),
               "full_width": _static_gate(phase, "whisper-tiny.en at full "
                                          "width", full),
               "wall_s": round(wall, 3), "reduced_s": round(t_reduced, 3)}
    _log(json.dumps({"staticcheck": summary}))
    return counts


def run_gateway(model, qparams, phase: str, expect: tuple) -> dict:
    """Phase m: ``repro_torch.gateway`` over a captured engine
    (whisper-tiny.en, Q8_0 weights, q8_0 cache, 4 slots, 8 steps a tick,
    on ``imax3-28nm/32k``): ``M_SPEC``'s 16 requests (a quarter streamed
    in chunks of 250 frames) offered open-loop at 20 rps with the default
    SLO mix, every request served and its tokens equal to
    ``sync_baseline``'s on the same engine; then ``M_OVERLOAD`` (200
    rps, a queue of 4, shedding on), which must shed under named codes
    and serve the rest with the same tokens. Every call of the load runs
    on the card's kernels as ("accel", "cuda"): at whisper-tiny.en's
    widths every footprint is within the 32,768 B budget (the largest,
    the MLP down at K = 1536, is 30,736 B). Prints the serving summary,
    the energy report on the platform and the paper's Fig 4/5 table.
    Returns the launch counts of the 20 rps load."""
    import torch

    from repro_torch.core.energy import calibrate_imax, platform_pdp_table
    from repro_torch.core.footprint import coverage_cdf
    from repro_torch.core.workload import WHISPER_TINY, whisper_workload
    from repro_torch.gateway import LoadSpec, sync_baseline, synth_load
    from repro_torch.platforms import paper
    from repro_torch.serving.engine import RejectCode, ServeEngine

    t_phase = time.monotonic()
    eng = ServeEngine(model, qparams, n_slots=4, max_len=64, enc_len=1500,
                      cache_dtype="q8_0", decode_block=8,
                      platform=M_PLATFORM)
    descs = synth_load(model.cfg, LoadSpec(**M_SPEC))
    t0 = time.monotonic()
    baseline = sync_baseline(eng, descs)      # the oracle; warms the tick
    torch.cuda.synchronize()
    _log(f"[{phase}] warm-up and oracle: sync_baseline of {len(descs)} "
         f"requests ({sum(d.kind == 'stream' for d in descs)} streamed) in "
         f"{time.monotonic() - t0:.4f} s, {eng._ticks} ticks, "
         f"{eng.captures} capture and {eng.replays} replays of the "
         f"{eng.decode_block}-step tick: the capture is outside the "
         f"measured window, so no TTFT below includes it")
    if eng.captures != 1:
        raise AssertionError(f"[{phase}] {eng.captures} captures in the "
                             f"warm-up: expected one")

    def same_tokens(results, which: str) -> None:
        for d, r in zip(descs, results):
            if r.ok and list(r.tokens) != baseline[d.idx]:
                raise AssertionError(f"[{phase}] {which}: request {d.idx} "
                                     f"({d.kind}) tokens {r.tokens} differ "
                                     f"from sync_baseline's "
                                     f"{baseline[d.idx]}")
            if r.ok:
                check_tokens(phase, list(r.tokens), model.cfg.vocab)

    zero_counts()
    eng.reset_serve_stats()
    results, summary = gateway_load(phase, eng, M_SPEC,
                                    shed_on_submit=False)
    counts, _ = read_counts(phase, expect)
    bad = [(r.uid, r.code, r.error) for r in results if not r.ok]
    if bad or summary["completed"] != len(descs):
        raise AssertionError(f"[{phase}] requests not served: {bad}")
    same_tokens(results, "20 rps")
    t, e, lag = summary["ttft_s"], summary["e2e_s"], summary["stream_lag_s"]
    _log(f"[{phase}] 20 rps: {summary['completed']}/{summary['requests']} "
         f"completed, {summary['completed_in_deadline']} in deadline, "
         f"{summary['shed_total']} shed, in {summary['wall_s']:.4f} s over "
         f"{summary['ticks']} ticks; tokens equal sync_baseline's for "
         f"every request")
    _log(f"[{phase}] 20 rps: TTFT p50/p99 {t['p50']:.4f}/{t['p99']:.4f} s, "
         f"e2e p50/p99 {e['p50']:.4f}/{e['p99']:.4f} s, stream lag mean/"
         f"p99 {lag['mean']:.4f}/{lag['p99']:.4f} s ({lag['chunks']} "
         f"chunks), queue wait p99 {summary['queue_wait_s']['p99']:.4f} "
         f"s, goodput {summary['goodput_rps']:.3f} req/s (throughput "
         f"{summary['throughput_rps']:.3f}), {summary['tokens']} tokens, "
         f"{summary['audio_s']:.1f} s of audio")
    # the served weights are Q8_0: the platform's q8_0 power curve
    er = eng.energy_report("q8_0")
    _log(f"[{phase}] energy[{er['platform']}]: "
         f"{er['pdp_j'] / summary['audio_s']:.6e} J/audio-s, "
         f"{er['joules_per_token']:.6e} J/token, PDP {er['pdp_j']:.6e} J "
         f"(power {er['power_w']} W, {er['bound']}-bound, "
         f"{er['decode_steps']} decode steps, {er['tokens']} tokens)")
    cov = {r.limit_bytes: r for r in coverage_cdf(
        whisper_workload(WHISPER_TINY, dtype="q8_0"), "optimized")}
    _log(f"[{phase}] accel_flops_share={er['accel_flops_share']:.6f} over "
         f"the engine's last {er['trace_records']} dispatch records; "
         f"coverage_cdf of whisper_workload(tiny, q8_0) at 32 KB: "
         f"{cov[32 * 1024].coverage_pct:.2f} % of calls, "
         f"{cov[32 * 1024].flops_pct:.2f} % of FLOPs (the paper's Table "
         f"I: {paper.PAPER_TABLE1[32 * 1024][3]:.2f} % of calls)")
    if not er["accel_flops_share"] > 0:
        raise AssertionError(f"[{phase}] accel_flops_share 0")

    over = synth_load(model.cfg, LoadSpec(**M_OVERLOAD))
    if any(a.tokens != b.tokens or a.kind != b.kind
           or not all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                      for x, y in zip(a.chunks, b.chunks))
           for a, b in zip(over, descs)):
        raise AssertionError(f"[{phase}] the overload's requests differ "
                             f"from the load's")
    zero_counts()
    results, summary = gateway_load(f"{phase}, overload", eng, M_OVERLOAD,
                                    queue_limit=4, shed_on_submit=True)
    read_counts(f"{phase}, overload", expect)
    shed = [r for r in results if not r.ok]
    if not shed or any(not isinstance(r.code, RejectCode) for r in shed):
        raise AssertionError(f"[{phase}] overload: shed "
                             f"{[(r.uid, r.code) for r in shed]}: expected "
                             f"at least one, each under a RejectCode")
    same_tokens(results, "200 rps")
    t, e = summary["ttft_s"], summary["e2e_s"]
    _log(f"[{phase}] 200 rps, queue 4: {summary['completed']}/"
         f"{summary['requests']} completed ({summary['completed_in_deadline']}"
         f" in deadline), {summary['shed_total']} shed {summary['shed']} in "
         f"{summary['wall_s']:.4f} s; TTFT p50/p99 {t['p50']:.4f}/"
         f"{t['p99']:.4f} s, e2e p50/p99 {e['p50']:.4f}/{e['p99']:.4f} s, "
         f"goodput {summary['goodput_rps']:.3f} req/s; the completed "
         f"requests' tokens equal sync_baseline's")
    del eng
    gc.collect()

    t0 = time.monotonic()
    w16 = whisper_workload(WHISPER_TINY, dtype="f16")
    w8 = whisper_workload(WHISPER_TINY, dtype="q8_0")
    calib = calibrate_imax(w16, w8)
    rows = platform_pdp_table(w16, w8, calib)
    dt = time.monotonic() - t0
    for r in rows:
        _log(f"[{phase}] Fig 4/5 ({r['source']}): {r['device']} "
             f"{r['kernel']}: latency {r['latency_s']:.4f} s, power "
             f"{r['power_w']:.4f} W, PDP {r['pdp_j']:.4f} J"
             + (f" (paper {r['pdp_paper_j']} J)"
                if r.get("pdp_paper_j") is not None else "")
             + (f", phase-wise {r['pdp_phase_j']:.4f} J"
                if "pdp_phase_j" in r else ""))
    by = {(r["device"], r["kernel"]): r for r in rows}
    imax = by[("imax3-28nm", "q8_0")]["pdp_paper_j"]
    _log(f"[{phase}] the paper's headline (Q8_0 PDP): "
         f"{by[('jetson-agx-orin', 'q8_0')]['pdp_paper_j'] / imax:.4f}x "
         f"Jetson AGX Orin, {by[('rtx-4090', 'q8_0')]['pdp_paper_j'] / imax:.4f}"
         f"x RTX 4090; the model's Q8_0 latency "
         f"{by[('imax3-28nm(model)', 'q8_0')]['latency_s']:.4f} s against "
         f"the paper's 11.1 s; residuals {calib.residuals}; "
         f"{1e3 * dt:.2f} ms on the host")
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")
    return counts


# ----------------------------------------------------------------------------
# Phases i, j, k and d: decoder-only models served at full width
# ----------------------------------------------------------------------------

def token_serve(model, params, prompts, platform, max_len: int,
                cache_dtype: str = "bf16", cuda_graph=None):
    """The prompts as token requests on 4 slots through
    ``BatchScheduler``, 8 decode steps a tick, keeping the logits rows.
    Returns (engine, seconds spent in admission, the watched ticks,
    ``drain``: as ``serve``'s, run once for uids 0-3)."""
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.scheduler import BatchScheduler
    eng = ServeEngine(model, params, n_slots=4, max_len=max_len,
                      cache_dtype=cache_dtype, decode_block=8,
                      platform=platform, keep_logits=True,
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


def routing_gate(phase: str, eng, prompts) -> None:
    """An MoE engine's ``routing_report`` after its first run: every
    executed top-k assignment counted once, the prefills' whole buckets
    and every slot of every decode step (parked lanes included), per MoE
    layer, as the reference's ``test_moe_routing_counters_reconcile``
    counts them."""
    from repro_torch.serving.engine import _bucket
    rep = eng.routing_report()
    prefill = sum(min(_bucket(len(p)), eng.max_len) for p in prompts)
    decode = eng.n_slots * eng._decode_steps
    want = (prefill + decode) * rep["moe_layers"] * rep["top_k"]
    per_lane = rep["per_lane"]
    _log(f"[{phase}] routing_report: n_experts={rep['n_experts']} "
         f"top_k={rep['top_k']} moe_layers={rep['moe_layers']} "
         f"executed_assignments={rep['executed_assignments']} (want "
         f"({prefill} prefill + {decode} decode positions) x "
         f"{rep['moe_layers']} x {rep['top_k']} = {want}) per-lane "
         f"{[sum(r) for r in per_lane]} experts hit "
         f"{sum(1 for n in rep['per_expert'] if n)} of {rep['n_experts']}")
    if rep["executed_assignments"] != want \
            or sum(map(sum, per_lane)) != want \
            or min(min(r) for r in per_lane) < 0:
        raise AssertionError(f"[{phase}] routing counters do not reconcile")


def run_tokens(phase: str, model, params, prompts, max_len: int,
               expect: tuple, cache_dtype: str = "bf16",
               tol: float = LOGIT_REL_TOL, host_ok: tuple = ()) -> tuple:
    """A token-request phase (d, i, j, k) on the kernels, its ticks
    replayed from a CUDA graph, checked; the same eagerly, which it must
    equal; the captured engine's requests again (``rerun``); then on the
    plain versions, whose logits rows it must agree with within ``tol``.
    Returns (the launch counts, the steady decode tok/s of an active
    lane)."""
    import torch

    from repro_torch.kernels.api import use_context

    cfg = model.cfg
    token_serve(model, params, [prompts[0][:8]], None, max_len,
                cache_dtype)                                # warm-up
    runs = {}
    for captured in (True, False):
        zero_counts()
        t0 = time.monotonic()
        eng, admit_s, ticks, drain = token_serve(
            model, params, prompts, "h100-sxm", max_len, cache_dtype,
            None if captured else False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts(phase, expect, host_ok)
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
        if eng.spec.moe_experts:
            routing_gate(phase, eng, prompts)
        if captured:
            # before the eager twin's zero_counts clears the dispatch log
            # that holds this engine's records
            er = eng.energy_report()
        runs[captured] = (eng, res, counts, ticks, drain)
    eng, res, (counts, routing), ticks, drain = runs[True]
    _, eager_res, eager_counts, *_ = runs[False]
    same_counts(phase, counts, routing, eager_counts)
    capture_check(phase, [(st.out, st.logits) for st in res],
                  [(st.out, st.logits) for st in eager_res])
    cr = eng.cache_report()
    _log(f"[{phase}] cache_report: " + " ".join(
        f"{k}={cr[k]}" for k in ("cache_dtype", "state_kinds",
                                 "kv_bytes_total", "state_bytes_total",
                                 "state_bytes_per_step", "bytes_per_step",
                                 "traffic_ratio_vs_bf16")))
    _log(f"[{phase}] energy_report[{er['platform']}]: " + " ".join(
        f"{k}={er[k]}" for k in ("tokens", "decode_steps", "ticks",
                                 "host_syncs", "weight_bytes",
                                 "cache_bytes_per_step",
                                 "stream_bytes_total", "latency_s",
                                 "bound", "power_w", "joules_per_token",
                                 "accel_flops_share")))
    if not er["accel_flops_share"] > 0:
        raise AssertionError(f"[{phase}] accel_flops_share "
                             f"{er['accel_flops_share']}: the report found "
                             f"none of the engine's dispatch records")
    lane_tps = rerun(phase, eng, ticks, drain)
    del eng, runs, drain      # the engines' pools and graphs (cyclic)
    gc.collect()
    with use_context(plain_context()):
        ref = token_serve(model, params, prompts, None, max_len,
                          cache_dtype)[3].first
    logits_check(phase, [(st.out, st.logits, w.out, w.logits)
                         for st, w in zip(res, ref)], cfg.vocab, tol)
    return counts, lane_tps


def run_xlstm(phase: str) -> tuple:
    """Phase d: xlstm-350m at full width (``run_tokens``)."""
    from repro_torch.breakdown import XLSTM_MAX_LEN, xlstm_setup

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
    return run_tokens(phase, model, params, prompts, XLSTM_MAX_LEN,
                      ("slstm_scan", "fp16_matmul"),
                      tol=LOGIT_REL_TOL_XLSTM)


def decoder_model(arch: str):
    """The model of phase i, j, k or l (``breakdown.decoder_setup``),
    described."""
    from repro_torch.breakdown import DECODER_MAX_LEN, decoder_setup

    t0 = time.monotonic()
    model, params, prompts = decoder_setup(arch, SEED)
    cfg = model.cfg
    n_par = sum(t.numel() for t in _tensors(params))
    _log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
         f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff "
         f"{cfg.d_ff}" + (f" ({cfg.n_experts} experts, top {cfg.top_k})"
                         if cfg.is_moe else "")
         + (f", mamba: ssm_state {cfg.ssm_state}, SSM heads of "
            f"{cfg.ssm_head_dim}, conv {cfg.ssm_conv}, shared attention "
            f"every {cfg.attn_every}" if cfg.family == "hybrid" else "")
         + f", vocab {cfg.vocab}; {n_par} bf16 parameters, seeded init on "
           f"the card {time.monotonic() - t0:.1f} s; "
           f"{model.lane_state_bytes(DECODER_MAX_LEN)['total']} B of "
           f"bf16 lane state at max_len {DECODER_MAX_LEN}")
    return model, params, prompts


def run_decoder(phase: str, model, params, prompts, expect: tuple,
                cache_dtype: str) -> tuple:
    """Phase i, j, k or l (``run_tokens`` at ``DECODER_MAX_LEN``)."""
    from repro_torch.breakdown import DECODER_MAX_LEN
    hybrid = model.cfg.family == "hybrid"
    tol = LOGIT_REL_TOL_MOE if model.cfg.is_moe else \
        LOGIT_REL_TOL_HYBRID if hybrid else LOGIT_REL_TOL_DECODER
    # zamba2-7b's MLP down (K = 14336) is over the h100-sxm budget of the
    # ACCEL/HOST law (227 KB: K <= 11621 for a GEMM's footprint)
    return run_tokens(phase, model, params, prompts, DECODER_MAX_LEN,
                      expect, cache_dtype, tol,
                      ("fp16_matmul",) if hybrid else ())


# ----------------------------------------------------------------------------
# Phase o: training on the card
# ----------------------------------------------------------------------------

# the models, batches and AdamW settings are train.setup.TRAIN_SETUP's
O1_SAVE_EVERY = 10
RESUME_RTOL = 1e-6


def train_gate(phase: str) -> dict:
    """Since ``zero_counts``: no kernel launched, and every dispatched
    call was routed ``(op, accel|host, "torch")`` on the grad-safe
    route. Returns the routing counters."""
    from repro_torch.kernels.api import dispatch_counters, dispatch_trace
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    routing = dispatch_counters()
    _log(f"[{phase}] launches {counts}")
    _log(f"[{phase}] dispatch {dict(routing)}")
    if any(counts.values()):
        raise AssertionError(f"[{phase}] a kernel launched in training")
    bad = {k: n for k, n in routing.items()
           if k[1] not in ("accel", "host") or k[2] != "torch"}
    if bad or not routing:
        raise AssertionError(f"[{phase}] calls off the grad-safe route: "
                             f"{bad or 'none dispatched'}")
    if any(r.tag != "grad_safe" for r in dispatch_trace()):
        raise AssertionError(f"[{phase}] a dispatch outside grad_safe")
    return routing


def step_times(phase: str, first: float, times: list, tokens: int,
               first_is: str = "first") -> None:
    """Log the step times: the first apart, the median of the rest,
    tokens a second at that median."""
    import statistics
    med = statistics.median(times)
    _log(f"[{phase}] {len(times) + 1} steps: {first_is} {first:.4f} s, "
         f"median of the rest {med * 1e3:.2f} ms a step ({tokens} tokens "
         f"a step, {tokens / med:.1f} tok/s), the rest "
         f"{[round(t * 1e3, 2) for t in times]} ms")


def run_train_o1(phase: str) -> None:
    """Phase o1: whisper-tiny.en at full width and depth trained by the
    launcher (``repro_torch.launch.train.main``) 20 steps straight, then
    20 steps preempted by a SIGINT at step 10, then resumed from that
    checkpoint to 20; the resumed losses must equal the straight run's."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.store import (CheckpointManager,
                                              restore_checkpoint)
    from repro_torch.launch import train as train_cli
    from repro_torch.train.setup import TRAIN_SETUP, preset

    t_phase = time.monotonic()
    p = TRAIN_SETUP[ARCH]
    steps = p["steps"]
    argv = ["--arch", ARCH, "--batch", str(p["batch"]), "--seq",
            str(p["seq"]), "--lr", str(p["lr"]), "--warmup",
            str(p["warmup"]), "--steps", str(steps), "--save-every",
            str(O1_SAVE_EVERY), "--seed", str(SEED)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_o1_")
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        marks = [time.monotonic()]
        _log(f"[{phase}] python -m repro_torch.launch.train "
             f"{' '.join(argv)} --ckpt DIR")
        straight = train_cli.main(
            argv + ["--ckpt", os.path.join(tmp, "a")],
            on_step=lambda step, loss: marks.append(time.monotonic()))
        peak = torch.cuda.max_memory_allocated()

        def preempt(step, loss):
            if step == steps // 2:
                signal.raise_signal(signal.SIGINT)
        first = train_cli.main(argv + ["--ckpt", os.path.join(tmp, "b")],
                               on_step=preempt)
        resumed = train_cli.main(argv + ["--ckpt", os.path.join(tmp, "b")])
        train_gate(phase)
        if signal.getsignal(signal.SIGTERM) is not _terminated:
            raise AssertionError(f"[{phase}] the loop left its SIGTERM "
                                 f"handler installed")
        losses = straight.losses
        _log(f"[{phase}] losses {[round(x, 5) for x in losses]}")
        if not all(np.isfinite(losses)) or len(losses) != steps:
            raise AssertionError(f"[{phase}] losses {losses}")
        if not first.preempted or first.final_step != steps // 2:
            raise AssertionError(f"[{phase}] the SIGINT did not stop the "
                                 f"run at {steps // 2}: {first}")
        again = first.losses + resumed.losses
        if resumed.final_step != steps or len(again) != steps:
            raise AssertionError(f"[{phase}] resumed run: {len(again)} "
                                 f"losses to step {resumed.final_step}")
        rel = max(abs(a / b - 1) for a, b in zip(again, losses))
        _log(f"[{phase}] preempted at {steps // 2} + resumed against "
             f"{steps} straight: losses max rel diff {rel:.3g}")
        if rel > RESUME_RTOL:
            raise AssertionError(f"[{phase}] resumed losses off the "
                                 f"straight run's by {rel:.3g}")
        head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
        _log(f"[{phase}] mean loss of the first 5 steps {head:.5f}, of the "
             f"last 5 {tail:.5f}")
        if not tail < head:
            raise AssertionError(f"[{phase}] the loss did not fall")
        times = [b - a for a, b in zip(marks[1:], marks[2:])]
        step_times(phase, marks[1] - marks[0], times,
                   p["batch"] * (p["seq"] // 2),
                   first_is="set-up and first step")

        # the two runs' last checkpoints, and a save of the final state
        _, like, _, _ = preset(ARCH, SEED)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, _ = restore_checkpoint(os.path.join(tmp, "a"), like)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
        resumed_state, _ = restore_checkpoint(os.path.join(tmp, "b"), like)
        pdiff = max(float((a - b).abs().max()) for a, b in zip(
            _tensors(state["params"]), _tensors(resumed_state["params"])))
        _log(f"[{phase}] final params, resumed against straight: max abs "
             f"diff {pdiff:.3g}")
        mgr = CheckpointManager(os.path.join(tmp, "sync"))
        t0 = time.monotonic()
        mgr.save(steps, state)
        copy_s = time.monotonic() - t0
        mgr.wait()
        write_s = time.monotonic() - t0
        path = os.path.join(tmp, "sync", os.listdir(mgr.root)[0])
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        _log(f"[{phase}] peak memory {peak} B "
             f"(torch.cuda.max_memory_allocated, the straight run); "
             f"checkpoint {nbytes} B: the save's copy to the host "
             f"{copy_s:.4f} s (what a step waits for), the save to its end "
             f"{write_s:.4f} s, a restore onto the card {restore_s:.4f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")


def run_train_o2(phase: str) -> None:
    """Phase o2: qwen3-4b at full width, its first 4 of 36 layers (the
    untied f32 head over 151,936 ids), 8 steps of ``make_train_step``
    with no checkpoint; each step after the first is watched with the
    sync debug mode, and must make no synchronising call."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.train.setup import preset
    from repro_torch.train.step import make_train_step

    torch.cuda.reset_peak_memory_stats()
    t0 = t_phase = time.monotonic()
    model, state, ds, opt_cfg = preset("qwen3-4b", SEED)
    torch.cuda.synchronize()
    cfg = model.cfg
    n_par = sum(t.numel() for t in _tensors(state["params"]))
    _log(f"[{phase}] {cfg.name} at {cfg.n_layers} of 36 layers: d_model "
         f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
         f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} untied, "
         f"remat {cfg.remat}; {n_par} f32 parameters (state "
         f"{sum(t.numel() * t.element_size() for t in _tensors(state))} B)"
         f", seeded init on the card {time.monotonic() - t0:.2f} s; batch "
         f"{ds.global_batch} x {ds.seq_len}; {opt_cfg}")
    step = make_train_step(model, opt_cfg)
    zero_counts()
    times, losses, syncs = [], [], []
    for i in range(opt_cfg.total_steps):
        # on the card before the watched step: a copy from pageable host
        # memory synchronises
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in ds.global_batch_at(i).items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            if i:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                state, metrics = step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        losses.append(float(metrics["loss"]))
        times.append(time.monotonic() - t0)
        if i:
            syncs.append(sum("synchroniz" in str(w.message) for w in seen))
    peak = torch.cuda.max_memory_allocated()
    train_gate(phase)
    _log(f"[{phase}] losses {[round(x, 5) for x in losses]}, grad_norm "
         f"{float(metrics['grad_norm']):.5f}, lr {float(metrics['lr']):.3g};"
         f" synchronising calls inside steps 2-{len(times)}: {syncs}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[{phase}] losses {losses}")
    if any(syncs):
        raise AssertionError(f"[{phase}] a train step synchronised: {syncs}")
    step_times(phase, times[0], times[1:], ds.global_batch * ds.seq_len)
    _log(f"[{phase}] peak memory {peak} B (torch.cuda.max_memory_allocated)"
         f"; phase wall {time.monotonic() - t_phase:.2f} s")


#: phase p: the sharded train step against the plain one (the
#: reference's bounds, tests/test_distributed.py): the loss, rtol; the
#: parameters, rtol and atol. On one rank p1 holds them bit-equal, and
#: the sharded step's peak above its state to the plain one's within one
#: of the caching allocator's 2 MiB segments
P_STEPS = 3
P_PEAK_SLACK = 2 * 2 ** 20
P_LOSS_RTOL = 2e-4
P_PARAM_RTOL, P_PARAM_ATOL = 2e-2, 2e-4
#: the compressed step against the exact one over 5 steps: the loss
#: within 0.05 each step, the parameters' relative drift below 5e-3
P_COMPRESSED_STEPS = 5
P_COMPRESSED_LOSS, P_COMPRESSED_DRIFT = 0.05, 5e-3
P_BACKEND = "nccl"


def _p_steps(step, state, ds, n: int) -> tuple:
    """``n`` steps of ``step``; (state, losses, seconds a step, bytes the
    steps' peak rose above what was allocated before them), each step
    timed to its loss's fetch. The cuBLAS workspaces are released first:
    one (32 MiB) a cuBLAS handle and stream, made by its first product and
    kept allocated after the run that made it, so without the release a
    run is charged those that no earlier phase of the process made (p1
    alone: 64 MiB more for the sharded run, which goes first), and each
    run here pays its own."""
    import torch
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(n):
        t0 = time.monotonic()
        state, metrics = step(state, ds.global_batch_at(i))
        losses.append(float(metrics["loss"]))
        times.append(time.monotonic() - t0)
    return state, losses, times, torch.cuda.max_memory_allocated() - base


def _param_gap(got, want) -> tuple:
    """(largest abs difference, largest excess over atol + rtol * |want|)
    of two parameter trees (plain tensors)."""
    from repro_torch.optim.adamw import leaves
    gap = over = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        d = (a.float() - b.float()).abs()
        gap = max(gap, float(d.max()))
        over = max(over, float((d - P_PARAM_ATOL
                                - P_PARAM_RTOL * b.float().abs()).max()))
    return gap, over


def run_train_p1(phase: str, arch: str, mesh):
    """Phase p1: ``arch``'s phase-o run (``TRAIN_SETUP``) for ``P_STEPS``
    steps on the 1x1 ``("data", "model")`` mesh (the state DTensors
    placed by ``state_shardings``), then the same steps unsharded from the
    same seed; the first run's state is freed but for its parameters
    before the second is drawn. Returns the sharded run's final state
    for whisper-tiny.en (p3 saves it), else None."""
    import numpy as np
    import torch

    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.sharding import place_tree, rules_for
    from repro_torch.train.setup import preset
    from repro_torch.train.step import make_train_step, state_shardings

    t_phase = time.monotonic()
    model, state, ds, opt_cfg = preset(arch, SEED)
    rules = rules_for(model.cfg, mesh, mode="train")
    state = place_tree(state, state_shardings(model, mesh, rules))
    zero_counts()
    torch.cuda.synchronize()
    state, sharded, t_sh, peak_sh = _p_steps(
        make_train_step(model, opt_cfg, mesh=mesh, rules=rules), state, ds,
        P_STEPS)
    train_gate(phase)
    keep = state if arch == ARCH else None
    got = tree_map(lambda p: p.to_local().clone(), state["params"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    model, state, ds, opt_cfg = preset(arch, SEED)
    state, plain, t_pl, peak_pl = _p_steps(make_train_step(model, opt_cfg),
                                           state, ds, P_STEPS)
    rel = max(abs(a / b - 1) for a, b in zip(sharded, plain))
    gap, over = _param_gap(got, state["params"])
    _log(f"[{phase}] {model.cfg.name} ({model.cfg.n_layers} layers), "
         f"batch {ds.global_batch} x {ds.seq_len}: losses sharded "
         f"{sharded}, plain {plain}: max rel diff {rel:.3g}; params after "
         f"{P_STEPS} steps: max abs diff {gap:.3g} (excess over atol "
         f"{P_PARAM_ATOL} + rtol {P_PARAM_RTOL}: {over:.3g})")
    ms_sh = [round(t * 1e3, 2) for t in t_sh]
    ms_pl = [round(t * 1e3, 2) for t in t_pl]
    _log(f"[{phase}] ms a step, sharded (1x1 mesh) {ms_sh}, plain "
         f"{ms_pl}; median of steps 2-{P_STEPS}: sharded "
         f"{np.median(t_sh[1:]) * 1e3:.2f} ms, plain "
         f"{np.median(t_pl[1:]) * 1e3:.2f} ms")
    _log(f"[{phase}] the steps' peak above the state they start from "
         f"(torch.cuda.max_memory_allocated): sharded {peak_sh} B, plain "
         f"{peak_pl} B; losses bit-equal {sharded == plain}, parameters "
         f"bit-equal {gap == 0.0}")
    if not all(np.isfinite(sharded)) or rel > P_LOSS_RTOL or over > 0:
        raise AssertionError(f"[{phase}] the sharded step is off the "
                             f"plain one: loss rel {rel:.3g}, params "
                             f"excess {over:.3g}")
    if sharded != plain or gap != 0.0:
        raise AssertionError(f"[{phase}] the sharded step on one rank is "
                             f"not bit-equal to the plain one")
    if peak_sh > peak_pl + P_PEAK_SLACK:
        raise AssertionError(f"[{phase}] the sharded step's peak {peak_sh}"
                             f" B is above the plain one's {peak_pl} B")
    del state, got
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")
    return keep


def run_train_p2(phase: str) -> None:
    """Phase p2: whisper-tiny.en's phase-o run, the compressed step on a
    data mesh of 1 against the exact step, ``P_COMPRESSED_STEPS`` steps
    each from the same seed; its error-feedback residuals must be
    non-zero."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.setup import preset
    from repro_torch.parallel.collectives import init_error_state
    from repro_torch.train.step import (make_compressed_train_step,
                                        make_train_step)

    t_phase = time.monotonic()
    mesh = make_mesh((1,), ("data",))
    model, exact_state, ds, opt_cfg = preset(ARCH, SEED)
    _, comp_state, _, _ = preset(ARCH, SEED)
    comp_state["err"] = init_error_state(comp_state["params"], mesh)
    exact = make_train_step(model, opt_cfg)
    comp = make_compressed_train_step(model, opt_cfg, mesh)
    losses = []
    for i in range(P_COMPRESSED_STEPS):
        batch = ds.global_batch_at(i)
        exact_state, me = exact(exact_state, batch)
        comp_state, mc = comp(comp_state, batch)
        losses.append((float(me["loss"]), float(mc["loss"])))
    num = den = 0.0
    for a, b in zip(leaves(comp_state["params"]),
                    leaves(exact_state["params"])):
        num += float(torch.sum((a.float() - b.float()) ** 2))
        den += float(torch.sum(b.float() ** 2))
    drift = (num / den) ** 0.5
    err = max(float(e.to_local().abs().max())
              for e in leaves(comp_state["err"]))
    worst = max(abs(a - b) for a, b in losses)
    _log(f"[{phase}] (exact, compressed) losses {losses}: largest gap "
         f"{worst:.4g} (bound {P_COMPRESSED_LOSS}); parameter drift "
         f"{drift:.4g} (bound {P_COMPRESSED_DRIFT}); largest residual "
         f"{err:.4g}")
    if worst >= P_COMPRESSED_LOSS or drift >= P_COMPRESSED_DRIFT \
            or not np.isfinite(worst) or not err > 0:
        raise AssertionError(f"[{phase}] the compressed step does not "
                             f"track the exact one")
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")


def run_train_p3(phase: str, state, mesh) -> None:
    """Phase p3: p1's sharded whisper-tiny.en state saved, restored onto
    a plain single-device state and back onto the mesh, bit for bit."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.store import (CheckpointManager,
                                              restore_checkpoint)
    from repro_torch.optim.adamw import leaves, tree_map
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.train.setup import preset
    from repro_torch.train.step import state_shardings

    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p3_")
    try:
        mgr = CheckpointManager(tmp)
        mgr.save(P_STEPS, state)
        mgr.wait()
        model, like, _, _ = preset(ARCH, SEED)
        plain, _ = restore_checkpoint(tmp, like)
        sh = state_shardings(model, mesh, rules_for(model.cfg, mesh))
        back, _ = restore_checkpoint(tmp, state, shardings=sh)
        whole = tree_map(lambda x: x.full_tensor(), state["params"])
        n = 0
        for a, b, c in zip(leaves(whole), leaves(plain["params"]),
                           leaves(back["params"])):
            if not (torch.equal(a, b) and torch.equal(a, c.full_tensor())
                    and type(c).__name__ == "DTensor"):
                raise AssertionError(f"[{phase}] a restored leaf differs")
            n += 1
        if not all(torch.equal(x.full_tensor(), y) for x, y in zip(
                leaves(state["opt"]), leaves(plain["opt"]))):
            raise AssertionError(f"[{phase}] a restored moment differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _log(f"[{phase}] {n} parameter leaves and the AdamW state: sharded -> "
         f"checkpoint -> plain and -> mesh, bit-equal; phase wall "
         f"{time.monotonic() - t_phase:.2f} s")


def run_train_p4(phase: str) -> None:
    """Phase p4: the launcher on one rank and a 1x1 mesh, on ``cuda``."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch import train as train_cli
    from repro_torch.train.setup import TRAIN_SETUP

    t_phase = time.monotonic()
    p = TRAIN_SETUP[ARCH]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p4_")
    argv = ["--arch", ARCH, "--devices", "1", "--mesh", "1x1", "--steps",
            "4", "--batch", str(p["batch"]), "--seq", str(p["seq"]),
            "--lr", str(p["lr"]), "--warmup", str(p["warmup"]), "--seed",
            str(SEED), "--ckpt", tmp]
    try:
        _log(f"[{phase}] python -m repro_torch.launch.train "
             f"{' '.join(argv[:-1])} DIR")
        res = train_cli.main(argv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if res.final_step != 4 or len(res.losses) != 4 \
            or not all(np.isfinite(res.losses)):
        raise AssertionError(f"[{phase}] launcher run: {res}")
    _log(f"[{phase}] losses {res.losses}; phase wall "
         f"{time.monotonic() - t_phase:.2f} s")


@contextlib.contextmanager
def one_rank_group():
    """A process group of one rank over ``P_BACKEND`` on the card, made
    for the block and destroyed after it; yields its 1x1 ``("data",
    "model")`` mesh."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    rdv = tempfile.TemporaryDirectory(prefix="chip_smoke_p_")
    torch.cuda.set_device(0)
    dist.init_process_group(P_BACKEND,
                            init_method=f"file://{rdv.name}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()
        rdv.cleanup()


def run_train_p() -> None:
    """Phase p: training through the parallel layer in a process group of
    one rank (``one_rank_group``)."""
    import torch

    t_phase = time.monotonic()
    with one_rank_group() as mesh:
        kept = run_train_p1("p1: whisper-tiny.en, 1x1 mesh vs plain",
                            ARCH, mesh)
        run_train_p3("p3: sharded checkpoint -> plain -> mesh", kept, mesh)
        del kept
        gc.collect()
        torch.cuda.empty_cache()
        run_train_p1("p1: qwen3-4b (4 layers), 1x1 mesh vs plain",
                     "qwen3-4b", mesh)
        run_train_p2("p2: compressed step on a data mesh of 1")
        run_train_p4("p4: launch.train --devices 1 --mesh 1x1")
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"[p] phase wall {time.monotonic() - t_phase:.2f} s")


#: phase q1: the traced peak above the state over the card's; the fake
#: traces of p1's setups on the CPU came to 0.9983 (whisper-tiny.en) and
#: 1.0000 (qwen3-4b) of the card's p1 peaks
Q1_PEAK_LO, Q1_PEAK_HI = 0.95, 1.05
Q1_TIMED = 3
#: phase q2: the cell traced on the 16x16 fake group. qwen3-4b's train_4k
#: traces in about 0.6 of qwen3-moe-30b-a3b's time: the MoE cell took
#: 79-126 s a trace on the card's host, which put phase q at 104-148 s
#: against its budget of about 120 (`launch.dryrun` traces it alone)
Q2_ARCH = "qwen3-4b"
Q2_TIMEOUT = 600
#: q2's "before": the same cell with the whole parameter tree gathered at
#: the forward's start, as the sharded step did before it gathered one
#: layer at a time
Q2_WHOLE_TREE = (
    "import sys\n"
    "from repro_torch.launch import dryrun\n"
    "from repro_torch.models.layers import gathered\n"
    "from repro_torch.optim.adamw import tree_map\n"
    "from repro_torch.train import step\n"
    "step.layer_params = lambda params, axes, gp=None: tree_map(\n"
    "    lambda p: gathered(p, gp), params)\n"
    "sys.exit(dryrun.main(sys.argv[1:]))\n")


def _host_split(step, state, batch) -> tuple:
    """One step of ``step`` with its host pieces timed on the host's clock
    (``time.perf_counter`` around each call, on whichever thread runs
    it): ``layer_params`` (the stacks split into layers, the leaves
    outside them gathered), each per-layer gather (``layers.gathered``
    outside ``layer_params``, the backward's recompute included), the
    backward of DTensor's ``to_local`` / ``redistribute`` /
    ``from_local``, and ``adamw.apply_updates``. Returns (state, the
    step's ms, {piece: (ms, calls)})."""
    import torch
    from torch.distributed.tensor import _api, _redistribute

    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    spent, inside = {}, threading.local()

    def timed(key, fn, mark=False):
        def wrap(*a, **k):
            name = key
            if key == "per-layer gathers" and getattr(inside, "lp", False):
                name = "unstacked gathers"
            if mark:
                inside.lp = True
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                ms, n = spent.get(name, (0.0, 0))
                spent[name] = (ms + (time.perf_counter() - t0) * 1e3, n + 1)
                if mark:
                    inside.lp = False
        return wrap

    patches = [(step_mod, "layer_params", "layer_params", True),
               (layers, "gathered", "per-layer gathers", False),
               (adamw, "apply_updates", "apply_updates", False)]
    for mod, cls in ((_api, "_ToTorchTensor"), (_api, "_FromTorchTensor"),
                     (_redistribute, "Redistribute")):
        if "backward" in vars(getattr(mod, cls, object)):
            patches.append((getattr(mod, cls), "backward",
                            f"{cls}.backward", False))
    saved = [(obj, attr, obj.__dict__[attr]) for obj, attr, _, _ in patches]
    try:
        for obj, attr, key, mark in patches:
            fn = getattr(obj, attr)
            wrapped = timed(key, fn, mark)
            setattr(obj, attr, staticmethod(wrapped)
                    if isinstance(obj, type) else wrapped)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
    return state, total, spent


def _host_profile(step, state, batch) -> tuple:
    """One step of ``step`` under ``torch.profiler`` (host activity only).
    Returns (state, {event: (self host ms, calls)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, batch)
        float(metrics["loss"])
    return state, {e.key: (e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()}


def run_q1(phase: str, arch: str, mesh) -> None:
    """Phase q1: ``arch``'s p1 run (``TRAIN_SETUP``), plain and on the 1x1
    mesh: each step traced on fake ``cuda`` tensors, then run on the
    card (a warm-up step, one under ``FlopCounterMode`` whose peak is
    read, ``Q1_TIMED`` timed, one under ``_host_split``'s timers), and
    the two steps' host pieces printed side by side."""
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.roofline import (model_flops,
                                               roofline_from_cost)
    from repro_torch.launch.dryrun import trace_train
    from repro_torch.parallel.sharding import place_tree, rules_for
    from repro_torch.train.setup import preset
    from repro_torch.train.step import make_train_step, state_shardings

    medians, splits = {}, {}
    for label, m in (("plain", None), ("1x1 mesh", mesh)):
        model, state, ds, opt_cfg = preset(arch, SEED)
        rules = rules_for(model.cfg, mesh, mode="train")
        if m is not None:
            state = place_tree(state, state_shardings(model, m, rules))
        kw = dict(mesh=m, rules=rules if m is not None else None)
        batch = {k: torch.as_tensor(v)
                 for k, v in ds.global_batch_at(1).items()}
        cost = trace_train(model, opt_cfg, device="cuda", batch=batch, **kw)
        traced = cost.peak_bytes - cost.tracked_bytes
        step = make_train_step(model, opt_cfg, **kw)
        state, _ = step(state, ds.global_batch_at(0))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            state, metrics = step(state, ds.global_batch_at(1))
        float(metrics["loss"])
        real = torch.cuda.max_memory_allocated() - base
        flops = fc.get_total_flops()
        times = []
        for i in range(Q1_TIMED):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            state, metrics = step(state, ds.global_batch_at(2 + i))
            float(metrics["loss"])
            times.append(time.monotonic() - t0)
        tokens = ds.global_batch * ds.seq_len
        rl = roofline_from_cost(
            cost, arch=arch, shape=f"{ds.global_batch}x{ds.seq_len}",
            mesh=label, chips=1,
            model_flops=model_flops(model.cfg, model.n_params(),
                                    model.n_active_params(), tokens,
                                    "train"))
        ratio = traced / real
        _log(f"[{phase}] {label}: traced FLOPs {cost.flops:.0f}, the card's"
             f" step under FlopCounterMode {flops}; peak above the state "
             f"traced {traced} B (MemTracker), on the card {real} B "
             f"(max_memory_allocated): {ratio:.4f} (band [{Q1_PEAK_LO}, "
             f"{Q1_PEAK_HI}]); trace {cost.seconds:.2f} s")
        _log(f"[{phase}] {label}: roofline on h100-sxm: compute "
             f"{rl.compute_s * 1e3:.3f} ms, memory {rl.memory_s * 1e3:.3f} "
             f"ms, collective {rl.collective_s * 1e3:.3f} ms, bound "
             f"{rl.bound_s * 1e3:.3f} ms ({rl.dominant}); measured median "
             f"of {Q1_TIMED} steps {statistics.median(times) * 1e3:.2f} ms "
             f"({[round(t * 1e3, 2) for t in times]})")
        if cost.flops != flops:
            raise AssertionError(f"[{phase}] {label}: traced FLOPs "
                                 f"{cost.flops} != the card's {flops}")
        if not Q1_PEAK_LO <= ratio <= Q1_PEAK_HI:
            raise AssertionError(f"[{phase}] {label}: traced peak off the "
                                 f"card's: {ratio:.4f}")
        medians[label] = statistics.median(times) * 1e3
        state, total, spent = _host_split(step, state,
                                          ds.global_batch_at(2 + Q1_TIMED))
        state, events = _host_profile(step, state,
                                      ds.global_batch_at(3 + Q1_TIMED))
        splits[label] = (total, spent, events)
        del state, metrics, step
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for _ in range(Q1_TIMED):
        model.param_axes()
    axes_ms = (time.perf_counter() - t0) * 1e3 / Q1_TIMED
    parts = {label: ", ".join(f"{k} {ms:.2f} ms ({n})"
                              for k, (ms, n) in sorted(spent.items()))
             for label, (_, spent, _) in splits.items()}
    _log(f"[{phase}] host split: median step, 1x1 mesh minus plain "
         f"{medians['1x1 mesh'] - medians['plain']:.2f} ms; one timed step"
         f" each, plain {splits['plain'][0]:.2f} ms ({parts['plain']}), "
         f"1x1 mesh {splits['1x1 mesh'][0]:.2f} ms "
         f"({parts['1x1 mesh']}); model.param_axes() {axes_ms:.2f} ms a "
         f"call (once a step maker)")
    plain_ev, mesh_ev = splits["plain"][2], splits["1x1 mesh"][2]
    none = (0.0, 0)
    diff = sorted(((mesh_ev.get(k, none)[0] - plain_ev.get(k, none)[0], k)
                   for k in set(plain_ev) | set(mesh_ev)), reverse=True)
    total = (sum(v[0] for v in mesh_ev.values())
             - sum(v[0] for v in plain_ev.values()))
    _log(f"[{phase}] host profile (torch.profiler, self host ms of one "
         f"step, 1x1 mesh minus plain, the 12 largest; calls plain/mesh): "
         f"total {total:.2f} ms; "
         + "; ".join(f"{k} {d:+.2f} ({plain_ev.get(k, none)[1]}/"
                     f"{mesh_ev.get(k, none)[1]})" for d, k in diff[:12]))


def _start_dryruns(runs: dict) -> dict:
    """Start each of ``runs`` ({label: argv after the interpreter}) in a
    process of its own, the repository's ``src`` on its path and its
    output in temporary files, all at once. Returns {label: (process,
    stdout, stderr)}."""
    import tempfile
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = {}
    for label, argv in runs.items():
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs[label] = (subprocess.Popen([sys.executable] + argv, stdout=out,
                                         stderr=err, env=env, cwd=HERE),
                        out, err)
    return procs


def _finish_dryruns(phase: str, procs: dict, deadline: float) -> dict:
    """Wait for ``_start_dryruns``'s processes until ``deadline`` (the
    monotonic clock; past it every one is killed and the phase fails) and
    return {label: the last JSON record each printed}; a process that
    exits non-zero or prints no record fails the phase."""
    recs = {}
    for label, (proc, out, err) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for other, _, _ in procs.values():
                other.kill()
                other.wait()
            raise AssertionError(f"[{phase}] {label}: past its deadline")
        out.seek(0)
        err.seek(0)
        text = out.read()
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        if proc.returncode or not lines:
            raise AssertionError(f"[{phase}] {label}: exit "
                                 f"{proc.returncode}\n{text[-2000:]}\n"
                                 f"{err.read()[-4000:]}")
        recs[label] = json.loads(lines[-1])
        _log(f"[{phase}] {label}: {lines[-1]}")
    return recs


def _kill_dryruns(procs: dict) -> None:
    for proc, _, _ in procs.values():
        proc.kill()
        proc.wait()


def start_q2() -> dict:
    """Start phase q2: ``Q2_ARCH``'s train_4k cell on the 16x16 fake
    group, with the per-layer gather and with the whole tree gathered,
    each traced in a process of its own (their output in temporary
    files), the two at once. Returns {label: (process, stdout, stderr)}."""
    args = ["--arch", Q2_ARCH, "--shape", "train_4k", "--device", "cuda"]
    return _start_dryruns({
        "per-layer gather": ["-m", "repro_torch.launch.dryrun"] + args,
        "whole-tree gather": ["-c", Q2_WHOLE_TREE] + args})


def finish_q2(phase: str, procs: dict, t_start: float) -> None:
    """Wait for ``start_q2``'s processes (``Q2_TIMEOUT`` from
    ``t_start``), read their records and gate them: each ends ``ok``,
    and a rank's peak with the per-layer gather is below the whole
    tree's and under the card's memory."""
    import torch
    recs = _finish_dryruns(phase, procs, t_start + Q2_TIMEOUT)
    card = torch.cuda.get_device_properties(0).total_memory
    for label, rec in recs.items():
        mem = rec["memory"]
        _log(f"[{phase}] {label}: status {rec['status']}, a rank's peak "
             f"{mem['peak_bytes']} B ({mem['peak_bytes'] / 1e9:.3f} GB; "
             f"state and rows {mem['argument_bytes']} B), under 80 GB: "
             f"{mem['peak_bytes'] < 80e9}, under the card's {card} B: "
             f"{mem['peak_bytes'] < card}; traced in "
             f"{rec['compile_s']:.1f} s")
        if rec["status"] != "ok":
            raise AssertionError(f"[{phase}] {label}: {rec}")
    per = recs["per-layer gather"]["memory"]["peak_bytes"]
    whole = recs["whole-tree gather"]["memory"]["peak_bytes"]
    if not per < whole:
        raise AssertionError(f"[{phase}] the per-layer gather's peak {per}"
                             f" B is not below the whole tree's {whole} B")
    if not per < card:
        raise AssertionError(f"[{phase}] the per-layer gather's peak {per}"
                             f" B is not under the card's {card} B")


def run_phase_q() -> None:
    """Phase q: q2's two traces (processes of their own, on the host's
    cores) run while q1 holds the dry-run against the card in a one-rank
    group."""
    import torch

    from repro_torch.train.setup import TRAIN_SETUP

    t_phase = time.monotonic()
    procs = start_q2()
    try:
        zero_counts()
        with one_rank_group() as mesh:
            for arch in TRAIN_SETUP:
                run_q1(f"q1: {arch}, traced vs the card", arch, mesh)
        train_gate("q1")
    except BaseException:
        _kill_dryruns(procs)
        raise
    gc.collect()
    torch.cuda.empty_cache()
    finish_q2(f"q2: {Q2_ARCH} train_4k on 16x16", procs, t_phase)
    _log(f"[q] phase wall {time.monotonic() - t_phase:.2f} s")


#: phase r: the meshed serving steps on the one-rank mesh against the
#: unmeshed ones. r1 runs R_LANES lanes, a prefill and R_STEPS greedy
#: decode steps; a step's rise of max_memory_allocated may pass the
#: unmeshed step's by one layer's cache planes and one layer's weights
#: plus R_PEAK_SLACK
R_LANES, R_STEPS = 4, 8
R_PROMPT = {"qwen3-4b": 256, ARCH: 16}
R_PEAK_SLACK = 64 * 2 ** 20
#: r2: the serving cells traced on the 16x16 fake group, (arch, shape) ->
#: (the bound on a rank's peak in bytes, the bound on its traced FLOPs,
#: scaled to the mesh, over the model FLOPs). qwen3-moe-30b-a3b's decode
#: bound of 16 is its capacity at S = 1, which runs every expert: 128 / 8
#: times the active experts' FLOPs, as the reference does
R2_CELLS = {
    ("qwen3-4b", "decode_32k"): (5e9, 8.0),
    ("qwen3-4b", "prefill_32k"): (16e9, 8.0),
    ("qwen3-moe-30b-a3b", "prefill_32k"): (16e9, 8.0),
    ("qwen3-moe-30b-a3b", "decode_32k"): (6.5e9, 16.0),
    ("mixtral-8x7b", "decode_32k"): (9.5e9, 8.0),
    ("zamba2-7b", "decode_32k"): (5.1e9, 5.0),
    ("llava-next-34b", "decode_32k"): (10e9, 4.0),
    ("llava-next-34b", "prefill_32k"): (17e9, 2.5),
    ("gemma2-2b", "decode_32k"): (3.5e9, 4.0),
    ("xlstm-350m", "decode_32k"): (0.6e9, 4.0),
}
#: r2: the cells whose heads do not divide ``model`` (the reference's
#: ``serve_row_tp``; xlstm-350m's 4 heads on 16): no attention, MLP, head
#: or xLSTM unit may be taken whole (``split_counts``), and the trace may
#: hold no op on a global cache leaf's shape (``cache_leaf_ops``)
R2_ROW_TP = {("llava-next-34b", "decode_32k"),
             ("llava-next-34b", "prefill_32k"), ("gemma2-2b", "decode_32k"),
             ("xlstm-350m", "decode_32k")}
R2_SPLIT_UNITS = ("attention", "mlp", "head", "mlstm", "slstm")
#: r2: the cells whose attention takes the ``head_dim`` form (their KV
#: heads do not divide 16, head_dim does): no ``wk``, ``wv``, ``bk`` or
#: ``bv`` may be gathered whole (``whole_leaves``), and no all-gather of
#: a ``wk`` / ``wv`` shard traced at ``models.layers:gathered``
#: (``gathered_sites``): a rank computes K and V on its head_dim slice
R2_HEAD_DIM = {("qwen3-4b", "decode_32k"), ("qwen3-4b", "prefill_32k"),
               ("qwen3-moe-30b-a3b", "prefill_32k"),
               ("qwen3-moe-30b-a3b", "decode_32k"),
               ("mixtral-8x7b", "decode_32k")}
#: r2: a rank's peak in bytes and traced / model FLOPs before a split
#: took more of the cell, printed beside this run's: the ``head_dim``
#: cells as they were while each rank gathered ``wk`` / ``wv`` whole and
#: multiplied every KV head at full head_dim (traced on fake ``cuda`` on
#: the card, PRs 28-29, unchanged to PR 31); zamba2-7b, xlstm-350m and
#: the ``serve_row_tp`` cells before their mamba, xLSTM and
#: ``serve_row_tp`` layers were split, traced on fake ``cpu`` tensors;
#: llava-next-34b's prefill_32k before its context parallelism (every
#: rank attended every position), traced on fake ``cuda`` on the card
R2_BEFORE = {
    ("qwen3-4b", "decode_32k"): (3080666624, 3.738),
    ("qwen3-4b", "prefill_32k"): (4859127808, 3.649),
    ("qwen3-moe-30b-a3b", "prefill_32k"): (7556146176, 5.288),
    ("qwen3-moe-30b-a3b", "decode_32k"): (5560663040, 13.336),
    ("mixtral-8x7b", "decode_32k"): (8125412352, 4.595),
    ("zamba2-7b", "decode_32k"): (5074458380, 15.9),
    ("llava-next-34b", "decode_32k"): (13217134916, 28.89),
    ("llava-next-34b", "prefill_32k"): (16247590400, 14.078),
    ("gemma2-2b", "decode_32k"): (5089393540, 33.97),
    ("xlstm-350m", "decode_32k"): (595946180, 14.56),
}
R2_TIMEOUT = 420
#: r3: one qwen3-4b layer at full width split over ``model`` shard by
#: shard on the card, (ranks of ``model``, the attention's form): 16 ranks
#: split head_dim (8 KV heads), 8 split the KV heads; 4 lanes, a prefill of
#: R3_PROMPT ids and a decode step over an R3_CACHE-position cache
R3_ARCH = "qwen3-4b"
R3_SPLITS = ((16, "head_dim"), (8, "heads"))
R3_PROMPT, R3_CACHE = 256, 300
#: r3: the shards' f32 sum against the exact (f64) product of the same
#: bf16 inputs, over the largest magnitude: f32 summation order only.
#: The CPU tests hold the sums within 1e-6 of the unsplit plain product;
#: on the card the unsplit kernel's own tensor-core sum over K = 9728
#: lies 1.2e-5 from exact, so the exact product is the yardstick here.
#: Measured 7.95e-8 to 1.37e-6 on an NVIDIA H100 80GB HBM3 at 700 W; a
#: partial rounded to bf16 before the sum lies ~2e-3 out
R3_REL = 5e-6
#: r3: a split layer's bf16 output against the unsplit one's: one bf16
#: rounding of the largest magnitude apart at most
R3_OUT_REL = 2 ** -7
#: r4: r1's qwen3-4b split over R4_TP ranks of ``model`` shard by shard
#: on one card, each unit in the form a 1x4 mesh gives it (8 KV heads on
#: 4: the heads form), against the unmeshed steps; held to the bound the
#: decoder phases hold 36 layers of kernel-against-plain logits to
R4_TP = 4
R4_FORMS = {"attention": "heads", "mlp": "ff", "embed": "vocab",
            "head": "vocab_cols"}
#: r4: the MoE and hybrid models split over R4_TP shard by shard the same
#: way, (arch, layers, the forms of a 1x4 mesh, the logits bound): qwen3-
#: moe-30b-a3b at phase j's 8 layers (32 experts a shard) and zamba2-7b
#: cut to R4_HYBRID_LAYERS (whole segments of 5 mamba blocks and the
#: shared block; 28 SSM heads a shard), at the bounds phases j and l hold
#: kernel-against-plain logits to
R4_HYBRID_LAYERS = 24
R4_MORE = (
    ("qwen3-moe-30b-a3b", 8, {"attention": "heads", "moe": "experts",
                              "embed": "vocab", "head": "vocab_cols"},
     LOGIT_REL_TOL_MOE),
    ("zamba2-7b", R4_HYBRID_LAYERS, {"attention": "heads", "mlp": "ff",
                                     "mamba": "inner", "embed": "vocab",
                                     "head": "vocab_cols"},
     LOGIT_REL_TOL_HYBRID))
#: r5: one MoE layer or mamba block at full width split over ``model``
#: shard by shard on the card, (arch, unit, ranks of ``model``, form):
#: qwen3-moe-30b-a3b's 128 experts over 16 and 4 (8 and 32 a shard),
#: mixtral-8x7b's 8 experts over 16 (896 FFN columns a shard), a
#: zamba2-7b mamba block over 16 (7 SSM heads of 64 a shard); 4 lanes, a
#: prefill of R3_PROMPT positions, then a decode step on what it left
R5_SPLITS = (("qwen3-moe-30b-a3b", "moe", 16, "experts"),
             ("qwen3-moe-30b-a3b", "moe", 4, "experts"),
             ("mixtral-8x7b", "moe", 16, "expert_ff"),
             ("zamba2-7b", "mamba", 16, "inner"))
#: r4: the xLSTM and ``serve_row_tp`` models split shard by shard,
#: (arch, layers, ranks of ``model``, the forms, the kernels that must
#: launch): xlstm-350m over 4 (one head a rank: the mLSTM's ``inner``,
#: the sLSTM's ``heads`` form) cut to R4_XLSTM_LAYERS, r1's whisper-
#: tiny.en over 4 (6 heads on 4: ``param_embed``), gemma2-2b over 16 (8
#: heads on 16) cut to R4_GEMMA_LAYERS (whole (local, global) segments),
#: each held to LOGIT_REL_TOL_DECODER. xlstm-350m's random blocks carry a
#: changed bf16 rounding further with each block: two equally valid
#: roundings of the unsplit products (the library's, and each rounded
#: from its exact sum: r4's yardstick) put the logits 0.0139-0.0293 of
#: the largest apart at 4 blocks and 0.2365-0.4516 at all 24, and the
#: split as far (0.0131-0.0254; 0.2743-0.4092), so at 24 no bound that
#: an exact split meets would see a fault of it (PERF.md, section 6)
R4_XLSTM_LAYERS = 4
R4_GEMMA_LAYERS = 8
R4_SPLIT = (
    ("xlstm-350m", R4_XLSTM_LAYERS, 4, {"mlstm": "inner", "slstm": "heads",
                             "embed": "vocab", "head": "vocab_cols"},
     ("fp16_matmul", "slstm_scan")),
    (ARCH, None, 4, {"attention": "param_embed", "mlp": "param_embed",
                     "embed": "vocab", "frontend": "param_embed",
                     "dec_pos": "param_embed"},
     ("fp16_matmul", "flash_attention")),
    ("gemma2-2b", R4_GEMMA_LAYERS, 16, {"attention": "param_embed",
                                        "mlp": "param_embed",
                                        "embed": "vocab"},
     ("fp16_matmul", "flash_attention")))
#: r5: the units the xLSTM and ``serve_row_tp`` split adds, at full width
#: shard by shard, (arch, unit, ranks of ``model``, form): a llava-next-34b
#: layer (attention, MLP, the untied head) and gemma2-2b's global and
#: local layers (softcap 50, window 4096, head_dim 256 split 16 ways) in
#: the ``param_embed`` form over 16; xlstm-350m's mLSTM and sLSTM blocks
#: over 16 (``param_embed``) and over 4 (their heads, one a rank); 4
#: lanes, a prefill of R3_PROMPT positions, then a decode step over an
#: R3_CACHE-position cache or on the state the prefill left
R5_UNITS = (("llava-next-34b", "global", 16, "param_embed"),
            ("gemma2-2b", "global", 16, "param_embed"),
            ("gemma2-2b", "local", 16, "param_embed"),
            ("xlstm-350m", "mlstm", 16, "param_embed"),
            ("xlstm-350m", "mlstm", 4, "inner"),
            ("xlstm-350m", "slstm", 16, "param_embed"),
            ("xlstm-350m", "slstm", 4, "heads"))


def _r_setup(arch: str, layers=None):
    """(model, params, prefill batch) of r1's run of ``arch``: qwen3-4b
    at full width and depth with bf16 weights drawn on the card
    (``breakdown.decoder_setup``), or whisper-tiny.en with its f32
    weights and 1500 frames a lane; prompts of ``R_PROMPT[arch]`` ids.
    Another decoder (r4's) is cut to ``layers`` (``decoder_setup``'s)
    and takes prompts of ``R_PROMPT["qwen3-4b"]`` ids."""
    import numpy as np
    import torch

    from repro_torch.breakdown import decoder_setup
    from repro_torch.configs import get_config
    from repro_torch.models.model import build

    rng = np.random.default_rng(SEED)
    if arch == ARCH:
        model = build(get_config(ARCH))
        params = model.init_values(torch.Generator().manual_seed(SEED),
                                   device="cuda")
    else:
        model, params, _ = decoder_setup(arch, SEED, layers)
    cfg = model.cfg
    batch = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab, (R_LANES, R_PROMPT.get(arch, R_PROMPT["qwen3-4b"])))
        .astype(np.int32)).cuda()}
    if cfg.enc_dec:
        batch["enc_frames"] = torch.from_numpy(
            (rng.standard_normal((R_LANES, 1500, cfg.d_model)) * 0.02)
            .astype(np.float32)).cuda()
    return model, params, batch


def _r_layer_bytes(arch: str, model, params) -> int:
    """One layer's cache planes for r1's lanes (the largest stack's
    layer: a segment's blocks, or a Whisper layer's self and cross
    planes) plus the largest stack's layer of ``params``, as stored."""
    from repro_torch.models.model import tree_paths
    from repro_torch.train.step import prefill_cache_len

    def largest(tree, stacked):
        per = {}
        for path, t in tree_paths(tree):
            if stacked(path):
                key = path.split("/")[0]
                per[key] = per.get(key, 0) + t.nbytes // t.shape[0]
        return max(per.values())
    cache = model.cache_specs(R_LANES, prefill_cache_len(R_PROMPT[arch]))
    axes = dict(tree_paths(model.param_axes()))
    return largest(cache, lambda p: True) + largest(
        params, lambda p: axes[p][:1] == ("layers",))


def _r_serve(model, params, batch, mesh=None, rules=None) -> tuple:
    """r1's prefill and ``R_STEPS`` greedy decode steps, unmeshed or on
    ``mesh``, under the h100-sxm dispatch context. Returns (each step's
    logits, the ids fed, each step's rise of max_memory_allocated over
    what was allocated before it, the launch counts, the cache)."""
    import torch

    from repro_torch.kernels.api import DispatchContext, use_context
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.step import make_decode_step, make_prefill_step

    kw = {} if mesh is None else dict(mesh=mesh, rules=rules)
    prefill = make_prefill_step(model, **kw)
    decode = make_decode_step(model, **kw)
    rises, logits, ids = [], [], []

    def step(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        rises.append(torch.cuda.max_memory_allocated() - base)
        return out

    zero_counts()
    with use_context(DispatchContext.for_platform("h100-sxm")):
        last, cache = step(lambda: prefill(params, batch))
        ptrs = [x.to_local().untyped_storage().data_ptr()
                if mesh is not None else x.untyped_storage().data_ptr()
                for x in leaves(cache)]
        pos = batch["tokens"].shape[1]
        for t in range(R_STEPS + 1):
            logits.append(last.clone())
            if t == R_STEPS:
                break
            nxt = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            ids.append(nxt)
            last, out = step(lambda: decode(params, cache, nxt, pos + t))
            now = [x.to_local().untyped_storage().data_ptr()
                   if mesh is not None else x.untyped_storage().data_ptr()
                   for x in leaves(out)]
            if out is not cache or now != ptrs:
                raise AssertionError("a decode step did not return the "
                                     "cache it was given, written in place")
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    return logits, ids, rises, counts, cache


def run_r1(phase: str, arch: str, mesh) -> dict:
    """Phase r1 for ``arch``: the meshed prefill and decode steps on the
    one-rank mesh (the weights placed by their serve rules, the cache
    kept in ``cache_shardings``' placements) against the unmeshed steps
    from the same weights: logits and ids bit-equal, the cache's
    storages kept by every step, each step's memory rise within
    ``_r_layer_bytes`` + ``R_PEAK_SLACK`` of the unmeshed one's, and
    ``fp16_matmul`` / ``flash_attention`` launched as often. Returns the
    meshed run's launch counts."""
    import torch

    from repro_torch.optim.adamw import leaves, tree_map
    from repro_torch.parallel.sharding import (enforce_divisibility,
                                               place_tree, rules_for,
                                               tree_shardings)
    from repro_torch.train.step import cache_shardings, prefill_cache_len

    t_phase = time.monotonic()
    model, params, batch = _r_setup(arch)
    cfg = model.cfg
    rules = rules_for(cfg, mesh, mode="serve")
    plain = _r_serve(model, params, batch)
    kernels = ("fp16_matmul", "flash_attention")
    read_counts(f"{phase}, unmeshed", kernels, kernels)
    placed = place_tree(params, enforce_divisibility(
        tree_shardings(model.param_axes(), mesh, rules),
        model.param_shapes()))
    meshed = _r_serve(model, placed, batch, mesh, rules)
    counts, _ = read_counts(f"{phase}, meshed", kernels, kernels)
    sh = cache_shardings(model, R_LANES, prefill_cache_len(R_PROMPT[arch]),
                         mesh, rules)
    cache = meshed[4]
    for x, want in zip(leaves(cache), leaves(sh)):
        if type(x).__name__ != "DTensor" \
                or tuple(x.placements) != want.placements:
            raise AssertionError(f"[{phase}] a cache leaf left its "
                                 f"placements: {x}")
    same = [torch.equal(a, b) for a, b in zip(meshed[0], plain[0])]
    ids = [torch.equal(a, b) for a, b in zip(meshed[1], plain[1])]
    gap = max(float((a - b).abs().max()) for a, b in zip(meshed[0],
                                                         plain[0]))
    slack = _r_layer_bytes(arch, model, params) + R_PEAK_SLACK
    over = [m - p for m, p in zip(meshed[2], plain[2])]
    _log(f"[{phase}] {cfg.name} ({cfg.n_layers} layers), {R_LANES} lanes x "
         f"{R_PROMPT[arch]} ids, {R_STEPS} decode steps: logits bit-equal "
         f"{same} (max abs diff {gap:.3g}), ids equal {ids}; memory rise a "
         f"step (prefill, then each decode step), meshed {meshed[2]} B, "
         f"unmeshed {plain[2]} B, meshed minus unmeshed {over} B against "
         f"{slack} B (one layer's cache and weights + {R_PEAK_SLACK}); "
         f"launches meshed {counts}, unmeshed {plain[3]}")
    if not all(same) or not all(ids):
        raise AssertionError(f"[{phase}] the meshed steps on one rank are "
                             f"not bit-equal to the unmeshed ones")
    if max(over) > slack:
        raise AssertionError(f"[{phase}] a meshed step's memory rise "
                             f"passes the unmeshed one's by {max(over)} B")
    for k in kernels:
        if counts[k] != plain[3][k]:
            raise AssertionError(f"[{phase}] {k} launched {counts[k]} "
                                 f"times meshed, {plain[3][k]} unmeshed")
    del model, params, placed, plain, meshed, cache
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")
    return counts


def start_r2() -> dict:
    """Start phase r2: the ``R2_CELLS`` on the 16x16 fake group, each
    traced on fake ``cuda`` tensors in a process of its own, all at
    once."""
    return _start_dryruns({
        f"{arch} {shape}": ["-m", "repro_torch.launch.dryrun", "--arch",
                            arch, "--shape", shape, "--device", "cuda"]
        for arch, shape in R2_CELLS})


def finish_r2(phase: str, procs: dict, t_start: float) -> None:
    """Read ``start_r2``'s records (``R2_TIMEOUT`` from ``t_start``) and
    gate them: each ends ``ok``, a rank's peak under its ``R2_CELLS``
    bound and under the card's memory, its traced FLOPs under its bound
    times the model FLOPs, and in the ``R2_HEAD_DIM`` cells no ``wk`` /
    ``wv`` gathered whole; it prints the roofline's three terms, the
    collective bytes by kind, the leaves gathered whole and, where
    ``R2_BEFORE`` has them, the figures before the split took more."""
    import torch

    from repro_torch.configs import get_config
    recs = _finish_dryruns(phase, procs, t_start + R2_TIMEOUT)
    card = torch.cuda.get_device_properties(0).total_memory
    bad = []
    for (arch, shape), (peak_max, flops_max) in R2_CELLS.items():
        rec = recs[f"{arch} {shape}"]
        mem = rec["memory"]
        peak = mem["peak_bytes"]
        ratio = rec["hlo_flops"] / rec["model_flops"]
        before = R2_BEFORE.get((arch, shape))
        was = "" if before is None else (
            f"; before {before[0]} B, {before[1]}x")
        was += (f"; units {rec['split_counts']}; ops on a global cache "
                f"leaf's shape {rec['cache_leaf_ops']}; leaves gathered "
                f"whole {rec['whole_leaves']}, their all-gathers' operand "
                f"bytes {rec['gathered_sites']}")
        if (arch, shape) in R2_HEAD_DIM:
            cfg = get_config(arch)
            kv = (cfg.d_model, cfg.n_kv_heads, cfg.head_dim // 16)
            kv = f"all-gather {kv}"
            whole = [k for k in rec["whole_leaves"]
                     if k.split(":")[1] in ("wk", "wv", "bk", "bv")]
            if whole or kv in rec["gathered_sites"]:
                bad.append(f"{arch} {shape}: K/V weights gathered whole "
                           f"{whole}, gathered {rec['gathered_sites']}")
        if (arch, shape) in R2_ROW_TP:
            whole = [k for k in rec["split_counts"]
                     if k.split(":")[0] in R2_SPLIT_UNITS
                     and k.endswith(":whole")]
            if whole or rec["cache_leaf_ops"]:
                bad.append(f"{arch} {shape}: units whole {whole}, ops on "
                           f"a global cache leaf {rec['cache_leaf_ops']}")
        _log(f"[{phase}] {arch} {shape}: status {rec['status']}, a rank's "
             f"peak {peak} B ({peak / 1e9:.3f} GB; weights, cache and rows "
             f"{mem['argument_bytes']} B), traced FLOPs {rec['hlo_flops']}"
             f" (model FLOPs {rec['model_flops']}, {ratio:.3f}x; a rank's "
             f"{rec['hlo_flops'] / rec['chips']:.6g}, flash_attention "
             f"{rec['attention_flops']} of them), "
             f"compute term {rec['compute_s'] * 1e3:.4f} ms, memory term "
             f"{rec['memory_s'] * 1e3:.4f} ms, collective term "
             f"{rec['collective_s'] * 1e3:.4f} ms (collective bytes by "
             f"kind {rec['collectives']}), "
             f"under {peak_max / 1e9:.1f} GB: {peak < peak_max}, under "
             f"{flops_max}x: {ratio < flops_max}, fits the card's {card} B:"
             f" {peak < card}; traced in {rec['compile_s']:.1f} s{was}")
        if rec["status"] != "ok" or not peak < peak_max or not peak < card:
            bad.append(f"{arch} {shape}: peak {peak} B, status "
                       f"{rec['status']}")
        if not ratio < flops_max:
            bad.append(f"{arch} {shape}: traced FLOPs {ratio:.3f}x the "
                       f"model FLOPs")
    if bad:
        raise AssertionError(f"[{phase}] {'; '.join(bad)}")


def _r3_gap(got, want) -> float:
    """|got - want|'s largest over want's largest magnitude."""
    return float((got.float() - want.float()).abs().max()) \
        / float(want.float().abs().max())


def run_r3(phase: str) -> dict:
    """Phase r3: one layer of ``R3_ARCH`` at full width (seeded bf16
    weights on the card) split over ``model`` as ``R3_SPLITS`` say, shard
    by shard: a thread a shard (``parallel.model_axis.run_shards``), each
    running the split layer on its shard through the kernels, their
    collectives met in memory. The attention's prefill (``R3_PROMPT`` ids
    a lane, causal, rope, qk-norm) and one decode step over a cache of
    ``R3_CACHE`` positions, the MLP, the embedding and the head on the
    last position, against the unsplit layer:

    * each row-parallel product (``wo``, the MLP's ``down``): the
      shards' f32 partials summed within ``R3_REL`` of the exact product
      of the same inputs (the shards' inputs side by side, in f64); it
      prints their gaps to the unsplit kernel's product of those inputs
      and that product's own gap to exact;
    * those inputs (the attention's output before ``wo``, the MLP's
      activation) within ``BF16_REL`` of the unsplit layer's: a shard's
      flash attention over 2 heads splits its KV range (``kv_splits``)
      where 32 heads fill the card without, so its bf16 output may round
      apart;
    * the layer's bf16 outputs within ``R3_OUT_REL``, each shard's cache
      slice within ``R3_REL``, the embedding bit-equal, the head's
      columns within ``R3_REL``, ``sharded_argmax`` the unsplit argmax.

    In the ``head_dim`` form a shard multiplies x by its query heads
    beside its head_dim slice of ``wk`` and ``wv`` in one
    ``fp16_matmul`` launch of (d, H/tp * D + 2 * Hkv * D/tp), where the
    unsplit layer's 3-D QKV product is the library's, so a K or V
    element may round apart from the unsplit one at a near-tie. There
    (``_head_dim_checks``) each shard's fused product, bf16, must lie
    where its exact (f64) product, moved by at most ``R3_REL`` of its
    largest magnitude (f32 summation order), rounds once, and each
    cache slice within ``R3_REL`` of the slice the unsplit layer's
    qk-norm and rope make from the shards' products side by side; the
    slices' gaps to the unsplit layer's cache are printed.

    ``fp16_matmul`` and ``flash_attention`` must launch. Returns the
    launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.api import DispatchContext, use_context
    from repro_torch.models import attention as A
    from repro_torch.models.layers import (_act, embed, gather_context,
                                           layer_slice, logits_head, mlp, mm,
                                           mm_out, model_axis,
                                           sharded_argmax, split_unit)
    from repro_torch.models.model import build
    from repro_torch.parallel.model_axis import run_shards

    t_phase = time.monotonic()
    cfg = dataclasses.replace(get_config(R3_ARCH), n_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = build(cfg).init_values(gen, device="cuda", dtype=torch.bfloat16)
    block = layer_slice(params["segments"], 0)["block0"]
    attn, unit = block["attn"], block["mlp"]
    rng = np.random.default_rng(SEED)

    def draw(shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) * scale).cuda().to(torch.bfloat16)
    lanes = R_LANES
    x = draw((lanes, R3_PROMPT, cfg.d_model))
    xd = draw((lanes, 1, cfg.d_model))
    pool = {k: draw((1, lanes, R3_CACHE, cfg.n_kv_heads, cfg.head_dim))
            for k in ("k", "v")}
    pos = torch.tensor([R3_CACHE - 1, R3_PROMPT, R3_PROMPT // 2, 17],
                       device="cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (
        lanes, R3_PROMPT)).astype(np.int32)).cuda()
    head = params["lm_head"]
    last = x[:, -1:]

    def act_in(u):
        """The MLP's activation, the input of its ``down``."""
        return _act(cfg.act)(mm(x, u["gate"])) * mm(x, u["up"])

    def exact(a, w):
        """a @ w of bf16 operands in f64: every product and sum exact to
        f64's rounding."""
        return (a.double() @ w.double()).float()

    plain_out = A._project_out
    seen = {}

    def record(p, out):
        """``_project_out``, its input kept under the shard's rank (-1:
        the unsplit layer)."""
        axis = model_axis()
        seen.setdefault(-1 if axis is None else axis.rank, []).append(out)
        return plain_out(p, out)

    launches = {}
    with use_context(DispatchContext.for_platform("h100-sxm")), \
            torch.no_grad():
        A._project_out = record
        try:
            want_p, want_pc = A.attention(attn, x, cfg, mode="prefill",
                                          use_rope=True)
            whole = {k: v.clone() for k, v in pool.items()}
            want_d, _ = A.attention(attn, xd, cfg, mode="decode",
                                    cache=whole, pos=pos, layer_idx=0,
                                    use_rope=True)
            want_po, want_do = seen.pop(-1)
            want_h = act_in(unit)
            want_m = mlp(unit, x, cfg.act)
            want_x = embed(params["embed"], tokens)
            want_l = logits_head(params["embed"], last, cfg.vocab,
                                 head=head)
            torch.cuda.synchronize()

            for tp, form in R3_SPLITS:
                t0 = time.monotonic()
                zero_counts()
                seen.clear()
                split = (2, 3) if form == "heads" else (3, 4)

                def one(axis, tp=tp, form=form, split=split):
                    with torch.no_grad(), gather_context(model=axis):
                        p = split_unit(attn, axis, form)
                        yp, cp = A.attention(p, x, cfg, mode="prefill",
                                             use_rope=True)
                        sp = axis.reduced[-1]
                        mine = {k: v.chunk(tp, split[1])[axis.rank].clone()
                                for k, v in pool.items()}
                        yd, _ = A.attention(p, xd, cfg, mode="decode",
                                            cache=mine, pos=pos,
                                            layer_idx=0, use_rope=True)
                        sd = axis.reduced[-1]
                        u = split_unit(unit, axis, "ff")
                        ym = mlp(u, x, cfg.act)
                        sm = axis.reduced[-1]
                        tbl = split_unit(params["embed"], axis, "vocab")
                        xs = embed(tbl, tokens)
                        ls = logits_head(tbl, last, cfg.vocab,
                                         head=split_unit(head, axis,
                                                         "vocab_cols"))
                        ids = sharded_argmax(ls[:, -1])
                    return dict(yp=yp, cp=cp, sp=sp, yd=yd, mine=mine,
                                sd=sd, ym=ym, sm=sm, h=act_in(u), xs=xs,
                                ls=ls, ids=ids)
                with _spied(A, "_head_dim_qkv") as kv_seen, \
                        _mm_shapes() as mm_seen:
                    outs = run_shards(tp, one)
                torch.cuda.synchronize()
                counts = {k: fn.launches
                          for k, fn in launch_counters().items()}
                # the row-parallel products of the shards' inputs: exact
                # (f64) and by the unsplit kernel
                po = torch.cat([seen[r][0] for r in range(tp)], 2)
                do = torch.cat([seen[r][1] for r in range(tp)], 2)
                hs = torch.cat([o["h"] for o in outs], -1)
                wo = attn["wo"].reshape(-1, cfg.d_model)
                refs = {
                    "prefill wo": (exact(po.flatten(-2), wo),
                                   mm_out(po, attn["wo"],
                                          out_dtype=torch.float32)),
                    "decode wo": (exact(do.flatten(-2), wo),
                                  mm_out(do, attn["wo"],
                                         out_dtype=torch.float32)),
                    "MLP down": (exact(hs, unit["down"]),
                                 mm(hs, unit["down"],
                                    out_dtype=torch.float32))}
                gaps, bad = {}, []

                def close(what, got, want, rel):
                    g = _r3_gap(got, want)
                    key = what.split(" shard")[0]
                    gaps[key] = max(gaps.get(key, 0.0), g)
                    if not g <= rel:
                        bad.append(f"{what}: {g:.3g} > {rel:.3g}")
                close("prefill attention output", po, want_po, BF16_REL)
                close("decode attention output", do, want_do, BF16_REL)
                close("MLP activation", hs, want_h, BF16_REL)
                for what, (ex, kern) in refs.items():
                    gaps[f"unsplit {what} to exact"] = _r3_gap(kern, ex)
                caches = {}
                if form == "head_dim":
                    caches = _head_dim_checks(cfg, attn, tp, kv_seen, pool,
                                              pos, close, bad, gaps)
                    kv_shape = (cfg.d_model, (cfg.n_heads + 2
                                              * cfg.n_kv_heads)
                                * cfg.head_dim // tp)
                    kv_rows = {tuple(x.shape), tuple(xd.shape)}
                    for r in range(tp):
                        rows = {xs for xs, ws in mm_seen.get(r, ())
                                if ws == kv_shape}
                        if not kv_rows <= rows:
                            bad.append(f"shard {r}: fp16_matmul at "
                                       f"{kv_shape} took x {rows}, not "
                                       f"the prefill's and the decode "
                                       f"step's {kv_rows}")
                    gaps["K/V product fp16_matmul (x, w)"] = sorted(
                        {(xs, ws) for xs, ws in mm_seen.get(0, ())
                         if ws == kv_shape})
                for r, o in enumerate(outs):
                    for key, got in (("prefill wo", o["sp"]),
                                     ("decode wo", o["sd"]),
                                     ("MLP down", o["sm"])):
                        ex, kern = refs[key]
                        close(f"{key} sum to exact shard {r}", got, ex,
                              R3_REL)
                        what = f"{key} sum to unsplit"   # printed only
                        gaps[what] = max(gaps.get(what, 0.0),
                                         _r3_gap(got, kern))
                    unsplit = {}
                    for k in ("k", "v"):
                        unsplit[f"prefill cache {k}"] = (
                            o["cp"][k], want_pc[k].chunk(tp, split[0])[r])
                        unsplit[f"decode cache {k}"] = (
                            o["mine"][k], whole[k].chunk(tp, split[1])[r])
                    for what, (got, want) in unsplit.items():
                        if caches:   # printed only; held to ``caches``
                            key = f"{what} to unsplit"
                            gaps[key] = max(gaps.get(key, 0.0),
                                            _r3_gap(got, want))
                            want = caches[what][r]
                        close(f"{what} shard {r}", got, want, R3_REL)
                    for what, got, want, rel in (
                            ("prefill output", o["yp"], want_p, R3_OUT_REL),
                            ("decode output", o["yd"], want_d, R3_OUT_REL),
                            ("MLP output", o["ym"], want_m, R3_OUT_REL)):
                        close(f"{what} shard {r}", got, want, rel)
                    if not torch.equal(o["xs"], want_x):
                        bad.append(f"shard {r}: the embedding differs")
                close("head columns",
                      torch.cat([o["ls"] for o in outs], -1), want_l,
                      R3_REL)
                want_ids = torch.argmax(want_l[:, -1], -1).to(torch.int32)
                bad += [f"sharded_argmax {o['ids'].tolist()} against "
                        f"{want_ids.tolist()}" for o in outs
                        if not torch.equal(o["ids"], want_ids)]
                shown = {k: v if isinstance(v, (list, int)) else f"{v:.3g}"
                         for k, v in gaps.items()}
                _log(f"[{phase}] {cfg.name} layer at tp={tp} ({form}), "
                     f"{lanes} lanes x {R3_PROMPT} ids, a decode step over "
                     f"{R3_CACHE} positions: largest gap over the largest "
                     f"magnitude {shown}"
                     f"; embedding bit-equal {not any('embedding' in b for b in bad)}, "
                     f"ids {want_ids.tolist()}; launches {counts}; "
                     f"{time.monotonic() - t0:.2f} s")
                if bad:
                    raise AssertionError(f"[{phase}] tp={tp} {form}: "
                                         f"{'; '.join(bad)}")
                for k in ("fp16_matmul", "flash_attention"):
                    if counts[k] < 1:
                        raise AssertionError(f"[{phase}] tp={tp}: {k} never "
                                             f"launched")
                    launches[k] = launches.get(k, 0) + counts[k]
        finally:
            A._project_out = plain_out
    del params, block, attn, unit, head, pool, whole, outs, seen, kv_seen
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")
    return launches


@contextlib.contextmanager
def _mm_shapes():
    """``models.layers.dispatch`` wrapped for the block so that each
    ``fp16_matmul`` call's (x shape, w shape) is kept under the calling
    shard's rank (-1 outside a split): yields {rank: [(x, w), ...]}."""
    from repro_torch.models import layers as L
    real, seen = L.dispatch, {}

    def spy(name, *args, **kwargs):
        if name == "fp16_matmul":
            axis = L.model_axis()
            seen.setdefault(-1 if axis is None else axis.rank, []).append(
                (tuple(args[0].shape), tuple(args[1].shape)))
        return real(name, *args, **kwargs)
    L.dispatch = spy
    try:
        yield seen
    finally:
        L.dispatch = real


def _head_dim_checks(cfg, attn: dict, tp: int, seen: dict, pool: dict, pos,
                     close, bad: list, gaps: dict) -> dict:
    """r3's checks of the ``head_dim`` form's fused Q/K/V products, from
    ``_spied(A, "_head_dim_qkv")``'s record ``seen`` (each shard's
    prefill, then its decode step): each shard's bf16 product must lie,
    element by element, where its exact (f64) product moved by at most
    ``R3_REL`` of its largest magnitude rounds once (the f32 sum's order
    may move a near-tie across a rounding boundary, nothing more);
    returns the cache slices the unsplit layer's K and V path (biases,
    qk-norm, rope) makes from the shards' products side by side, each
    shard's slice of them: {"prefill cache k": [slice of each shard],
    ...}, the decode's written into ``pool``'s slice at ``pos``."""
    import torch

    from repro_torch.models import attention as A
    from repro_torch.models.layers import rope
    flips = "K/V product elements rounded apart from exact"
    gaps[flips] = 0
    for j in range(2):
        for r in range(tp):
            (p, x, _), got = seen[r][j]
            ws = torch.cat([p[k].reshape(cfg.d_model, -1)
                            for k in ("wq", "wk", "wv")], 1)
            exact = x.double().reshape(-1, cfg.d_model) @ ws.double()
            got = torch.cat([t.flatten(-2) for t in got], -1).reshape(
                exact.shape)
            tol = R3_REL * float(exact.abs().max())
            lo, hi = (exact - tol).to(got.dtype), (exact + tol).to(got.dtype)
            off = int(((got < lo) | (got > hi)).sum())
            gaps[flips] += int((got != exact.to(got.dtype)).sum())
            gap = _r3_gap(got, exact)     # printed only: half a bf16 step
            gaps["K/V product to exact"] = max(
                gaps.get("K/V product to exact", 0.0), gap)
            if off:
                bad.append(f"shard {r}'s fused Q/K/V product ({j}): {off} "
                           f"elements off the exact product rounded once "
                           f"within {R3_REL} of its largest magnitude")
    b = pos.shape[0]
    posq = pos[:, None]
    out = {}
    for j, when in enumerate(("prefill", "decode")):
        k = torch.cat([seen[r][j][1][1] for r in range(tp)], -1)
        v = torch.cat([seen[r][j][1][2] for r in range(tp)], -1)
        at = torch.arange(k.shape[1], device=k.device).expand(b, -1) \
            if when == "prefill" else posq
        k = rope(A.bias_norm(attn, k, cfg, "k"), at, cfg.rope_theta)
        v = A.bias_norm(attn, v, cfg, "v")
        for key, t in (("k", k), ("v", v)):
            sl = t.chunk(tp, -1)
            if when == "decode":
                rows = (0, torch.arange(b, device=k.device)[:, None], posq)
                mine = [pool[key].chunk(tp, -1)[r].clone()
                        for r in range(tp)]
                for c, new in zip(mine, sl):
                    c[rows] = new.to(c.dtype)
                sl = mine
            out[f"{when} cache {key}"] = sl
    return out


def run_r4(phase: str, arch: str = R3_ARCH, layers=None,
           forms: dict = R4_FORMS,
           tol: float = LOGIT_REL_TOL_DECODER, tp: int = R4_TP,
           kernels: tuple = ("fp16_matmul", "flash_attention")) -> None:
    """Phase r4: the split of a four-card ``launch.serve_mesh`` run on a
    1x4 mesh, on one card. ``arch`` (r1's qwen3-4b, 36 layers, or an
    ``R4_MORE`` model cut to ``layers``; bf16 weights drawn on the card)
    runs its unmeshed prefill and ``R_STEPS`` greedy decode steps
    (``_r_serve``), then the same steps shard by shard: a thread a rank
    of ``tp`` (``run_shards`` with ``forms``: the whole plain weights,
    each unit split as the mesh splits it, the collectives met in
    memory), fed the unmeshed run's ids. Each step's logits, gathered
    over the ranks, within ``tol`` of the unmeshed ones' largest, the
    greedy ids equal but at near-ties (``TIE_MARGIN``), every unit split
    in its form and none whole (``split_counts``), ``kernels`` launched
    and, where the attention takes the ``param_embed`` form, each
    shard's prefill attention its block of the query positions at its
    ``q_offset`` (context parallelism). It prints each step's gap: the
    four-card run's own gap holds the same splits of the same products,
    summed by ``nccl`` in its order. For xLSTM it also prints a
    yardstick: the unmeshed steps, fed the same ids, with each bf16
    product rounded from its exact sum instead of the library's (an
    equally valid rounding), against the unmeshed run."""
    import torch

    from repro_torch.kernels.api import DispatchContext, use_context
    from repro_torch.models.layers import (gather_context, layer_params,
                                           reset_split_counts, split_counts)
    from repro_torch.parallel.model_axis import run_shards
    from repro_torch.train.step import make_decode_step, make_prefill_step

    t_phase = time.monotonic()
    model, params, batch = _r_setup(arch, layers)
    want, ids = _r_serve(model, params, batch)[:2]
    vocab = model.cfg.vocab
    pos = batch["tokens"].shape[1]
    zero_counts()
    reset_split_counts()

    def one(axis):
        with torch.no_grad(), gather_context(model=axis):
            lp = layer_params(params, model.param_axes())
            decode = make_decode_step(model)
            last, cache = make_prefill_step(model)(lp, batch)
            out = [axis.all_gather(last, dim=-1)]
            for t, nxt in enumerate(ids):
                last, cache = decode(lp, cache, nxt, pos + t)
                out.append(axis.all_gather(last, dim=-1))
        return out if axis.rank == 0 else None
    # serve_row_tp: a context-parallel prefill, each shard its block
    cp = forms.get("attention") == "param_embed"
    with use_context(DispatchContext.for_platform("h100-sxm")), \
            (_query_blocks() if cp else contextlib.nullcontext({})) \
            as blocks:
        got = run_shards(tp, one, forms)[0]
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in launch_counters().items()}
    splits = {f"{u}:{f}": n for (u, f), n in split_counts().items()}
    cp_line = "" if not cp else (
        f"; the last shard's query blocks (rows, q_offset) "
        f"{sorted(set(blocks.get(tp - 1, [])))}")
    yard = ""
    if model.cfg.xlstm:
        from repro_torch.models import xlstm
        library = xlstm._bf16_mm
        xlstm._bf16_mm = lambda x, w: (x.to(torch.bfloat16).double()
                                       @ w.to(torch.bfloat16).double()
                                       ).to(torch.bfloat16)
        try:
            with use_context(DispatchContext.for_platform("h100-sxm")), \
                    torch.no_grad():
                decode = make_decode_step(model)
                last, cache = make_prefill_step(model)(params, batch)
                exact = [last]
                for t, nxt in enumerate(ids):
                    last, cache = decode(params, cache, nxt, pos + t)
                    exact.append(last)
        finally:
            xlstm._bf16_mm = library
        yard = "; exactly rounded unsplit steps against the unmeshed " \
            "ones (the yardstick) " + str([
                f"{float((e - w)[:, :vocab].abs().max() / w[:, :vocab].float().abs().max()):.4g}"
                for e, w in zip(exact, want)])
    gaps, flips = [], []
    for t, (g, w) in enumerate(zip(got, want)):
        g, w = g[:, :vocab].float(), w[:, :vocab].float()
        gaps.append(float((g - w).abs().max() / w.abs().max()))
        if t < len(ids):
            gi = g.argmax(-1)
            flips += [(t, r, _tie_gap(w[r], int(ids[t][r, 0]), int(gi[r])))
                      for r in torch.nonzero(gi != ids[t][:, 0]).flatten()
                      .tolist()]
    _log(f"[{phase}] {model.cfg.name} ({model.cfg.n_layers} layers) split "
         f"over {tp} shard by shard, {R_LANES} lanes x "
         f"{batch['tokens'].shape[1]} ids, {R_STEPS} decode steps fed the "
         f"unmeshed ids: logits gap over the largest a step "
         f"{[f'{x:.4g}' for x in gaps]} (bound {tol}); "
         f"greedy flips (step, lane, margin) {flips}; splits {splits}; "
         f"launches {counts}{cp_line}{yard}; "
         f"{time.monotonic() - t_phase:.2f} s")
    bad = _blocks_bad(blocks, tp) if cp else []
    if bad:
        raise AssertionError(f"[{phase}] {'; '.join(bad)}")
    want_splits = {f"{u}:{f}" for u, f in forms.items()}
    if set(splits) != want_splits:
        raise AssertionError(f"[{phase}] units split {splits}, not "
                             f"{sorted(want_splits)}")
    if max(gaps) > tol:
        raise AssertionError(f"[{phase}] logits {max(gaps)} of the "
                             f"largest apart")
    if any(m >= TIE_MARGIN for *_, m in flips):
        raise AssertionError(f"[{phase}] a greedy id flipped off a "
                             f"near-tie: {flips}")
    for k in kernels:
        if counts[k] < 1:
            raise AssertionError(f"[{phase}] {k} never launched")
    del model, params, batch, want, got
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _spied(module, name: str):
    """``module.name`` wrapped for the block so that each call's
    arguments and result are kept under the calling shard's rank (-1
    outside a split): yields {rank: [(args, result), ...]}."""
    from repro_torch.models.layers import model_axis
    real, seen = getattr(module, name), {}

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        axis = model_axis()
        seen.setdefault(-1 if axis is None else axis.rank, []).append(
            (args, out))
        return out
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _exact_combine(sel_tok, y_e, n: int):
    """``moe._combine`` of every expert's entries (``sel_tok`` (b, E, C),
    ``y_e`` (b, E * C, d)) in f64: a one-hot product over the entries,
    each token's at most top_k terms summed to f64's rounding."""
    import torch
    flat = sel_tok.reshape(sel_tok.shape[0], -1)
    onehot = (flat[:, None, :] == torch.arange(
        n, device=flat.device)[:, None]).double()
    return torch.matmul(onehot, y_e.double())


def run_r5(phase: str) -> None:
    """Phase r5: the units this split adds, at full width, shard by shard
    on the card (``R5_SPLITS``): one MoE layer in the ``experts`` or
    ``expert_ff`` form, or one mamba block in the ``inner`` form, each
    shard in a thread (``run_shards``) on its ``split_unit`` of seeded
    bf16 weights. Four lanes of a prefill of ``R3_PROMPT`` positions, then
    a decode step on what it left (the routing counts; the mamba state,
    its ``h`` a shard's heads and its ``conv`` tail whole), against the
    unsplit unit:

    * each all-reduced sum (the experts form's combine, the expert_ff
      form's ``down``, the mamba block's ``wo``) within ``R3_REL`` of the
      exact (f64) sum of the shards' own bf16 inputs;
    * the outputs within ``R3_OUT_REL`` of the unsplit unit's, the mamba
      state within ``BF16_REL``, the routing counts equal;
    * the unsplit combine (the gather-sum) within ``F32_REL`` of the f64
      sum of its own entries."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe, ssm
    from repro_torch.models.layers import gather_context, split_unit
    from repro_torch.parallel.model_axis import run_shards

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED)
    for arch, unit, tp, form in R5_SPLITS:
        t0 = time.monotonic()
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        init = moe.init_moe if unit == "moe" else ssm.init_mamba
        p = init(gen, cfg, "cuda", torch.bfloat16)
        xs = [torch.from_numpy(rng.standard_normal(
            (R_LANES, s, cfg.d_model)).astype(np.float32)).cuda()
            .to(torch.bfloat16) for s in (R3_PROMPT, 1)]
        zero = torch.zeros((R_LANES, cfg.n_experts), dtype=torch.int32,
                           device="cuda")

        def run(q, axis=None):
            """The prefill, then a decode step: [(output, state, the last
            all-reduced sum)] (the sum None unsplit)."""
            out, state = [], zero if unit == "moe" else None
            for mode, x in zip(("prefill", "decode"), xs):
                if unit == "moe":
                    y, state = moe.moe_ffn(q, x, cfg, route_counts=state)
                else:
                    y, state = ssm.mamba_block(q, x, cfg, mode=mode,
                                               cache=state)
                out.append((y, state, None if axis is None
                            else axis.reduced[-1]))
            return out

        def one(axis):
            with torch.no_grad(), gather_context(model=axis):
                return run(split_unit(p, axis, form), axis)

        # the calls whose inputs make each shard's all-reduced sum
        target = {"experts": (moe, "_combine"),
                  "expert_ff": (moe, "_partial_down"),
                  "inner": (ssm, "_wo")}[form]
        with torch.no_grad(), _spied(moe, "_combine") as combines, \
                _spied(*target) as seen:
            want = run(p)
            outs = run_shards(tp, one)
        torch.cuda.synchronize()
        gaps, bad = {}, []

        def close(what, got, ref, rel):
            g = _r3_gap(got, ref)
            key = what.split(" shard")[0]
            gaps[key] = max(gaps.get(key, 0.0), g)
            if not g <= rel:
                bad.append(f"{what}: {g:.3g} > {rel:.3g}")
        for step in range(2):
            if unit == "moe":
                (sel, y_e, top_i, *_), out = combines[-1][step]
                close(f"unsplit combine to exact, step {step}", out,
                      _exact_combine(sel, y_e, top_i.shape[-2]), F32_REL)
            parts = [seen[r][step][0] for r in range(tp)]
            if form == "experts":
                b, d = R_LANES, cfg.d_model
                sel = torch.cat([a[0] for a in parts], 1)
                y_e = torch.cat([a[1].reshape(b, a[0].shape[1], -1, d)
                                 for a in parts], 1).reshape(b, -1, d)
                exact = _exact_combine(sel, y_e, parts[0][2].shape[-2])
            else:
                exact = torch.matmul(
                    torch.cat([a[0] for a in parts], -1).double(),
                    torch.cat([a[1] for a in parts], -2).double())
            y_w, s_w, _ = want[step]
            for r, o in enumerate(outs):
                y, st, summed = o[step]
                close(f"sum to exact, step {step} shard {r}", summed,
                      exact.reshape(summed.shape), R3_REL)
                close(f"output, step {step} shard {r}", y, y_w, R3_OUT_REL)
                if unit == "moe":
                    if not torch.equal(st, s_w):
                        bad.append(f"step {step} shard {r}: the routing "
                                   f"counts differ")
                else:
                    close(f"state h, step {step} shard {r}", st["h"],
                          s_w["h"].chunk(tp, 1)[r], BF16_REL)
                    close(f"conv tail, step {step} shard {r}", st["conv"],
                          s_w["conv"], BF16_REL)
        _log(f"[{phase}] {arch} {unit} at tp={tp} ({form}), {R_LANES} lanes,"
             f" a prefill of {R3_PROMPT} positions and a decode step: "
             f"largest gap over the largest magnitude "
             f"{({k: f'{v:.3g}' for k, v in gaps.items()})}; "
             f"{time.monotonic() - t0:.2f} s")
        if bad:
            raise AssertionError(f"[{phase}] {arch} tp={tp} {form}: "
                                 f"{'; '.join(bad)}")
        del p, xs, want, outs, combines, seen
        gc.collect()
        torch.cuda.empty_cache()
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")


@contextlib.contextmanager
def _query_blocks():
    """``models.attention.dispatch`` wrapped for the block so that each
    ``flash_attention`` call's (query rows, ``q_offset``) is kept under
    the calling shard's rank (-1 outside a split): yields {rank: [(rows,
    offset), ...]}."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import model_axis
    real, seen = A.dispatch, {}

    def spy(name, *args, **kwargs):
        if name == "flash_attention":
            axis = model_axis()
            seen.setdefault(-1 if axis is None else axis.rank, []).append(
                (args[0].shape[1], kwargs.get("q_offset")))
        return real(name, *args, **kwargs)
    A.dispatch = spy
    try:
        yield seen
    finally:
        A.dispatch = real


def _blocks_bad(seen: dict, tp: int) -> list:
    """The context-parallel prefill's faults in ``_query_blocks``'
    record: a shard with no ``flash_attention`` call, or one not of its
    block (rows at ``q_offset`` rank * rows)."""
    return [f"shard {r}'s flash_attention calls (rows, q_offset) "
            f"{seen.get(r, [])[:4]}" for r in range(tp)
            if not seen.get(r) or any(off != r * rows
                                      for rows, off in seen[r])]


@contextlib.contextmanager
def _row_sums(module, name: str):
    """``module.name`` (a row-parallel product, ``(x, w, dtype=...,
    compute_dtype=...)``) wrapped for the block so that each call's
    operands, cast as the product casts them, and the sum its all-reduce
    made are kept under the calling shard's rank: yields {rank: [(x, w,
    sum), ...]}."""
    import torch

    from repro_torch.models.layers import model_axis
    real, seen = getattr(module, name), {}

    def spy(x, w, dtype=torch.bfloat16, compute_dtype=None):
        kw = {} if compute_dtype is None else {"compute_dtype":
                                               compute_dtype}
        out = real(x, w, dtype, **kw)
        axis = model_axis()
        cd = compute_dtype or dtype
        keep = cd == torch.float32 and w.dtype == torch.bfloat16
        seen.setdefault(axis.rank, []).append(
            (x.to(cd), w if keep else w.to(cd), axis.reduced[-1]))
        return out
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _sums_to_exact(seen: dict, tp: int, close) -> int:
    """Each shard's all-reduced sum of every call ``_row_sums`` kept
    against the exact (f64) product of the shards' operands side by side
    (``close(what, got, exact)``). Returns the calls a shard made."""
    calls = len(seen[0])
    for j in range(calls):
        exact = None
        for r in range(tp):
            x, w, _ = seen[r][j]
            part = x.double().reshape(-1, x.shape[-1]) \
                @ w.double().reshape(w.shape[0], -1)
            exact = part if exact is None else exact + part
        exact = exact.float()
        for r in range(tp):
            got = seen[r][j][2]
            close(f"sums to exact shard {r}, call {j}",
                  got.reshape(exact.shape), exact)
        seen_j = [seen[r][j] for r in range(tp)]
        for r in range(tp):
            seen[r][j] = None
        del seen_j, exact
    return calls


def run_r5_units(phase: str) -> None:
    """Phase r5 for the units the xLSTM and ``serve_row_tp`` split adds
    (``R5_UNITS``), at full width, shard by shard on the card (a thread a
    shard, ``run_shards``, on its ``split_unit`` of seeded weights: bf16
    for the attention layers, f32 for the xLSTM blocks as the model
    stores them). Four lanes: a prefill of ``R3_PROMPT`` positions, then
    a decode step (the attention over an ``R3_CACHE``-position cache, an
    xLSTM block on the state its prefill left), against the unsplit
    unit:

    * each all-reduced sum of a row-parallel product within ``R3_REL``
      of the exact (f64) sum of the shards' own operands;
    * the outputs (the attention's, the MLP's, the xLSTM block's) within
      ``R3_OUT_REL`` of the unsplit unit's, the untied head's f32 logits
      within ``R3_REL`` and their argmax equal;
    * each shard's KV cache (its head_dim slice) and xLSTM state (its
      heads, or whole) within ``BF16_REL`` of its part of the unsplit
      one: K and V are themselves row-parallel sums, each rounded once
      to bf16, so an element whose sum lies at a bf16 rounding boundary
      rounds to the other side of it than the unsplit product's;
    * ``fp16_matmul`` launched, ``flash_attention`` for an attention
      layer (each shard's prefill on its block of the query positions at
      its ``q_offset``: context parallelism) and ``slstm_scan`` for an
      sLSTM block (one head a shard over 4)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.api import DispatchContext, use_context
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm
    from repro_torch.models.model import build
    from repro_torch.parallel.model_axis import run_shards

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED)

    def draw(shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) * scale).cuda().to(torch.bfloat16)
    for arch, unit, tp, form in R5_UNITS:
        t0 = time.monotonic()
        cfg = get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = draw((R_LANES, R3_PROMPT, cfg.d_model))
        xd = draw((R_LANES, 1, cfg.d_model))
        gaps, bad = {}, []

        def close(what, got, want, rel=R3_REL):
            g = _r3_gap(got, want)
            key = what.split(" shard")[0]
            gaps[key] = max(gaps.get(key, 0.0), g)
            if not g <= rel:
                bad.append(f"{what}: {g:.3g} > {rel:.3g}")
        if unit in ("mlstm", "slstm"):
            init, block, cache0 = {
                "mlstm": (xlstm.init_mlstm, xlstm.mlstm_block,
                          xlstm.init_mlstm_cache),
                "slstm": (xlstm.init_slstm, xlstm.slstm_block,
                          xlstm.init_slstm_cache)}[unit]
            p = init(gen, cfg, "cuda")
            kernels = ("fp16_matmul",) + (("slstm_scan",)
                                          if unit == "slstm" else ())

            def run(q):
                y, st = block(q, x, cfg, mode="prefill",
                              cache=cache0(cfg, R_LANES, device="cuda"))
                yd, st = block(q, xd, cfg, mode="decode", cache=st)
                return y, yd, st

            def one(axis):
                with torch.no_grad(), L.gather_context(model=axis):
                    return run(L.split_unit(p, axis, form))
            with use_context(DispatchContext.for_platform("h100-sxm")), \
                    torch.no_grad():
                want = run(p)
                zero_counts()
                with _row_sums(xlstm, "_row_mm") as seen:
                    outs = run_shards(tp, one)
                    torch.cuda.synchronize()
                    counts = {k: fn.launches
                              for k, fn in launch_counters().items()}
                    calls = _sums_to_exact(seen, tp, close)
            for r, (y, yd, st) in enumerate(outs):
                close(f"prefill output shard {r}", y, want[0], R3_OUT_REL)
                close(f"decode output shard {r}", yd, want[1], R3_OUT_REL)
                for key, t in st.items():
                    dim = L.model_dim(t)
                    ref = want[2][key] if dim is None \
                        else want[2][key].chunk(tp, dim)[r]
                    close(f"state {key} shard {r}", t, ref, BF16_REL)
            shape = f"{cfg.n_heads // tp if form != 'param_embed' else cfg.n_heads} heads a shard"
            del p, want, outs
        else:
            layers = 2 if cfg.local_global else 1
            mcfg = dataclasses.replace(cfg, n_layers=layers)
            params = build(mcfg).init_values(gen, device="cuda",
                                             dtype=torch.bfloat16)
            seg = L.layer_slice(params["segments"], 0)
            bp = seg["block0" if unit == "local" or layers == 1
                     else "block1"]
            attn, mlp_p = bp["attn"], bp["mlp"]
            head = params.get("lm_head")
            pool = {k: draw((1, R_LANES, R3_CACHE, cfg.n_kv_heads,
                             cfg.head_dim)) for k in ("k", "v")}
            pos = torch.tensor([R3_CACHE - 1, R3_PROMPT, R3_PROMPT // 2,
                                17], device="cuda")
            last = x[:, -1:]
            kernels = ("fp16_matmul", "flash_attention")

            def run(pa, pm, ph, cache):
                yp, cp = A.attention(pa, x, cfg, kind=unit, mode="prefill",
                                     use_rope=True)
                yd, _ = A.attention(pa, xd, cfg, kind=unit, mode="decode",
                                    cache=cache, pos=pos, layer_idx=0,
                                    use_rope=True)
                ym = L.mlp(pm, x, cfg.act)
                lg = None if ph is None else L.logits_head(
                    params["embed"], last, cfg.vocab, head=ph)
                return yp, cp, yd, cache, ym, lg

            def one(axis):
                with torch.no_grad(), L.gather_context(model=axis):
                    mine = {k: v.chunk(tp, 4)[axis.rank].clone()
                            for k, v in pool.items()}
                    return run(L.split_unit(attn, axis, form),
                               L.split_unit(mlp_p, axis, form),
                               None if head is None else L.split_unit(
                                   head, axis, form), mine)
            with use_context(DispatchContext.for_platform("h100-sxm")), \
                    torch.no_grad():
                want = run(attn, mlp_p, head,
                           {k: v.clone() for k, v in pool.items()})
                zero_counts()
                with _row_sums(A, "row_parallel_mm") as seen_a, \
                        _row_sums(L, "row_parallel_mm") as seen_l, \
                        _query_blocks() as blocks:
                    outs = run_shards(tp, one)
                    torch.cuda.synchronize()
                    counts = {k: fn.launches
                              for k, fn in launch_counters().items()}
                    calls = _sums_to_exact(seen_a, tp, close) \
                        + _sums_to_exact(seen_l, tp, close)
            wp, wcp, wd, wpool, wm, wl = want
            for r, (yp, cp, yd, mine, ym, lg) in enumerate(outs):
                close(f"prefill output shard {r}", yp, wp, R3_OUT_REL)
                close(f"decode output shard {r}", yd, wd, R3_OUT_REL)
                close(f"MLP output shard {r}", ym, wm, R3_OUT_REL)
                for k in ("k", "v"):
                    close(f"prefill cache {k} shard {r}", cp[k],
                          wcp[k].chunk(tp, 3)[r], BF16_REL)
                    close(f"decode cache {k} shard {r}", mine[k],
                          wpool[k].chunk(tp, 4)[r], BF16_REL)
                if lg is not None:
                    close(f"head logits shard {r}", lg, wl)
                    if not torch.equal(lg.argmax(-1), wl.argmax(-1)):
                        bad.append(f"shard {r}: the head's argmax differs")
            bad += _blocks_bad(blocks, tp)
            shape = (f"{cfg.n_heads} heads, d_model {cfg.d_model // tp} "
                     f"and head_dim {cfg.head_dim // tp} a shard, the "
                     f"prefill's query block (rows, q_offset) "
                     f"{blocks.get(tp - 1, [None])[0]} on the last")
            del params, seg, bp, attn, mlp_p, head, pool, want, outs
        _log(f"[{phase}] {arch} {unit} at tp={tp} ({form}, {shape}), "
             f"{R_LANES} lanes, a prefill of {R3_PROMPT} positions and a "
             f"decode step: {calls} row-parallel sums a shard; largest gap "
             f"over the largest magnitude "
             f"{({k: f'{v:.3g}' for k, v in gaps.items()})}; launches "
             f"{counts}; {time.monotonic() - t0:.2f} s")
        bad += [f"{k} never launched" for k in kernels if counts[k] < 1]
        if bad:
            raise AssertionError(f"[{phase}] {arch} {unit} tp={tp} {form}: "
                                 f"{'; '.join(bad)}")
        gc.collect()
        torch.cuda.empty_cache()
    _log(f"[{phase}] phase wall {time.monotonic() - t_phase:.2f} s")


def run_phase_r() -> dict:
    """Phase r: the meshed serving steps. r2's traces (processes of their
    own) run while r1 holds the meshed steps to the unmeshed ones on the
    card in a one-rank group. Returns r1's launch counts, summed."""
    import torch

    t_phase = time.monotonic()
    procs = start_r2()
    launches = {}
    try:
        with one_rank_group() as mesh:
            for arch in R_PROMPT:
                for k, n in run_r1(f"r1: {arch}, meshed vs unmeshed", arch,
                                   mesh).items():
                    launches[k] = launches.get(k, 0) + n
    except BaseException:
        _kill_dryruns(procs)
        raise
    gc.collect()
    torch.cuda.empty_cache()
    try:
        run_r3(f"r3: {R3_ARCH} layer split over model, shard by shard")
        run_r4(f"r4: {R3_ARCH} split over {R4_TP}, shard by shard")
        for arch, layers, forms, tol in R4_MORE:
            run_r4(f"r4: {arch} split over {R4_TP}, shard by shard", arch,
                   layers, forms, tol)
        for arch, layers, tp, forms, kernels in R4_SPLIT:
            run_r4(f"r4: {arch} split over {tp}, shard by shard", arch,
                   layers, forms, LOGIT_REL_TOL_DECODER, tp, kernels)
        run_r5("r5: MoE and mamba units split over model, shard by shard")
        run_r5_units("r5: xLSTM and serve_row_tp units split over model, "
                     "shard by shard")
    except BaseException:
        _kill_dryruns(procs)
        raise
    finish_r2("r2: serving cells on 16x16", procs, t_phase)
    _log(f"[r] phase wall {time.monotonic() - t_phase:.2f} s")
    return launches


def kernels_after_training(phase: str) -> None:
    """A dispatched ``fp16_matmul`` on CUDA tensors right after training
    routes ("accel", "cuda") and launches the kernel: the grad-safe
    context was the train step's alone."""
    import torch

    from repro_torch.kernels.api import dispatch, dispatch_counters
    zero_counts()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(4, 384, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(384, 1536, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    dispatch("fp16_matmul", x, w, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    routing = dict(dispatch_counters())
    n = launch_counters()["fp16_matmul"].launches
    _log(f"[{phase}] after training: dispatch {routing}, fp16_matmul "
         f"launches {n}")
    if routing != {("fp16_matmul", "accel", "cuda"): 1} or n < 1:
        raise AssertionError(f"[{phase}] fp16_matmul after training did "
                             f"not launch its kernel")
    zero_counts()


def stop_children() -> list:
    """Kill every process below this one that is still running, parents
    first, and return their command lines. There should be none: the
    kernel build and ``nvidia-smi`` wait for their own, and the build
    kills an unfinished ``nvcc`` with its compiler stages when it
    raises."""
    try:
        from repro_torch.kernels.build import descendants
    except ImportError:       # the script alone, without the repository:
        return []             # it started nothing
    tree = descendants(os.getpid())
    cmds = []
    for pid in tree:
        try:
            with open(f"/proc/{pid}/cmdline") as f:
                cmds.append(f.read().replace("\0", " ").strip())
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    for pid in tree:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    return cmds


def _terminated(signum, frame):
    """SIGTERM ends the run through ``SystemExit``, so that the build's
    and ``__main__``'s clean-up runs."""
    raise SystemExit(128 + signum)


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
    res, frames, counts, c_tps, c_lane, _ = run_serve(
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
    f = run_serve(model, qparams, "f: serve q8_0 2 streams + 2 audio 4x4",
                  q8_path, "q8_0", streamed=(0, 1))
    add(f[2])

    # paged KV: phase f's serve and phase b's speculation on pages
    paged = ("paged_decode_attention",)
    add(run_paged_serve(model, qparams,
                        "g: paged serve q8_0 2 streams + 4 audio 4x4",
                        q8_path + paged, f[4]))
    add(run_paged_spec(model, params, x, "h: paged transcribe q4_0 spec_k=4",
                       mm_fa + ("q4_matmul", "q4_decode_attention") + paged,
                       draft, b_tps))

    # the SLO gateway over the captured tick, on the paper's platform
    add(run_gateway(model, qparams, "m: gateway q8_0 16 requests 4x4",
                    ("flash_attention", "q8_matmul", "q8_decode_attention")))

    # the hot-path static checks on the card
    add(run_staticcheck("n: staticcheck", (
        "fp16_matmul", "flash_attention", "q8_matmul", "q8_decode_attention",
        "q4_matmul", "q4_decode_attention", "slstm_scan",
        "paged_decode_attention")))

    del params, qparams, draft, model
    gc.collect()
    torch.cuda.empty_cache()

    # the decoder-only families at full width (qwen3-moe-30b-a3b at 8 of
    # its 48 layers), token requests
    fa_path = ("fp16_matmul", "flash_attention")
    model, params, prompts = decoder_model("qwen3-4b")
    add(run_decoder("i1: serve qwen3-4b bf16 4x4", model, params, prompts,
                    fa_path, "bf16")[0])
    qparams = model.quantize(params)
    del params
    add(run_decoder("i2: serve qwen3-4b q8_0 4x4", model, qparams, prompts,
                    ("flash_attention", "q8_matmul", "q8_decode_attention"),
                    "q8_0")[0])
    del qparams, model
    gc.collect()
    torch.cuda.empty_cache()
    model, params, prompts = decoder_model("qwen3-moe-30b-a3b")
    add(run_decoder("j: serve qwen3-moe-30b-a3b (8 layers) q8_0 cache 4x4",
                    model, params, prompts,
                    fa_path + ("q8_decode_attention",), "q8_0")[0])
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    model, params, prompts = decoder_model("gemma2-2b")
    add(run_decoder("k: serve gemma2-2b bf16 4x4", model, params, prompts,
                    fa_path, "bf16")[0])
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    model, params, prompts = decoder_model("zamba2-7b")
    add(run_decoder("l: serve zamba2-7b bf16 4x4", model, params, prompts,
                    fa_path, "bf16")[0])
    del params, model
    gc.collect()
    torch.cuda.empty_cache()

    add(run_xlstm("d: serve xlstm-350m 4x4")[0])

    # training on the card: the grad-safe torch bindings, no kernel
    gc.collect()
    torch.cuda.empty_cache()
    run_train_o1("o1: train whisper-tiny.en 20 steps, resume at 10")
    gc.collect()
    torch.cuda.empty_cache()
    run_train_o2("o2: train qwen3-4b (4 layers) 8 steps")
    kernels_after_training("o")
    gc.collect()
    torch.cuda.empty_cache()
    run_train_p()
    kernels_after_training("p")
    run_phase_q()
    add(run_phase_r())

    _log(f"chip_smoke: {time.monotonic() - t_start:.1f} s wall")
    left = stop_children()
    if left:
        raise AssertionError(f"processes started by this run were still "
                             f"running at its end (killed): {left}")
    _log("processes started by this run and still running: none")
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
    signal.signal(signal.SIGTERM, _terminated)
    try:
        rc = main()
    finally:
        stop_children()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave at once: the card's state (captured graphs, the allocator's
    # cached blocks, the context) goes with the process, where the
    # interpreter's shutdown would free it object by object after the
    # result line
    os._exit(rc)
