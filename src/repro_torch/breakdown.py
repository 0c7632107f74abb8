"""Where the time of one transcription, or of one token serve of a
decoder-only model, goes on the card.

    python -m repro_torch.breakdown [--cache-dtype bf16|q8_0|q4_0]
                                    [--spec-k K] [--paged] [--lanes N]
                                    [--eager]
    python -m repro_torch.breakdown --arch xlstm-350m [--eager]
    python -m repro_torch.breakdown --arch qwen3-4b|qwen3-moe-30b-a3b|gemma2-2b
                                    [--cache-dtype bf16|q8_0] [--eager]
    python -m repro_torch.breakdown --arch zamba2-7b [--eager]

Runs whisper-tiny.en at full width with seeded random weights on 30 s
of synthetic audio (1500 encoder frames, one chunk), 32 new tokens at 8
decode steps a tick. ``--cache-dtype q8_0`` serves Q8_0 weights with the
q8_0 cache, ``bf16`` and ``q4_0`` bf16 weights with that cache;
``--spec-k K`` makes each tick 8 / K speculative rounds (K - 1 draft
steps on Q4_0 weights, one verify forward), always on bf16 weights.
``--paged`` serves it from a page pool (``ServeEngine(paged=True)``,
pages of 8 positions; the lengths rounded up to whole pages: enc_len
1504), whose tick gathers each lane's pages before every decode
attention. ``--lanes N`` (up to 4) decodes N lanes at once, of 30, 20,
10 and 25 s of audio (the lengths of ``chip_smoke.py``'s serve phases).
``--arch xlstm-350m`` runs instead the configuration of
``chip_smoke.py``'s phase d: xlstm-350m at full width with seeded random
bf16 weights, 4 token requests of 64, 128, 192 and 256 ids admitted
into 4 slots, 32 new tokens each at 8 decode steps a tick.
``--arch qwen3-4b``, ``qwen3-moe-30b-a3b`` or ``gemma2-2b`` serves the
same requests from the configuration of ``chip_smoke.py``'s phase i, j
or k: the model at full width (qwen3-moe-30b-a3b cut to its first 8 of
48 layers, ``DECODER_LAYERS``) with seeded random bf16 weights drawn on
the card, ``max_len`` 512; ``--cache-dtype q8_0`` serves Q8_0 weights
(``Model.quantize``) with the q8_0 cache. ``--arch zamba2-7b`` runs phase
l's configuration: the hybrid at full width and depth (81 layers) with
seeded random bf16 weights drawn on the card, a bf16 cache, and prompts
of 64, 128, 192 and 300 ids (``HYBRID_PROMPTS``; the last spans two SSD
chunks of 256). It reports, after one warm-up run:

* host-clock seconds of each stage (frontend, encode, prefill, decode;
  for xLSTM prefill of the 4 prompts, decode), each ended by a device
  synchronize, from a run without the profiler;
* for the third decode tick of a further run (the engine's first two
  ticks run eagerly and capture its CUDA graph, so this one replays it;
  with ``--eager`` every tick runs eagerly), under ``torch.profiler``:
  the summed device time of its kernels and copies, their launch count,
  the kernels that take the most device time, the copies and casts
  (``copies``), and the device's busy share, that device time over the
  mean wall time of the unprofiled run's ticks from the third on (1 -
  busy is the idle share). The profiler's own host cost is left out
  that way.

Needs a CUDA device; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time

import torch

from repro_torch.audio.features import audio_frames
from repro_torch.audio.stream import synth_waveform
from repro_torch.configs import get_config
from repro_torch.models.model import build
from repro_torch.quantize import quantize_tree
from repro_torch.serving.engine import AudioRequest, Request, ServeEngine

MAX_NEW = 32
DECODE_BLOCK = 8
#: phase d of chip_smoke.py, which imports these: prompt lengths, and a
#: lane's length (the longest prompt, its new tokens and 32 to spare)
XLSTM_PROMPTS = (64, 128, 192, 256)
XLSTM_MAX_LEN = max(XLSTM_PROMPTS) + MAX_NEW + 32
#: phases i, j and k of chip_smoke.py: the decoder-only models served
#: from the same prompts, and the layers each keeps (None: all; the MoE
#: model's 48 layers are 61 GB of bf16 weights, too many to hold beside
#: its serving copies and the plain run on an 80 GB card)
DECODER_LAYERS = {"qwen3-4b": None, "qwen3-moe-30b-a3b": 8,
                  "gemma2-2b": None, "zamba2-7b": None}
DECODER_MAX_LEN = 512
#: phase l of chip_smoke.py: the hybrid's prompts, the last one over two
#: SSD chunks of 256
HYBRID_PROMPTS = (64, 128, 192, 300)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


#: the unprofiled run's ticks from this one on set the tick's wall time;
#: the profiled run profiles this tick
STEADY_TICK = 2


def _decode(eng, profile_tick: bool):
    """Tick ``eng`` until its lanes finish; with ``profile_tick``, profile
    tick ``STEADY_TICK`` and stop there. Returns (decode seconds, wall
    seconds of each tick) or the profiler."""
    walls = []
    t0 = time.monotonic()
    while eng.n_active:
        if profile_tick and len(walls) == STEADY_TICK:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                eng.step()
            return prof
        t = time.monotonic()
        eng.step()
        walls.append(time.monotonic() - t)
    if profile_tick:
        raise ValueError(f"{len(walls)} ticks: too few to reach tick "
                         f"{STEADY_TICK}")
    return time.monotonic() - t0, walls


#: the audio of each lane (chip_smoke.py's SERVE_SECONDS)
LANE_SECONDS = (30.0, 20.0, 10.0, 25.0)


def run(cache_dtype: str, spec_k: int = 0, seed: int = 0,
        cuda_graph: bool = True, paged: bool = False,
        lanes: int = 1) -> dict:
    model = build(get_config("whisper-tiny-en"))
    params = model.init_values(torch.Generator().manual_seed(seed),
                               device="cuda")
    if cache_dtype == "q8_0" and not spec_k:
        params = quantize_tree(params)
    audio = [synth_waveform(s, seed=seed + i)
             for i, s in enumerate(LANE_SECONDS[:lanes])]
    draft = quantize_tree(params, tier="q4_0") if spec_k else None

    max_len, enc_len = MAX_NEW + 3 + max(spec_k - 1, 0), 1500
    if paged:
        max_len, enc_len = -(-max_len // 8) * 8, -(-enc_len // 8) * 8

    def one(profile_tick: bool):
        eng = ServeEngine(model, params, n_slots=lanes, max_len=max_len,
                          enc_len=enc_len, cache_dtype=cache_dtype,
                          decode_block=DECODE_BLOCK, platform="h100-sxm",
                          spec_k=spec_k, draft_params=draft,
                          cuda_graph=cuda_graph, paged=paged, page_size=8)
        with torch.no_grad():
            frames, t_fe = _timed(lambda: [audio_frames(
                x, model.cfg.d_model, device="cuda") for x in audio])
        states, t_enc = _timed(lambda: [eng.encode_chunks([f])
                                        for f in frames])
        sts, t_pre = _timed(lambda: [eng.admit(AudioRequest(
            uid=i, tokens=[1], max_new=MAX_NEW, eos_id=-1,
            enc_states=s[0])) for i, s in enumerate(states)])
        if profile_tick:
            return _decode(eng, True)
        t_dec, walls = _decode(eng, False)
        return {"frontend_s": t_fe, "encode_s": t_enc,
                "prefill_s": t_pre, "decode_s": t_dec,
                "decode_tok_per_s":
                    sum(len(st.out) - 1 for st in sts) / t_dec,
                "tick_wall_s": walls, "captures": eng.captures,
                "replays": eng.replays,
                "ticks": eng._ticks, "host_syncs": eng._host_syncs,
                "draft_steps": eng._draft_steps,
                "verify_steps": eng._verify_steps,
                "acceptance_rate": eng.acceptance_rate}

    one(False)                          # warm-up: handles, kernel loads
    stages = one(False)
    prof = one(True)
    return {"cache_dtype": cache_dtype, "spec_k": spec_k, "paged": paged,
            "lanes": lanes,
            "decode_block": DECODE_BLOCK, "cuda_graph": cuda_graph,
            "stages": stages, "decode_tick": _tick_report(prof, stages)}


def _prompts(vocab: int, seed: int, lengths=XLSTM_PROMPTS) -> list:
    """Prompts of ``lengths`` ids, drawn from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=n).tolist() for n in lengths]


def xlstm_setup(seed: int = 0):
    """The configuration of ``chip_smoke.py``'s phase d: xlstm-350m at
    full width with seeded random weights cast to bf16 on the card, and
    the ``XLSTM_PROMPTS`` prompts' ids drawn from ``seed``. Returns
    (model, params, prompts)."""
    cfg = get_config("xlstm-350m")
    model = build(cfg)
    params = _bf16(model.init_values(torch.Generator().manual_seed(seed),
                                     device="cuda"))
    return model, params, _prompts(cfg.vocab, seed)


def decoder_setup(arch: str, seed: int = 0):
    """The configuration of ``chip_smoke.py``'s phase i, j, k or l:
    ``arch`` at full width, cut to ``DECODER_LAYERS[arch]`` layers where
    that is set, with seeded random weights drawn leaf by leaf by a CUDA
    generator and stored in bf16 (the f32 peak is one leaf; the hybrid's
    SSM leaves stay f32), and the ``XLSTM_PROMPTS`` prompts' ids
    (``HYBRID_PROMPTS`` for the hybrid) drawn from ``seed``. Returns
    (model, params, prompts)."""
    cfg = get_config(arch)
    if DECODER_LAYERS[arch] is not None:
        cfg = dataclasses.replace(cfg, n_layers=DECODER_LAYERS[arch])
    model = build(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_values(gen, device="cuda", dtype=torch.bfloat16)
    lengths = HYBRID_PROMPTS if cfg.family == "hybrid" else XLSTM_PROMPTS
    return model, params, _prompts(cfg.vocab, seed, lengths)


def run_tokens(arch: str, cache_dtype: str = "bf16", seed: int = 0,
               cuda_graph: bool = True) -> dict:
    """The breakdown of ``chip_smoke.py``'s phase d (xlstm-350m), i, j,
    k (the decoder-only attention models; ``cache_dtype="q8_0"``: Q8_0
    weights and the q8_0 cache) or l (zamba2-7b)."""
    if arch == "xlstm-350m":
        model, params, prompts = xlstm_setup(seed)
        max_len = XLSTM_MAX_LEN
    else:
        model, params, prompts = decoder_setup(arch, seed)
        max_len = DECODER_MAX_LEN
        if cache_dtype == "q8_0":
            params = model.quantize(params)

    def one(profile_tick: bool):
        eng = ServeEngine(model, params, n_slots=len(prompts),
                          max_len=max_len, cache_dtype=cache_dtype,
                          decode_block=DECODE_BLOCK, platform="h100-sxm",
                          cuda_graph=cuda_graph)

        def admit_all():
            return [eng.admit(Request(uid=i, tokens=p, max_new=MAX_NEW,
                                      eos_id=-1))
                    for i, p in enumerate(prompts)]

        sts, t_pre = _timed(admit_all)
        if profile_tick:
            return _decode(eng, True)
        t_dec, walls = _decode(eng, False)
        cr = eng.cache_report()
        return {"prefill_s": t_pre, "decode_s": t_dec,
                "decode_tok_per_s":
                    sum(len(st.out) - 1 for st in sts) / t_dec,
                "tick_wall_s": walls, "captures": eng.captures,
                "replays": eng.replays,
                "ticks": eng._ticks, "host_syncs": eng._host_syncs,
                "state_bytes_total": cr["state_bytes_total"],
                "state_bytes_per_step": cr["state_bytes_per_step"],
                "kv_bytes_total": cr["kv_bytes_total"]}

    one(False)                          # warm-up: handles, kernel loads
    stages = one(False)
    prof = one(True)
    return {"arch": model.cfg.name, "n_layers": model.cfg.n_layers,
            "cache_dtype": cache_dtype, "lanes": len(prompts),
            "decode_block": DECODE_BLOCK, "cuda_graph": cuda_graph,
            "stages": stages, "decode_tick": _tick_report(prof, stages)}


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


#: the port's kernels (csrc/): top-level anonymous namespace, its names
PORT_KERNEL = re.compile(r"(void )?\(anonymous namespace\)::"
                         r"(mm|q4|q8|slstm|flash|decode)_\w*kernel\b")


#: device work that copies or converts a tensor (torch's copy kernels
#: and the CUDA memcpy / memset nodes)
COPY = re.compile(r"copy|Memcpy|Memset|cast", re.IGNORECASE)

#: the library's matrix products (cuBLAS / CUTLASS kernels), which the
#: torch.matmul calls outside the port's kernels launch (the mamba and
#: mLSTM projections, batched einsums)
LIBRARY_MM = re.compile(r"gemm|gemv|cutlass|xmma|cublas|nvjet|splitK",
                        re.IGNORECASE)


def _group(name: str) -> str:
    """The share of the tick a kernel counts in: the port's own kernels,
    the library's matrix products, or the other torch kernels
    (elementwise chains, reductions, copies)."""
    if PORT_KERNEL.match(name):
        return "port_kernels"
    if LIBRARY_MM.search(name):
        return "library_matmuls"
    return "other_torch_kernels"


def _tick_report(prof, stages: dict) -> dict:
    """Device time of the profiled tick against the wall time of the
    unprofiled run's ticks from ``STEADY_TICK`` on, and its kernels by
    device time."""
    steady = stages["tick_wall_s"][STEADY_TICK:]
    t_tick = sum(steady) / len(steady)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, list] = {}
    for e in kernels:
        s = by_name.setdefault(e.name, [0, 0.0])
        s[0] += 1
        s[1] += e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    groups: dict[str, list] = {}
    for n, (c, us) in ranked:
        g = groups.setdefault(_group(n), [0, 0.0])
        g[0] += c
        g[1] += us

    def rows(items):
        return [{"name": n[:80], "count": c, "device_ms": us * 1e-3}
                for n, (c, us) in items]
    # the port's own kernels wherever they rank
    return {"unprofiled_wall_s": t_tick, "device_s": dev_us * 1e-6,
            "busy_share": dev_us * 1e-6 / t_tick,
            "kernel_launches": len(kernels),
            "groups": {g: {"count": c, "device_ms": us * 1e-3,
                           "share": us / dev_us if dev_us else 0.0}
                       for g, (c, us) in groups.items()},
            "top": rows(ranked[:10]),
            "copies": rows([kv for kv in ranked if COPY.search(kv[0])]),
            "port_kernels": rows([kv for kv in ranked
                                  if PORT_KERNEL.match(kv[0])])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=["whisper-tiny-en", "xlstm-350m",
                                       *DECODER_LAYERS],
                    default="whisper-tiny-en")
    ap.add_argument("--cache-dtype", choices=["bf16", "q8_0", "q4_0"],
                    default="bf16",
                    help="the KV-cache tier; q8_0 also quantizes the "
                         "weights unless --spec-k is given")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative rounds of K positions (K - 1 "
                         "Q4_0 draft steps, one verify); 0 = plain decode")
    ap.add_argument("--paged", action="store_true",
                    help="serve from a page pool (ServeEngine(paged=True), "
                         "pages of 8 positions)")
    ap.add_argument("--lanes", type=int, default=1,
                    choices=range(1, len(LANE_SECONDS) + 1),
                    help="lanes decoded at once (Whisper)")
    ap.add_argument("--eager", action="store_true",
                    help="run every decode tick eagerly "
                         "(cuda_graph=False) instead of replaying its "
                         "CUDA graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.breakdown needs a CUDA device")
    if args.arch != "whisper-tiny-en":
        if args.spec_k or args.paged or args.lanes != 1 or (
                args.cache_dtype != "bf16"
                and args.arch in ("xlstm-350m", "zamba2-7b")):
            raise SystemExit(f"{args.arch} serves 4 token requests without "
                             f"speculative decoding or pages (and "
                             f"xlstm-350m and zamba2-7b a bf16 pool)")
        r = run_tokens(args.arch, args.cache_dtype,
                       cuda_graph=not args.eager)
    else:
        r = run(args.cache_dtype, args.spec_k, cuda_graph=not args.eager,
                paged=args.paged, lanes=args.lanes)
    for k, v in r["stages"].items():
        print(f"{k}: {v}")
    t = r["decode_tick"]
    print(f"decode tick: unprofiled_wall_s={t['unprofiled_wall_s']} "
          f"device_s={t['device_s']} "
          f"busy_share={t['busy_share']} launches={t['kernel_launches']}")
    for g, row in t["groups"].items():
        print(f"  {g}: {row['device_ms']:.4f} ms x{row['count']} "
              f"({row['share']:.3f} of the device time)")
    for row in t["top"]:
        print(f"  {row['device_ms']:.4f} ms  x{row['count']}  {row['name']}")
    print("the port's kernels:")
    for row in t["port_kernels"]:
        print(f"  {row['device_ms']:.4f} ms  x{row['count']}  {row['name']}")
    print("copies and casts:")
    for row in t["copies"]:
        print(f"  {row['device_ms']:.4f} ms  x{row['count']}  {row['name']}")
    print(json.dumps(r))


if __name__ == "__main__":
    main()
