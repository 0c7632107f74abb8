"""End-to-end ASR launcher of the port: synthetic waveform -> log-mel
frontend -> chunked encoder -> tokens through the serving engine, on the
card (the JAX package's ``launch/transcribe.py``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.transcribe \\
        [--platform h100-sxm] [--cache-dtype q8_0] [--stream] \\
        [--decode-block 8] [--seconds 1.0] [--arch whisper-tiny-en] \\
        [--full] [--device cuda]

``--stream`` serves through the chunk-at-a-time streaming path (one
audio chunk a scheduler tick, the partial hypotheses printed); the final
transcript is token-identical to the one-shot path. ``--platform``
routes every kernel through that target's dispatch context and ends with
its modelled energy report (joules per audio second). ``--device``
defaults to ``cuda``; ``--device cpu`` runs the plain versions of the
kernels on the CPU. Weights are seeded random (``--seed``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="whisper-tiny-en")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced smoke size)")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="synthetic waveform length")
    ap.add_argument("--chunk-frames", type=int, default=16,
                    help="encoder chunk size (frame embeddings)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--stream", action="store_true",
                    help="serve via the streaming chunked-encode path")
    ap.add_argument("--cache-dtype", choices=["bf16", "q8_0", "q4_0"],
                    default="bf16")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="decode steps fused per tick (one host fetch a "
                         "tick; tokens identical for any value)")
    ap.add_argument("--platform", default=None,
                    help="registered hardware target (repro_torch."
                         "platforms, e.g. h100-sxm); enables the energy "
                         "report")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.audio.stream import synth_waveform
    from repro_torch.audio.transcribe import transcribe

    wave = synth_waveform(args.seconds, seed=args.seed)
    print(f"transcribing {args.seconds:.2f}s synthetic waveform "
          f"({len(wave)} samples) with {args.arch}"
          f"{'' if args.full else ' (reduced)'}"
          f"{', streaming' if args.stream else ''}, "
          f"cache {args.cache_dtype}"
          + (f", platform {args.platform}" if args.platform else "")
          + f", on {args.device}")
    r = transcribe(wave, 16_000, arch=args.arch, reduced=not args.full,
                   platform=args.platform, cache_dtype=args.cache_dtype,
                   decode_block=args.decode_block,
                   chunk_frames=args.chunk_frames, max_new=args.max_new,
                   stream=args.stream, seed=args.seed, device=args.device)
    if args.stream:
        for i, p in enumerate(r.partials):
            print(f"  partial[{i}]: {p}")
    print(f"tokens: {r.tokens}")
    print(f"{r.n_frames} encoder frames, {r.ticks} decode ticks "
          f"x block {r.decode_block} = {r.decode_steps} decode steps, "
          f"{r.host_syncs} decode host syncs, {r.wall_s:.2f}s wall "
          f"({r.compute_ms_per_audio_s:.0f} ms per audio second, first "
          f"calls included)")
    if r.energy:
        e = r.energy
        print(f"energy[{e['platform']}]: "
              f"{e['joules_per_audio_s']:.3e} J/audio-s, "
              f"{e['joules_per_token']:.3e} J/token "
              f"(power {e['power_w']:.3f} W, {e['bound']}-bound, "
              f"accel share {e['accel_flops_share']:.0%})")
    return r


if __name__ == "__main__":
    main()
