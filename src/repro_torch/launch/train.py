"""Training launcher of the port, on one device (the JAX package's
``launch/train.py``): the fault-tolerant ``TrainLoop`` over the synthetic
pipeline, with AdamW and checkpoints.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny-en \\
        --steps 20 --ckpt "$TMPDIR/ckpt-whisper"
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --device cpu --steps 4

``--device`` defaults to ``cuda`` and never falls back to the CPU. f32
parameters are drawn from a ``torch.Generator`` on that device seeded
with ``--seed`` (``train.setup.train_setup``). The forward binds the
differentiable torch implementations of the dispatched ops
(``grad_safe_context``): the Hopper kernels have no backward and launch
nowhere in training. A run resumes from the newest checkpoint in
``--ckpt``; without it, the checkpoints go to a new directory under the
temporary directory (``TMPDIR``), whose path is printed, so a run never
resumes one it was not pointed at. ``--warmup`` (the AdamW warmup, 100
steps as in the JAX package) is the port's one flag beyond the JAX
launcher's. ``--devices``, ``--mesh`` and ``--compress-grads`` belong to
the multi-device training the port does not have yet, and are refused.
"""

from __future__ import annotations

import argparse
import tempfile


def main(argv=None, on_step=None):
    """Train as ``argv`` says; ``on_step(step, loss)`` is called after
    each step's own log line. Returns the loop's ``LoopResult``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100,
                    help="AdamW warmup steps")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where training runs (default cuda)")
    ap.add_argument("--devices", type=int, default=0,
                    help="multi-device training: not in the port yet")
    ap.add_argument("--mesh", default="",
                    help="DxM data x model mesh: not in the port yet")
    ap.add_argument("--compress-grads", action="store_true",
                    help="compressed data-parallel gradients: not in the "
                         "port yet")
    args = ap.parse_args(argv)
    if args.devices or args.mesh or args.compress_grads:
        ap.error("--devices, --mesh and --compress-grads wait for the "
                 "port's parallel layer; training runs on one device")

    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.setup import adamw_config, train_setup
    from repro_torch.train.step import make_train_step

    model, state, ds = train_setup(
        args.arch, batch=args.batch, seq=args.seq, seed=args.seed,
        device=args.device, reduced=args.reduced)
    opt_cfg = adamw_config(args.lr, args.warmup, args.steps)
    step_fn = make_train_step(model, opt_cfg, n_micro=args.n_micro)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix=f"ckpt-{args.arch}-")
    if not args.ckpt:
        print(f"checkpoints: {ckpt_dir}", flush=True)
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    loop_cfg = LoopConfig(total_steps=args.steps,
                          save_every=args.save_every,
                          handle_signals=True)

    def log(step, loss):
        if step % 10 == 0 or step == 1:
            print(f"step {step:5d}  loss {loss:.4f}", flush=True)
        if on_step is not None:
            on_step(step, loss)

    loop = TrainLoop(step_fn, ds, ckpt, loop_cfg, on_step=log)
    state, result = loop.run(state)
    last = f"{result.losses[-1]:.4f}" if result.losses else "n/a (resumed)"
    print(f"done: {result.final_step} steps, final loss "
          f"{last}, stragglers={len(result.straggler_events)}"
          f"{', PREEMPTED' if result.preempted else ''}")
    return result


if __name__ == "__main__":
    main()
