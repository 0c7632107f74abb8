"""Training launcher of the port (the JAX package's ``launch/train.py``):
the fault-tolerant ``TrainLoop`` over the synthetic pipeline, with AdamW
and checkpoints, on one device or on several ranks.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny-en \\
        --steps 20 --ckpt "$TMPDIR/ckpt-whisper"
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --reduced --device cpu --devices 4 --mesh 2x2 --steps 6

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
launcher's.

Several devices: ``--devices N`` means N ranks (the reference forces N
host devices instead). With ``--mesh DxM`` (``D*M == N``) the state is
sharded on a ``("data", "model")`` DeviceMesh and each step runs the
sharded train step; ``--compress-grads`` trains on a data mesh of N with
the int8 error-feedback all-reduce (the reference parses this flag and
ignores it). N > 1 spawns N processes (``torch.multiprocessing``, a
``file://`` rendezvous in a temporary directory): ``nccl`` with one
card each on ``cuda``, ``gloo`` with ``--device cpu``; more ranks than
cards is refused, any rank's failure fails ``main`` and stops the
others, and ``main`` returns rank 0's ``LoopResult``. N = 1 runs in
this process, over the process group that is up, or a one-rank group it
makes and ends. ``--devices N`` without ``--mesh`` or
``--compress-grads`` trains on one device, as the reference's jit does.
"""

from __future__ import annotations

import argparse
import os
import pickle
import statistics
import tempfile


def _parser() -> argparse.ArgumentParser:
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
                    help="ranks to train on (one card each on cuda)")
    ap.add_argument("--mesh", default="",
                    help="DxM data x model mesh over the --devices ranks")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback data-parallel gradients "
                         "over a data mesh of --devices")
    return ap


def _check(ap, args) -> tuple:
    """The mesh shape the flags ask for (None: one device), or
    ``ap.error``."""
    n = args.devices
    shape = None
    if args.mesh:
        try:
            d, m = (int(x) for x in args.mesh.split("x"))
        except ValueError:
            ap.error(f"--mesh {args.mesh!r}: expected DxM, e.g. 2x2")
        if d * m != n:
            ap.error(f"--mesh {args.mesh} needs --devices {d * m} "
                     f"(got {n})")
        shape = (d, m)
    if args.compress_grads:
        if n < 1:
            ap.error("--compress-grads needs --devices N (a data mesh)")
        if shape is not None and shape[1] > 1:
            ap.error("--compress-grads maps the data axes only: a mesh "
                     "whose model axis is above 1 is refused")
        shape = (n, 1)
    if n and (args.device or "cuda").startswith("cuda"):
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            ap.error(f"--devices {n} needs {n} cards, {have} visible "
                     f"(use --device cpu for gloo ranks)")
    return shape


def main(argv=None, on_step=None):
    """Train as ``argv`` says; ``on_step(step, loss)`` is called after
    each step's own log line (in this process: not on spawned ranks).
    Returns the loop's ``LoopResult`` (rank 0's)."""
    ap = _parser()
    args = ap.parse_args(argv)
    shape = _check(ap, args)
    if not args.ckpt:
        args.ckpt = tempfile.mkdtemp(prefix=f"ckpt-{args.arch}-")
        print(f"checkpoints: {args.ckpt}", flush=True)
    if shape is None:
        return _train(args, None, on_step)
    if args.devices == 1:
        return _one_rank(args, shape, on_step)
    return _spawn(args, shape)


def _backend(device) -> str:
    return "nccl" if str(device).startswith("cuda") else "gloo"


def _one_rank(args, shape, on_step):
    """A mesh of one rank in this process, over the group that is up or
    a one-rank group made and ended here."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError("--devices 1 inside a process group of "
                               f"{dist.get_world_size()} ranks")
        return _train(args, shape, on_step)
    with tempfile.TemporaryDirectory(prefix="rdv-") as rdv:
        dist.init_process_group(_backend(args.device or "cuda"),
                                init_method=f"file://{rdv}/store",
                                rank=0, world_size=1)
        try:
            return _train(args, shape, on_step)
        finally:
            dist.destroy_process_group()


def _spawn(args, shape):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="ranks-") as work:
        result = os.path.join(work, "result.pkl")
        ctx = mp.start_processes(_rank_main,
                                 args=(args, shape, work, result),
                                 nprocs=args.devices, start_method="spawn",
                                 join=False)
        # a failed rank fails main; the others get SIGTERM, then SIGKILL
        while not ctx.join(grace_period=5):
            pass
        with open(result, "rb") as f:
            return pickle.load(f)


def _rank_main(rank: int, args, shape, work: str, result: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    device = args.device or "cuda"
    if device.startswith("cuda"):
        torch.cuda.set_device(rank)
        args.device = f"cuda:{rank}"
    dist.init_process_group(_backend(device),
                            init_method=f"file://{work}/store",
                            rank=rank, world_size=args.devices)
    try:
        res = _train(args, shape, None, quiet=rank != 0)
        if rank == 0:
            with open(result, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _train(args, shape, on_step, quiet: bool = False):
    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.setup import adamw_config, train_setup
    from repro_torch.train import step as step_mod

    model, state, ds = train_setup(
        args.arch, batch=args.batch, seq=args.seq, seed=args.seed,
        device=args.device, reduced=args.reduced)
    opt_cfg = adamw_config(args.lr, args.warmup, args.steps)
    shardings = None
    if shape is None:
        step_fn = step_mod.make_train_step(model, opt_cfg,
                                           n_micro=args.n_micro)
    else:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.collectives import init_error_state
        from repro_torch.parallel.sharding import place_tree, rules_for
        if args.compress_grads:
            mesh = make_mesh((shape[0],), ("data",))
            state["err"] = init_error_state(state["params"], mesh)
            step_fn = step_mod.make_compressed_train_step(model, opt_cfg,
                                                          mesh)
        else:
            mesh = make_mesh(shape, ("data", "model"))
            rules = rules_for(model.cfg, mesh, mode="train")
            shardings = step_mod.state_shardings(model, mesh, rules)
            state = place_tree(state, shardings)
            step_fn = step_mod.make_train_step(
                model, opt_cfg, mesh=mesh, rules=rules,
                n_micro=args.n_micro)
    ckpt = CheckpointManager(args.ckpt, keep=3)
    loop_cfg = LoopConfig(total_steps=args.steps,
                          save_every=args.save_every,
                          handle_signals=True)

    def log(step, loss):
        if not quiet and (step % 10 == 0 or step == 1):
            print(f"step {step:5d}  loss {loss:.4f}", flush=True)
        if on_step is not None:
            on_step(step, loss)

    loop = TrainLoop(step_fn, ds, ckpt, loop_cfg, on_step=log)
    state, result = loop.run(state, state_shardings=shardings)
    last = f"{result.losses[-1]:.4f}" if result.losses else "n/a (resumed)"
    later = result.step_seconds[1:]
    median = (f", median step {statistics.median(later) * 1e3:.2f} ms"
              if later else "")
    if not quiet:
        print(f"done: {result.final_step} steps, final loss "
              f"{last}{median}, stragglers={len(result.straggler_events)}"
              f"{', PREEMPTED' if result.preempted else ''}", flush=True)
    return result


if __name__ == "__main__":
    main()
