"""Meshed serving launcher of the port: ``--devices N`` ranks run the
meshed prefill and greedy decode steps (``train.step.make_prefill_step``
/ ``make_decode_step`` with a mesh: a rank's rows, the layers every
family shares split over ``model``) on each ``--mesh DxM`` in turn, from
the same seeded bf16 weights and ``LANES`` prompts, and rank 0 runs the
unmeshed steps on its own device beside them. The record holds, for
each mesh, each step's logits gap to the unmeshed ones over their
largest, the greedy ids that differ with their margin in the unmeshed
logits, the units split (``split_counts``) and the ms a step of both (a
host clock around each step, synchronised on a card; the kernels are
built before the ranks start). It applies no bound: each caller holds
the record to its own.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve_mesh --arch qwen3-4b \\
        --devices 4 --mesh 1x4 --mesh 2x2
    PYTHONPATH=src python -m repro_torch.launch.serve_mesh --arch qwen3-4b \\
        --reduced --device cpu --devices 2 --mesh 1x2 --steps 2

``--device`` defaults to ``cuda`` (``nccl``, one card a rank; more ranks
than cards is refused) and never falls back to the CPU; ``--device cpu``
runs ``gloo`` ranks. The ranks are spawned processes with a ``file://``
rendezvous in a temporary directory; any rank's failure fails ``main``.
The unmeshed steps read the meshed run's ids (teacher forcing), so every
step's logits compare. ``main`` prints rank 0's record as one JSON line
and returns it; ``serve_meshes`` is the ranks' part, for ranks already
in a process group.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time

#: the prefill's lanes, and the seed of the weights and the prompts
LANES, SEED = 4, 0
#: an encoder-decoder model's frames a lane (Whisper's 30 s window)
ENC_FRAMES = 1500


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--devices", type=int, required=True)
    ap.add_argument("--mesh", action="append", required=True,
                    help="DxM data x model mesh over the --devices ranks "
                         "(repeatable)")
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap


def _shapes(ap, args) -> list:
    shapes = []
    for m in args.mesh:
        d, _, t = m.partition("x")
        if not (d.isdigit() and t.isdigit()) or int(d) * int(t) != \
                args.devices:
            ap.error(f"--mesh {m} is not DxM with D*M == --devices")
        shapes.append((int(d), int(t)))
    if args.device.startswith("cuda"):
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.devices > have:
            ap.error(f"--devices {args.devices} needs {args.devices} "
                     f"cards, {have} visible")
    return shapes


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    shapes = _shapes(ap, args)
    import torch.multiprocessing as mp
    if args.device.startswith("cuda"):
        from repro_torch.kernels import build
        build.build_all()
    with tempfile.TemporaryDirectory(prefix="ranks-") as work:
        result = os.path.join(work, "result.pkl")
        ctx = mp.start_processes(_rank_main,
                                 args=(args, shapes, work, result),
                                 nprocs=args.devices, start_method="spawn",
                                 join=False)
        while not ctx.join(grace_period=5):
            pass
        with open(result, "rb") as f:
            rec = pickle.load(f)
    print(json.dumps(rec), flush=True)
    return rec


def _setup(arch: str, reduced: bool, prompt: int, device):
    """(model, bf16 params drawn from ``SEED`` on ``device`` (an
    encoder-decoder model's in f32, as it stores them), the prefill batch
    of ``LANES`` x ``prompt`` ids; for an encoder-decoder model also
    ``ENC_FRAMES`` seeded frame embeddings a lane)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs import reduced as reduce_cfg
    from repro_torch.models.model import build
    cfg = get_config(arch)
    model = build(reduce_cfg(cfg) if reduced else cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = model.init_values(gen, device=device, dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, model.cfg.vocab, (LANES, prompt)).astype(np.int32))
    batch = {"tokens": tokens.to(device)}
    if model.cfg.enc_dec:
        frames = rng.standard_normal((LANES, ENC_FRAMES, model.cfg.d_model))
        batch["enc_frames"] = torch.from_numpy(
            (frames * 0.02).astype(np.float32)).to(device)
    return model, params, batch


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def _serve(model, params, batch, steps: int, device, ids=None, **mesh):
    """The prefill and ``steps`` decode steps: (each step's logits (B, V)
    on the CPU, the ids fed, each step's ms). ``ids``: feed these (the
    meshed run's) instead of the greedy ones."""
    import torch

    from repro_torch.train.step import make_decode_step, make_prefill_step
    prefill = make_prefill_step(model, **mesh)
    decode = make_decode_step(model, **mesh)
    vocab = model.cfg.vocab
    logits, fed, ms = [], [], []
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        last, cache = prefill(params, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        pos = batch["tokens"].shape[1]
        for t in range(steps):
            logits.append(last[:, :vocab].float().cpu())
            nxt = (torch.argmax(last[:, :vocab], -1).to(torch.int32)[:, None]
                   if ids is None else ids[t].to(device))
            fed.append(nxt.cpu())
            _sync(device)
            t0 = time.perf_counter()
            last, cache = decode(params, cache, nxt, pos + t)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(last[:, :vocab].float().cpu())
    return logits, fed, ms


def _compare(got: list, fed: list, want: list) -> dict:
    """The meshed run's logits and ids against the unmeshed run's: each
    step's gap over the unmeshed largest, and each greedy id that
    differs as (step, lane, its margin below the unmeshed pick in the
    unmeshed logits)."""
    gaps, flips = [], []
    for t, (g, w) in enumerate(zip(got, want)):
        gaps.append(float((g - w).abs().max()) / float(w.abs().max()))
        if t < len(fed):
            wi = w.argmax(-1)
            for r in (fed[t][:, 0] != wi).nonzero().flatten().tolist():
                flips.append((t, r, float(w[r, wi[r]]
                                          - w[r, fed[t][r, 0]])))
    return {"logits_gap": gaps, "near_tie_flips": flips}


def serve_meshes(arch: str, reduced: bool, shapes: list, prompt: int,
                 steps: int, device):
    """The ranks' part of ``main``, on ranks already in a process group of
    ``D*M`` ranks: each mesh of ``shapes`` in turn, then rank 0's
    unmeshed runs and comparisons (no collective). Returns the record
    on rank 0, None on the others."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import reset_split_counts, split_counts
    from repro_torch.parallel.sharding import (enforce_divisibility,
                                               place_tree, rules_for,
                                               tree_shardings)
    rank = dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    model, params, batch = _setup(arch, reduced, prompt, device)
    say(f"rank 0: {model.cfg.name} drawn on {device}", flush=True)
    cuda = str(device).startswith("cuda")
    rec = {"arch": model.cfg.name, "devices": dist.get_world_size(),
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "lanes": LANES, "prompt": prompt, "steps": steps, "meshes": {}}
    runs = {}
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"))
        rules = rules_for(model.cfg, mesh, mode="serve")
        placed = place_tree(params, enforce_divisibility(
            tree_shardings(model.param_axes(), mesh, rules),
            model.param_shapes()))
        reset_split_counts()
        runs[shape] = _serve(model, placed, batch, steps, device,
                             mesh=mesh, rules=rules)
        say(f"rank 0: mesh {shape} served, ms {runs[shape][2]}", flush=True)
        rec["meshes"][f"{shape[0]}x{shape[1]}"] = {
            "splits": {f"{u}:{f}": n
                       for (u, f), n in split_counts().items()}}
        del placed
    if rank != 0:
        return None
    for shape, (got, fed, ms) in runs.items():
        want, _, plain_ms = _serve(model, params, batch, steps, device,
                                   ids=fed)
        one = rec["meshes"][f"{shape[0]}x{shape[1]}"]
        one.update(_compare(got, fed, want))
        one.update(prefill_ms=ms[0], plain_prefill_ms=plain_ms[0],
                   step_ms=statistics.median(ms[1:]),
                   plain_step_ms=statistics.median(plain_ms[1:]))
    return rec


def _rank_main(rank: int, args, shapes: list, work: str, result: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    cuda = args.device.startswith("cuda")
    device = f"cuda:{rank}" if cuda else "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{work}/store",
                            rank=rank, world_size=args.devices)
    try:
        rec = serve_meshes(args.arch, args.reduced, shapes, args.prompt,
                           args.steps, device)
        if rank == 0:
            with open(result, "wb") as f:
                pickle.dump(rec, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
