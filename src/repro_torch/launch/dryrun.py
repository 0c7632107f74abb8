"""Multi-pod dry-run of the port (the JAX package's ``launch/dryrun.py``):
trace every (arch x shape x mesh) cell on one rank of the production
mesh without allocating.

For each cell this builds the port's step (``make_train_step`` for train
shapes, the meshed prefill / decode steps for serving shapes) on a
``fake`` process group of 256 ranks (512 for two pods) and the mesh
``launch.mesh.make_production_mesh`` makes over it, places the state
(``state_shardings``; serving weights in bf16 by the parameters' rules,
the cache by ``cache_shardings``) as DTensors over fake tensors, runs
the step once under ``analysis.cost.measure`` and records, for one
rank:

* ``memory``: the state it stores and its rows of the batch
  (``argument_bytes``), what the step returns (``output_bytes``) and the
  peak of the bytes alive at once (``peak_bytes``, MemTracker's), the
  peak above the arguments as ``temp_bytes``;
* the traced FLOPs, bytes and collective bytes, scaled to the mesh, and
  the three-term roofline on ``h100-sxm``.

Where the reference compiles, the port executes the step on fake
tensors, so ``compile_s`` is the trace's wall time. The fake tensors
stand for ``--device`` (``cuda`` by default), which needs a PyTorch
built for CUDA (indexing and autograd ask the device for its guard), a
card or not; on a CPU-only build trace with ``--device cpu``. A kernel
call is one node of the trace (``analysis.cost``): nothing is launched.
Each record is printed as one JSON line.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
        --shape train_4k [--multi-pod] [--n-micro N] [--device cpu] [--all]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import traceback
from typing import Optional

import torch

from repro_torch.analysis.cost import measure
from repro_torch.analysis.roofline import model_flops, roofline_from_cost
from repro_torch.configs import get_config, list_archs
from repro_torch.models.model import (SHAPES, build, input_specs,
                                      shape_applicable)
from repro_torch.optim.adamw import AdamWConfig, tree_map
from repro_torch.parallel.sharding import (enforce_divisibility, place_tree,
                                           rules_for, tree_shardings)
from repro_torch.train import step as step_mod

DEFAULT_N_MICRO = 4   # the reference's gradient accumulation of train cells


def fake_tensors(tree, fake_mode, device: str):
    """``tree``'s tensors (``meta`` ones, say) as fake tensors of
    ``fake_mode`` on ``device``, nothing allocated."""
    if device == "cuda" and not torch.backends.cuda.is_built():
        raise RuntimeError("fake cuda tensors need a PyTorch built for "
                           "CUDA (indexing and autograd ask the device for "
                           "its guard); trace with device cpu")
    with fake_mode:
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device), tree)


@contextlib.contextmanager
def fake_world(size: int):
    """A ``fake`` default process group of ``size`` ranks, this process
    rank 0, for the block (one of that size already up is used as it
    is)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is up; the dry-run needs {size}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _param_shardings(model, mesh, rules):
    return enforce_divisibility(
        tree_shardings(model.param_axes(), mesh, rules),
        model.param_shapes())


def trace_train(model, opt_cfg: AdamWConfig, *, device: str, batch: dict,
                mesh=None, rules: Optional[dict] = None, n_micro: int = 1):
    """One train step of ``model`` traced on fake tensors on ``device``:
    its f32 state (placed by ``state_shardings`` with ``mesh``) and
    ``batch`` (``meta`` or real tensors: their shapes), the global one.
    Returns its ``Cost``, a rank's (``tracked_bytes``: the state and this
    rank's rows)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fm = FakeTensorMode()
    state = fake_tensors(step_mod.state_shapes(model), fm, device)
    batch = fake_tensors(batch, fm, device)
    if mesh is not None:
        state = place_tree(state, step_mod.state_shardings(model, mesh,
                                                           rules))
        batch = step_mod.shard_batch(batch, mesh)
    fn = step_mod.make_train_step(model, opt_cfg, mesh=mesh, rules=rules,
                                  n_micro=n_micro)
    with fm:
        return measure(fn, state, batch, track=(state, batch))[1]


def _trace_serve(model, kind: str, mesh, rules, specs: dict, seq: int,
                 gbatch: int, device: str):
    """A prefill or decode step over bf16 serving weights (and, decoding,
    a cache of ``seq``) traced on fake tensors. Returns its ``Cost``, as
    ``trace_train``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fm = FakeTensorMode()
    params = place_tree(
        fake_tensors(model.param_shapes(torch.bfloat16), fm, device),
        _param_shardings(model, mesh, rules))
    batch = fake_tensors(specs, fm, device)
    if kind == "prefill":
        fn = step_mod.make_prefill_step(model, mesh=mesh, rules=rules)
        args = (params, batch)
    else:
        cache = place_tree(
            fake_tensors(model.cache_specs(gbatch, seq), fm, device),
            step_mod.cache_shardings(model, gbatch, seq, mesh, rules))
        fn = step_mod.make_decode_step(model, mesh=mesh, rules=rules)
        args = (params, cache, batch["tokens"], batch["pos"])
    with fm:
        return measure(fn, *args, track=args)[1]


def dryrun_cell(arch: str, shape: str, *, multi_pod: bool = False,
                verbose: bool = True, opt_overrides: Optional[dict] = None,
                n_micro: Optional[int] = None, device: str = "cuda"):
    """Trace one cell on one rank of the production mesh. Returns the
    result record (dict); ``cost`` holds the ``analysis.cost.Cost``."""
    from repro_torch.launch.mesh import (make_production_mesh, mesh_chips,
                                         mesh_label)
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": why}
    seq, gbatch, kind = SHAPES[shape]
    model = build(cfg)
    specs = input_specs(cfg, shape)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        chips = mesh_chips(mesh)
        rules = rules_for(cfg, mesh, mode="train" if kind == "train"
                          else "serve")
        if kind == "train":
            nm = DEFAULT_N_MICRO if n_micro is None else n_micro
            cost = trace_train(
                model, AdamWConfig(**(opt_overrides or {})), device=device,
                batch=specs, mesh=mesh, rules=rules, n_micro=nm)
            tokens = gbatch * seq
        else:
            cost = _trace_serve(model, kind, mesh, rules, specs, seq,
                                gbatch, device)
            tokens = gbatch * seq if kind == "prefill" else gbatch
        label = mesh_label(mesh)
    mflops = model_flops(cfg, model.n_params(), model.n_active_params(),
                         tokens, kind)
    rl = roofline_from_cost(cost, arch=arch, shape=shape, mesh=label,
                            chips=chips, model_flops=mflops)
    arg_b = cost.tracked_bytes
    mem = {"argument_bytes": arg_b, "output_bytes": cost.output_bytes,
           "temp_bytes": cost.peak_bytes - arg_b,
           "generated_code_bytes": None, "peak_bytes": cost.peak_bytes}
    rec = {
        "arch": arch, "shape": shape, "mesh": label, "chips": chips,
        "kind": kind, "status": "ok", "device": device,
        "compile_s": cost.seconds,
        "memory": mem,
        "hlo_flops": rl.hlo_flops,
        "hlo_bytes": rl.hlo_bytes,
        "collective_bytes": rl.collective_bytes,
        "collectives": rl.collectives,
        "model_flops": mflops,
        "compute_s": rl.compute_s,
        "memory_s": rl.memory_s,
        "collective_s": rl.collective_s,
        "dominant": rl.dominant,
        "useful_ratio": rl.useful_flops_ratio,
        "roofline_frac": rl.roofline_fraction,
        "cost": cost,
    }
    if verbose:
        print(f"[{arch} x {shape} x {label}] traced {cost.seconds:.1f}s on "
              f"fake {device} | peak {cost.peak_bytes / 1e9:.3f} GB a rank "
              f"(state + rows {arg_b / 1e9:.3f} GB) | compute "
              f"{rl.compute_s * 1e3:.2f}ms memory {rl.memory_s * 1e3:.2f}ms "
              f"collective {rl.collective_s * 1e3:.2f}ms -> "
              f"{rl.dominant}-bound, useful {rl.useful_flops_ratio:.2f}, "
              f"roofline {rl.roofline_fraction:.2%}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell, whatever --arch and "
                         "--shape say")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the fake tensors stand for")
    args = ap.parse_args(argv)
    archs = [a for a in list_archs() if a != "whisper-tiny-en"] \
        if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None \
        else [args.shape]
    cells = [(a, s) for a in archs for s in shapes]
    failures = []
    for arch, shape in cells:
        try:
            rec = dryrun_cell(arch, shape, multi_pod=args.multi_pod,
                              n_micro=args.n_micro, device=args.device)
        except Exception as e:   # a failed cell is reported; the rest run
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
            continue
        rec["multi_pod"] = args.multi_pod
        if rec["status"] == "skipped":
            print(f"[{arch} x {shape}] SKIP: {rec['reason']}")
        print(json.dumps({k: v for k, v in rec.items() if k != "cost"}),
              flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nall {len(cells)} cells passed "
          f"({'multi-pod 2x16x16' if args.multi_pod else 'single-pod 16x16'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
