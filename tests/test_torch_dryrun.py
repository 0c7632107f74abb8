"""The port's dry-run and profiler (``repro_torch.launch.dryrun``,
``launch.profile_cell``) on the CPU, on fake tensors over ``fake``
process groups (nothing is allocated, nothing launched):

* for every arch x shape the dry-run skips exactly what the reference's
  ``shape_applicable`` skips, with the same reason;
* a reduced train cell (4 layers, ``remat`` on) on a 2x2 fake group: its
  all-gathers move, by analysis of the placements, each leaf outside
  the layer stacks once and each layer twice (the forward, and the
  backward's recompute), one all-gather a sharded mesh axis, whose
  operand is the leaf as far as it is gathered; its reduce-scatters move
  each of those leaves' full gradient once (the gather's backward, over
  the data axis); and a rank's peak is below that of the same step with
  the whole tree gathered at the forward's start (the step before the
  per-layer gather);
* the serving cells of reduced qwen3-4b on the 16x16 fake group: a
  rank's arguments are its weight and cache shards and its rows of the
  batch; decode_32k peaks under those plus the gathered weights plus a
  few layers of its rows' cache planes, and prefill_32k at most 1/8 of
  the same step running the whole batch on every rank;
* the serving cells of reduced qwen3-4b on a 4x4 fake group, where the
  serving steps split the attention (head_dim form), the MLP and the
  vocabulary over ``model``: a rank's traced FLOPs about a quarter of
  the whole-layer gather's, and no op on a global cache leaf's shape;
* the CLI prints one record with the reference's keys (a reduced config
  on the 16x16 production mesh), serve cells trace with their kernel
  calls as nodes, and ``profile_cell`` prints its two tables.
"""

import ast
import dataclasses
import json
import math
import os

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models.model import shape_applicable as j_shape_applicable
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.kernels import api
from repro_torch.launch import dryrun, profile_cell
from repro_torch.models.layers import gathered
from repro_torch.models.model import SHAPES, build, input_specs, tree_paths
from repro_torch.optim.adamw import AdamWConfig, tree_map
from repro_torch.parallel.sharding import rules_for
from repro_torch.train import step as t_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_record_keys() -> tuple:
    """The keys of the reference's ``dryrun_cell`` record and of its
    ``memory``, read from its source (importing it would force 512 host
    devices on this process)."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("rec", "mem_rec"):
            found[node.targets[0].id] = {k.value for k in node.value.keys}
    return found["rec"] | {"multi_pod"}, found["mem_rec"]


@pytest.mark.parametrize("arch", j_list_archs())
def test_skips_equal_the_reference(arch):
    assert sorted(list_archs()) == sorted(j_list_archs())
    for shape in SHAPES:
        ok, why = j_shape_applicable(j_get_config(arch), shape)
        if ok:
            from repro_torch.models.model import shape_applicable
            assert shape_applicable(get_config(arch), shape) == (True, "")
            continue
        rec = dryrun.dryrun_cell(arch, shape, device="cpu")
        assert rec == {"arch": arch, "shape": shape, "status": "skipped",
                       "reason": why}


def _expected_collectives(model, mesh, rules) -> tuple:
    """(all-gather operand bytes, their count, reduce-scatter operand
    bytes) of one train step with ``remat``, from the placements."""
    sh = t_step.state_shardings(model, mesh, rules)["params"]
    ag = n_ag = rs = 0
    for (_, spec), (_, s) in zip(tree_paths(model.param_specs()),
                                 tree_paths(sh)):
        full = math.prod(spec.shape) * 4
        layers = spec.shape[0] if spec.axes[:1] == ("layers",) else 1
        times = 2 if layers > 1 else 1
        axes = [p for p in s.placements if p.is_shard()]
        left = full // 2 ** len(axes)   # this rank's shard; every axis is 2
        for _ in axes:                  # gathered one mesh axis at a time
            ag += times * left
            left *= 2
        n_ag += times * layers * len(axes)
        if s.placements[0].is_shard():  # sharded over data: the gradient's
            rs += full                  # partial sum is reduce-scattered
    return ag, n_ag, rs


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-tiny-en"])
def test_reduced_train_cell_on_a_2x2_fake_group(arch, monkeypatch):
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True,
                              n_layers=4)
    model = build(cfg)
    # 8 rows of 256: the backward's activations, not AdamW's temporaries,
    # make the peak
    batch = {k: torch.empty((8, 256) + tuple(v.shape[2:]), dtype=v.dtype,
                            device="meta")
             for k, v in input_specs(cfg, "train_4k").items()}
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        rules = rules_for(cfg, mesh, mode="train")
        kw = dict(device="cpu", batch=batch, mesh=mesh, rules=rules)
        cost = dryrun.trace_train(model, AdamWConfig(), **kw)
        ag, n_ag, rs = _expected_collectives(model, mesh, rules)
        assert cost.collectives["all-gather"] == ag
        assert cost.collective_counts["all-gather"] == n_ag
        assert cost.collectives["reduce-scatter"] == rs
        assert 0 < cost.tracked_bytes < cost.peak_bytes
        monkeypatch.setattr(t_step, "layer_params",
                            lambda params, axes, gp=None: tree_map(
                                lambda p: gathered(p, gp), params))
        whole = dryrun.trace_train(model, AdamWConfig(), **kw)
    assert cost.peak_bytes < whole.peak_bytes
    assert cost.flops == whole.flops


@pytest.fixture
def reduced_configs(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced(get_config(arch)))


def test_cli_prints_one_record_with_the_reference_keys(reduced_configs,
                                                       capsys):
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--device", "cpu", "--n-micro", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    keys, mem_keys = _reference_record_keys()
    assert keys <= rec.keys() and mem_keys <= rec["memory"].keys()
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "16x16", 256)
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["output_bytes"] > 0
    assert rec["collectives"]["all-gather"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serve_cells_trace_their_kernel_calls(reduced_configs, shape):
    before = api.launch_counts()
    rec = dryrun.dryrun_cell("qwen3-4b", shape, device="cpu",
                             verbose=False)
    assert api.launch_counts() == before
    assert rec["status"] == "ok" and rec["kind"] == shape.split("_")[0]
    assert rec["cost"].kernels["fp16_matmul"] > 0
    assert ("flash_attention" in rec["cost"].kernels) == (
        shape == "prefill_32k")
    assert rec["memory"]["peak_bytes"] > 0


#: what a decode step's rank holds of one layer's cache at once, in
#: layers of its rows' planes: the gathered planes, a second copy of a
#: plane in the all-gather's staging, and (CPU tensors) the attention's
#: f32 widen of a plane with its grouped bf16 copy
LAYER_COPIES = 3


def _rank_bytes(tree, shardings, sizes: dict) -> int:
    """The bytes a rank stores of ``tree`` (meta tensors) placed by
    ``shardings`` over a mesh of axis ``sizes``."""
    total = 0
    for (_, t), (_, sh) in zip(tree_paths(tree), tree_paths(shardings)):
        split = 1
        for e in sh.spec:
            for name in (e if isinstance(e, tuple) else (e,) if e else ()):
                split *= sizes[name]
        total += t.numel() * t.element_size() // split
    return total


def _whole_batch_rows(mesh, n):
    """``step._mesh_rows`` of the meshed serving steps before they ran a
    rank's rows: every rank runs every row."""
    return t_step.MeshRows(mesh, (), n)


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_meshed_serve_cell_runs_a_ranks_rows(reduced_configs, monkeypatch,
                                              shape):
    """A serving cell of reduced qwen3-4b on the 16x16 fake group: a
    rank's arguments are its weight and cache shards and its rows of the
    batch, no more; decoding, its peak lies under its arguments plus the
    gathered weights plus ``LAYER_COPIES`` layers of its rows' cache
    planes (``cache_specs``); in prefill, at most 1/8 of the peak of the
    same step running the whole batch on every rank."""
    import types
    cfg = reduced(get_config("qwen3-4b"))
    model = build(cfg)
    seq, gbatch, kind = SHAPES[shape]
    sizes = {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(shape=sizes)
    rules = rules_for(cfg, mesh, mode="serve")
    weights = model.param_shapes(torch.bfloat16)
    args = _rank_bytes(weights, dryrun._param_shardings(model, mesh, rules),
                       sizes)
    rows = {k: v.numel() * v.element_size() // (16 if v.ndim else 1)
            for k, v in input_specs(cfg, shape).items()}
    args += sum(rows.values())
    cache = model.cache_specs(gbatch, seq)
    if kind == "decode":
        args += _rank_bytes(cache, t_step.cache_shardings(
            model, gbatch, seq, mesh, rules), sizes)
    rec = dryrun.dryrun_cell("qwen3-4b", shape, device="cpu", verbose=False)
    mem = rec["memory"]
    assert mem["argument_bytes"] == args, (mem["argument_bytes"], args)
    peak = mem["peak_bytes"]
    if kind == "decode":
        layer = sum(v.numel() * v.element_size() // v.shape[0]
                    for _, v in tree_paths(cache)) // 16
        gathered_weights = sum(v.numel() * v.element_size()
                               for _, v in tree_paths(weights))
        bound = args + gathered_weights + LAYER_COPIES * layer
        assert 0 < peak < bound, (peak, bound)
        return
    monkeypatch.setattr(t_step, "_mesh_rows", _whole_batch_rows)
    whole = dryrun.dryrun_cell("qwen3-4b", shape, device="cpu",
                               verbose=False)["memory"]["peak_bytes"]
    assert 8 * peak <= whole, (peak, whole)


def test_fake_cuda_needs_a_cuda_build():
    if torch.backends.cuda.is_built():
        pytest.skip("this PyTorch is built for CUDA: fake cuda tensors "
                    "trace")
    with pytest.raises(RuntimeError, match="built for CUDA"):
        dryrun.dryrun_cell("qwen3-4b", "decode_32k", device="cuda")


def test_profile_cell_prints_its_two_tables(reduced_configs, capsys):
    assert profile_cell.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                              "--device", "cpu", "--n-micro", "1",
                              "--top", "5"]) == 0
    out = capsys.readouterr().out
    ops = out.split("== top 5 ops by bytes (per rank) ==")[1]
    ops, colls = ops.split("== top collectives by operand bytes")
    assert len([ln for ln in ops.splitlines() if " GB " in ln]) == 5
    rows = [ln for ln in colls.splitlines() if " GB " in ln]
    assert rows and any("all-gather" in r and "models.layers:gathered" in r
                        for r in rows)


@pytest.mark.parametrize("arch,shape", [
    pytest.param("qwen3-4b", "prefill_32k", id="prefill_32k"),
    pytest.param("qwen3-4b", "decode_32k", id="decode_32k"),
    pytest.param("qwen3-moe-30b-a3b", "prefill_32k",
                 id="qwen3-moe-30b-a3b-prefill_32k")])
def test_meshed_serve_cell_splits_over_model(monkeypatch, arch, shape):
    """A serving cell on a 4x4 fake group of reduced qwen3-4b, whose
    heads, MLP columns and vocabulary divide ``model`` (its 2 KV heads do
    not: the attention takes the head_dim form), or reduced
    qwen3-moe-30b-a3b, whose 4 experts take the ``experts`` form (one a
    rank): a rank's traced FLOPs fall by about ``model``'s size against
    the whole-layer gather (the K/V projections stay whole in the
    head_dim form, and the MoE's router and routing on every rank, so a
    little less than 4), and the trace holds no op on a global cache
    leaf's shape, stacked or of one layer (the MoE routing counts, which
    the cache keeps whole, aside)."""
    from repro_torch.launch.mesh import make_mesh
    cfg = reduced(get_config(arch))
    model = build(cfg)
    seq, gbatch, _ = SHAPES[shape]
    with dryrun.fake_world(16):
        mesh = make_mesh((4, 4), ("data", "model"), "cpu")
        rules = rules_for(cfg, mesh, mode="serve")
        split = dryrun._trace_serve(model, shape, mesh, rules, "cpu")
        monkeypatch.setattr(t_step, "_model_axis", lambda mesh: None)
        whole = dryrun._trace_serve(model, shape, mesh, rules, "cpu")
    ratio = whole.flops / split.flops
    assert 3.0 <= ratio <= 4.0, (whole.flops, split.flops)
    length = t_step.prefill_cache_len(seq) if shape == "prefill_32k" \
        else seq
    cache = model.cache_specs(gbatch, length)
    shapes = {str(tuple(t.shape[k:])) for path, t in tree_paths(cache)
              if not path.endswith("routing") for k in (0, 1)}
    held = {s for _, s, _ in split.instructions} & shapes
    assert not held, held
