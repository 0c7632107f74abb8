"""The port stands alone: no JAX and nothing of the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import build
from repro_torch.serving.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    assert "repro_torch.serving.engine" in mods and len(mods) > 20
    assert {"repro_torch.paging.manager", "repro_torch.paging.table",
            "repro_torch.kernels.paged_attention.ops",
            "repro_torch.core", "repro_torch.core.workload",
            "repro_torch.core.burst", "repro_torch.core.footprint",
            "repro_torch.core.offload", "repro_torch.core.energy",
            "repro_torch.platforms", "repro_torch.platforms.base",
            "repro_torch.platforms.paper", "repro_torch.platforms.registry",
            "repro_torch.platforms.builtin", "repro_torch.gateway",
            "repro_torch.gateway.slo", "repro_torch.gateway.metrics",
            "repro_torch.gateway.gateway", "repro_torch.gateway.loadgen",
            "repro_torch.launch.gateway", "repro_torch.staticcheck",
            "repro_torch.staticcheck.__main__",
            "repro_torch.staticcheck.config",
            "repro_torch.staticcheck.donation",
            "repro_torch.staticcheck.dtypeplanes",
            "repro_torch.staticcheck.footprint",
            "repro_torch.staticcheck.harness",
            "repro_torch.staticcheck.recompile",
            "repro_torch.staticcheck.report", "repro_torch.staticcheck.run",
            "repro_torch.staticcheck.syncpoints",
            "repro_torch.staticcheck.trace", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.data",
            "repro_torch.data.synthetic", "repro_torch.checkpoint",
            "repro_torch.checkpoint.store", "repro_torch.train",
            "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.train.setup",
            "repro_torch.launch.train", "repro_torch.parallel",
            "repro_torch.parallel.sharding",
            "repro_torch.parallel.collectives",
            "repro_torch.parallel.pipeline",
            "repro_torch.launch.mesh", "repro_torch.flags",
            "repro_torch.analysis", "repro_torch.analysis.cost",
            "repro_torch.analysis.roofline", "repro_torch.launch.dryrun",
            "repro_torch.launch.profile_cell"} <= set(mods)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imported_names(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_refuse_to_run_without_cuda_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(reduced(get_config("whisper-tiny-en")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_values(torch.Generator().manual_seed(0))
    params = model.init_values(torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.transcribe(torch.zeros(1600).numpy(), model=model,
                               params=params)
