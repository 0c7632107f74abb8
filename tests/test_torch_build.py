"""The kernel build and ``chip_smoke.py`` leave no process running.

A stand-in ``nvcc`` (a shell script first on ``PATH``) runs in place of
the CUDA compiler, so these run on the CPU: it builds, fails, or hangs
with a child of its own, as nvcc's compiler stages are its children.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

from repro_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parents[1]

FAKE_NVCC = """#!/bin/bash
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case "$FAKE_NVCC_MODE" in
  ok) echo built > "$out" ;;
  fail) echo "error: no such intrinsic"; exit 1 ;;
  hang) sleep 60 & echo "$$ $!" >> "$FAKE_NVCC_PIDS"; wait ;;
esac
"""


def _running(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("FAKE_NVCC_PIDS", str(tmp_path / "pids"))
    monkeypatch.setattr(build, "_build_s", {})
    return tmp_path


def test_build_all_builds_every_source_and_reuses_it(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_MODE", "ok")
    secs = build.build_all()
    assert sorted(secs) == sorted(build.SOURCES)
    out = build.build_dir()
    assert sorted(p.name for p in out.glob("*.so")) == sorted(
        f"lib{n}.so" for n in build.SOURCES)
    monkeypatch.setattr(build, "_build_s", {})
    assert build.build_all() == {n: 0.0 for n in build.SOURCES}


def test_a_failed_nvcc_is_named_and_leaves_nothing(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_MODE", "fail")
    before = set(build.descendants(os.getpid()))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        build.build_all()
    assert set(build.descendants(os.getpid())) <= before
    assert not list(build.build_dir().glob("*.so"))


@pytest.mark.parametrize("started", [1, 4])
def test_an_interrupted_build_stops_every_nvcc_and_its_stages(
        fake_nvcc, monkeypatch, started):
    """An error while ``nvcc`` processes run (here: the next one cannot
    be started) kills each of them with its own child, and reaps them."""
    monkeypatch.setenv("FAKE_NVCC_MODE", "hang")
    popen = subprocess.Popen
    calls = []
    pids_file = fake_nvcc / "pids"

    def flaky_popen(*a, **k):
        if len(calls) == started:
            # the started ones are running, each with its own child
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and (
                    not pids_file.exists()
                    or len(pids_file.read_text().splitlines()) < started):
                time.sleep(0.05)
            raise OSError("cannot start another nvcc")
        calls.append(a)
        return popen(*a, **k)

    monkeypatch.setattr(build.subprocess, "Popen", flaky_popen)
    before = set(build.descendants(os.getpid()))
    t0 = time.monotonic()
    with pytest.raises(OSError, match="another nvcc"):
        build.build_all()
    assert time.monotonic() - t0 < 30
    assert set(build.descendants(os.getpid())) <= before
    pids = [int(p) for line in pids_file.read_text().splitlines()
            for p in line.split()]
    assert len(pids) == 2 * started
    deadline = time.monotonic() + 5
    while any(map(_running, pids)) and time.monotonic() < deadline:
        time.sleep(0.05)      # an orphaned child is reaped by init
    assert not any(map(_running, pids))
    assert not list(build.build_dir().glob("*.tmp.so"))


STOP_CHILDREN = """
import importlib.util, json, os, subprocess, sys
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
left = smoke.stop_children()
print(json.dumps([left, os.path.exists(f"/proc/{child.pid}"),
                  smoke.stop_children()]))
"""


def test_chip_smoke_stops_a_process_left_running():
    """In a process of its own, so that nothing of the test run's is
    killed: a child left running is named, killed and reaped."""
    out = subprocess.run(
        [sys.executable, "-c", STOP_CHILDREN, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, check=True)
    left, exists, again = json.loads(out.stdout.splitlines()[-1])
    assert any("time.sleep(60)" in c for c in left)
    assert not exists
    assert again == []
