"""Build and load the port's CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface and
loaded with ``ctypes``. Nothing is built at import: the first kernel
launch builds every library, all ``nvcc`` processes started together,
into ``build/repro_torch_kernels/<hash>/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``). The hash covers the sources and the flags,
so an edited source builds afresh and an unchanged one is reused.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import signal
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"

#: kernel library name -> its source file under csrc/
SOURCES = {
    "fp16_matmul": "fp16_matmul.cu",
    "q8_matmul": "q8_matmul.cu",
    "flash_attention": "flash_attention.cu",
    "q8_attention": "q8_attention.cu",
    "q4_matmul": "q4_matmul.cu",
    "q4_attention": "q4_attention.cu",
    "slstm_scan": "slstm_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: torch dtype -> the dtype code every C entry point takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_s: dict[str, float] = {}
_sms: dict[int, int] = {}


def _build_root() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return (pathlib.Path(__file__).resolve().parents[3] / "build"
            / "repro_torch_kernels")


def _digest() -> str:
    """Hash of the flags and of every source and header in csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch are built on first use")


def _children(pid: int) -> list[int]:
    """Processes whose parent is ``pid`` (Linux ``/proc``)."""
    kids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the field after the parenthesised command name: state, ppid
        if int(stat[stat.rindex(")") + 2:].split()[1]) == pid:
            kids.append(int(entry))
    return kids


def descendants(pid: int) -> list[int]:
    """Every live process below ``pid``, parents before their children."""
    out, todo = [], [pid]
    while todo:
        kids = _children(todo.pop())
        out += kids
        todo += kids
    return out


def stop_tree(proc: subprocess.Popen) -> None:
    """Kill ``proc`` and every process below it, and reap ``proc``. nvcc
    runs its compiler stages as children (cicc, ptxas, gcc), which
    killing nvcc alone would leave running. The tree is stopped first,
    level by level, so that no process forks a child that escapes."""
    stopped = [proc.pid]
    for pid in stopped:            # grows as each level is found
        try:
            os.kill(pid, signal.SIGSTOP)
        except ProcessLookupError:
            continue
        stopped += [k for k in _children(pid) if k not in stopped]
    for pid in stopped:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    proc.wait()


def build_all() -> dict[str, float]:
    """Build every kernel library that is not built yet, one ``nvcc``
    process per source, all started together. Returns the seconds each
    library took to build in this process (0.0 where it was reused).
    Every ``nvcc`` has ended when it returns or raises: one still
    running when an error (or a signal turned into an exception) stops
    the build is killed with its compiler stages."""
    with _lock:
        out_dir = _build_root() / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = None
        procs = {}
        t0 = time.monotonic()
        try:
            for name, src in SOURCES.items():
                lib = out_dir / f"lib{name}.so"
                if name in _build_s:
                    continue
                if lib.exists():
                    _build_s[name] = 0.0
                    continue
                nvcc = nvcc or _nvcc()
                tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
                log = open(out_dir / f"{name}.log", "w")
                try:
                    proc = subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                        stdout=log, stderr=subprocess.STDOUT)
                except BaseException:
                    log.close()
                    raise
                procs[name] = (proc, tmp, lib, log)
            failed = []
            for name, (proc, tmp, lib, log) in procs.items():
                rc = proc.wait()
                if rc != 0:
                    failed.append(name)
                    continue
                os.replace(tmp, lib)
                _build_s[name] = time.monotonic() - t0
        finally:
            for proc, tmp, _, log in procs.values():
                if proc.poll() is None:
                    stop_tree(proc)
                log.close()
                tmp.unlink(missing_ok=True)
        if failed:
            logs = "\n".join(
                f"--- {n}:\n" + (out_dir / f"{n}.log").read_text()[-4000:]
                for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return dict(_build_s)


def build_dir() -> pathlib.Path:
    return _build_root() / _digest()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load(name).repro_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc} ({msg})")


# the current stream's raw handle, without building a Python Stream
# object on every launch; builds of PyTorch that lack it take the public
# call
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    if _raw_stream is not None and device.index is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA ``device`` (132 on an H100
    SXM): what a wrapper fills when it splits work across blocks."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sms[idx]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All of ``tensors`` on one CUDA device, else ``ValueError``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}; "
                             f"all operands must share one CUDA device")
