"""Wrapper of the sLSTM recurrence kernel (``csrc/slstm_scan.cu``).

``slstm_scan(wx, r_all, state0)`` keeps the reference op's signature:
wx (S, 4, B, H, hd) input pre-activations (Wx + b of the gates i, f, z,
o), r_all (4, H, hd, hd) stacked recurrent weights, f32 or bf16 as
stored (the reference casts R to f32 in the kernel; a bf16 value is
exact in f32, so the products are the same), state0 (4, B, H, hd)
stacked (c, n, h, m); it returns (hs (S, B, H, hd), state (4, B, H,
hd)), all f32. On CUDA tensors it launches the kernel in the layout
``plan`` picks, which runs any S >= 1 in one launch from ``state0`` (the
reference's state-preserving chunk padding has no counterpart); on CPU
tensors it runs the plain version (``plain.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slstm_scan import plain

_NAME = "slstm_scan"

#: the kernel's widest head (one thread per (gate, column), 4 * hd <= 1024)
MAX_HD = 256

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

#: R dtypes the kernel takes -> the C entry point's ``r_dtype`` code
R_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the kernel's layouts (the C entry point's ``layout`` argument)
ONE_CTA, CLUSTER = 0, 1
CLUSTER_HD = 256        # the head width the cluster layout takes
#: CTAs of a cluster a head (8 or 16)
CLUSTER_SIZE = 16


def plan(b: int, h: int, hd: int, aligned: bool = True) -> tuple[int, int]:
    """The kernel's layout for B lanes of H heads of width hd: (layout,
    cluster) as the C entry point takes them. ``aligned``: R starts on 16
    bytes.

    * hd == CLUSTER_HD, R aligned: a cluster of CLUSTER_SIZE CTAs per
      (head, group of up to 4 lanes), each holding 256 /
      CLUSTER_SIZE columns of the head's R for the whole launch;
      H * ceil(B / 4) clusters. Measured on an H100 (``probe.py``,
      PERF.md): 16 CTAs, R held as f64, take a step in about a third of
      the time of 8, which widen their f32 R every step.
    * Else (the ragged and small heads of the tests and of the reduced
      configurations): one CTA per (lane, head), one thread per (gate,
      column).
    """
    if hd == CLUSTER_HD and aligned:
        return CLUSTER, CLUSTER_SIZE
    return ONE_CTA, 0


_entry = []   # the C entry point, typed once


def _kernel():
    if not _entry:
        fn = build.load(_NAME).slstm_scan
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entry.append(fn)
    return _entry[0]


def _check(wx: torch.Tensor, r_all: torch.Tensor,
           state0: torch.Tensor) -> None:
    if wx.dim() != 5 or wx.shape[1] != 4 or wx.shape[0] < 1:
        raise ValueError(f"{_NAME}: wx {tuple(wx.shape)} is not (S >= 1, 4, "
                         f"B, H, hd)")
    _, _, b, h, hd = wx.shape
    if tuple(r_all.shape) != (4, h, hd, hd) \
            or tuple(state0.shape) != (4, b, h, hd):
        raise ValueError(f"{_NAME}: r_all {tuple(r_all.shape)} and state0 "
                         f"{tuple(state0.shape)} do not fit wx "
                         f"{tuple(wx.shape)}: expected (4, {h}, {hd}, {hd}) "
                         f"and (4, {b}, {h}, {hd})")
    for name, t in (("wx", wx), ("r_all", r_all), ("state0", state0)):
        if t.dtype not in ((torch.float32, torch.bfloat16) if t is r_all
                           else (torch.float32,)):
            raise TypeError(f"{_NAME}: {name} must be float32"
                            f"{' or bfloat16' if t is r_all else ''}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{_NAME}: {name} must be contiguous")


def slstm_scan(wx: torch.Tensor, r_all: torch.Tensor,
               state0: torch.Tensor):
    """Run the recurrence over all S steps from ``state0``; returns (hs,
    final state), f32."""
    _check(wx, r_all, state0)
    if not wx.is_cuda:
        return plain.slstm_scan(wx, r_all, state0)
    build.require_cuda(_NAME, wx, r_all, state0)
    s, _, b, h, hd = wx.shape
    if hd > MAX_HD:
        raise ValueError(f"{_NAME}: head_dim {hd} > {MAX_HD}, the widest "
                         f"head the kernel takes")
    hs = torch.empty((s, b, h, hd), dtype=torch.float32, device=wx.device)
    state = torch.empty_like(state0)
    layout, cluster = plan(b, h, hd, r_all.data_ptr() % 16 == 0)
    rc = _kernel()(wx.data_ptr(), r_all.data_ptr(), state0.data_ptr(),
                   hs.data_ptr(), state.data_ptr(), s, b, h, hd,
                   R_DTYPES[r_all.dtype], layout, cluster,
                   build.stream(wx.device))
    build.check(rc, _NAME)
    slstm_scan.launches += 1
    return hs, state


slstm_scan.launches = 0
