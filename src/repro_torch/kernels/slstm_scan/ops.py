"""Wrapper of the sLSTM recurrence kernel (``csrc/slstm_scan.cu``).

``slstm_scan(wx, r_all, state0)`` keeps the reference op's signature:
wx (S, 4, B, H, hd) input pre-activations (Wx + b of the gates i, f, z,
o), r_all (4, H, hd, hd) stacked recurrent weights, state0 (4, B, H, hd)
stacked (c, n, h, m); it returns (hs (S, B, H, hd), state (4, B, H,
hd)), all f32. On CUDA tensors it launches the kernel, which runs any
S >= 1 in one launch from ``state0`` (the reference's state-preserving
chunk padding has no counterpart); on CPU tensors it runs the plain
version (``plain.py``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.slstm_scan import plain

_NAME = "slstm_scan"

#: the kernel's widest head (one thread per (gate, column), 4 * hd <= 1024)
MAX_HD = 256

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib():
    lib = build.load(_NAME)
    lib.slstm_scan.argtypes = _ARGTYPES
    lib.slstm_scan.restype = ctypes.c_int
    return lib


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
        if t.dtype != torch.float32:
            raise TypeError(f"{_NAME}: {name} must be float32, got "
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
    rc = _lib().slstm_scan(wx.data_ptr(), r_all.data_ptr(),
                           state0.data_ptr(), hs.data_ptr(),
                           state.data_ptr(), s, b, h, hd,
                           build.stream(wx.device))
    build.check(rc, _NAME)
    slstm_scan.launches += 1
    return hs, state


slstm_scan.launches = 0
