"""Plain PyTorch version of the sLSTM recurrence: the HOST backend and
the oracle the CUDA kernel is held against.

A time loop over the stabilised step of the JAX package's
``kernels/slstm_scan/ref.py`` (the same math as ``models/xlstm.py``'s
``_slstm_step``), in f32 but for the recurrent dot product, whose exact
f32 products are summed in f64 and rounded once to f32: the correctly
rounded dot, whatever the order of the sum. The CUDA kernel computes
the same operations in the same order, so the two agree to the last bit
but for rare ties of that rounding (see ``csrc/slstm_scan.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def slstm_step(r_all: torch.Tensor, wx_t: torch.Tensor, state):
    """One step. r_all: (4, H, hd, hd); wx_t: (4, B, H, hd) input
    pre-activations; state: (c, n, h, m), each (B, H, hd). Returns the
    new (c, n, h, m)."""
    c, n, h, m = state
    rh = torch.einsum("bhe,ghef->gbhf", h.double(), r_all.double())
    pre = wx_t + rh.to(wx_t.dtype)
    i_r, f_r, z_r, o_r = pre.unbind(0)
    logf = F.logsigmoid(f_r)
    m_new = torch.maximum(logf + m, i_r)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(logf + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_r)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_r) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_scan(wx: torch.Tensor, r_all: torch.Tensor,
               state0: torch.Tensor):
    """wx: (S, 4, B, H, hd); r_all: (4, H, hd, hd); state0: (4, B, H, hd)
    stacked (c, n, h, m). Returns (hs (S, B, H, hd) f32, state (4, B, H,
    hd) f32)."""
    f32 = torch.float32
    r = r_all.to(f32)
    st = tuple(state0.to(f32).unbind(0))
    hs = []
    for wx_t in wx.to(f32).unbind(0):
        st = slstm_step(r, wx_t, st)
        hs.append(st[2])
    return torch.stack(hs), torch.stack(st)
