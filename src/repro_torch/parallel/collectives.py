"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (the JAX package's ``parallel/collectives.py``).

Each rank quantizes its gradient plus its carried residual to int8 with
one f32 scale per 1024-element chunk (round half to even, as
``jnp.round``), keeps what the rounding lost as its next residual
(error feedback: Seide et al. 2014; Karimireddy et al. 2019), and the
ranks' locally dequantized values are summed over the data axes and
divided by their number. As in the reference, the wire format is
modelled as (int8, f32 scales) for the traffic count
(``compression_ratio``) while the sum runs over the dequantized values,
one all-reduce a step over every leaf at once.
"""

from __future__ import annotations

from typing import Any

import torch

CHUNK = 1024


def quantize_grad(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8 quantization. Returns (q (n, 1024) int8,
    scales (n,) f32)."""
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % CHUNK
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(-1, CHUNK)
    scale = torch.amax(torch.abs(chunks), dim=1) / 127.0
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.clamp(torch.round(chunks * inv[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(tuple(shape)).to(dtype)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of ``mesh`` (``pod``, ``data``), in order."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def mesh_sum(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``x`` summed over the ranks of ``mesh`` along ``axes`` (the
    reference's ``psum``; ``("pod", "data")`` is the flattened
    sub-mesh). A plain tensor in, a plain tensor out, on every rank."""
    if not axes:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if len(axes) > 1:
        # one reduction over the flattened sub-mesh: every rank gets the
        # same bits (two in turn could round differently across ranks)
        mesh, axes = _flat(mesh, axes), ("_".join(axes),)
    pl = [Partial() if n in axes else Replicate()
          for n in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, pl, run_check=False).full_tensor()


_FLAT: dict = {}


def _flat(mesh, axes: tuple):
    """The 1-D sub-mesh of ``mesh`` over ``axes`` (made once: a new
    process group is a collective of every rank), outside any dispatch
    mode: a mesh's ranks are a real tensor, also in a step traced on
    fake tensors."""
    from torch.utils._python_dispatch import _disable_current_modes
    key = (id(mesh), axes)
    if key not in _FLAT or _FLAT[key][0] is not mesh:
        with _disable_current_modes():
            _FLAT[key] = (mesh, mesh[axes]._flatten("_".join(axes)))
    return _FLAT[key][1]


def axes_size(mesh, axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def compressed_psum(grads: list, err: list, mesh, axes: tuple
                    ) -> tuple[list, list]:
    """Error-feedback compressed all-reduce (mean) over ``axes`` of
    ``mesh``. ``grads``, ``err``: this rank's leaves, in one order.
    Returns (mean gradients in f32, new residuals)."""
    n = axes_size(mesh, axes)
    local, new_err = [], []
    for g, e in zip(grads, err):
        corrected = g.to(torch.float32) + e
        q, s = quantize_grad(corrected)
        deq = dequantize_grad(q, s, g.shape)
        new_err.append(corrected - deq)          # error feedback
        local.append(deq.reshape(-1))
    total = mesh_sum(torch.cat(local), mesh, axes)
    out, at = [], 0
    for g in grads:
        out.append((total[at:at + g.numel()] / n).reshape(g.shape))
        at += g.numel()
    return out, new_err


def init_error_state(params: Any, mesh) -> Any:
    """Zero residuals of ``(n_dp, *shape)`` f32 for each parameter, placed
    one row a data rank (a DTensor sharded on dim 0 over the data axes):
    the reference's zeros with the leading per-rank dim its compressed
    step carries, so a checkpoint holds the global array."""
    from repro_torch.optim.adamw import tree_map
    from repro_torch.parallel.sharding import Sharding, place
    axes = dp_axes(mesh)
    n_dp = axes_size(mesh, axes)
    rows = Sharding(mesh, (axes or None,))

    def zeros(p):
        return place(torch.zeros((n_dp,) + tuple(p.shape),
                                 dtype=torch.float32, device=p.device), rows)
    return tree_map(zeros, params)


def compression_ratio(params: Any) -> float:
    """Wire bytes (int8 + scales) / f32 bytes."""
    from repro_torch.optim.adamw import leaves
    total = sum(x.numel() for x in leaves(params))
    wire = total + 4 * (total // CHUNK + 1)
    return wire / (4 * total)
