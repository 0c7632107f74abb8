"""Mixture-of-Experts FFN of the port (the JAX package's ``models/moe.py``):
top-k routing with a per-expert capacity.

Each expert takes its own highest-gate tokens up to its capacity C,
gathers them, runs the gated FFN and adds its weighted outputs back:
``moe_ffn`` does so per batch row (the reference's grouped form, its
default), ``_moe_ffn_global`` over every token of the batch at once (its
``REPRO_BASELINE`` form, kept for the equivalence tests). The router and
its softmax run in f32; the expert products are batched bf16 products
with f32 accumulation (``torch.matmul``, as the reference leaves its
einsums to XLA: no Pallas kernel computes them).

The combine adds each expert's weighted outputs into their tokens as a
one-hot product over the (expert, capacity) entries, not a scatter-add:
on the card a scatter-add adds in the order its atomics land, which
changes from run to run, where the product sums in a fixed order. Among
tokens of equal gate, ``torch.topk`` and ``jax.lax.top_k`` may take
different ones; such ties are tokens of gate 0 (weighed 0 in the combine)
or exact copies, so the output and the routing counters do not depend on
which.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import _act, ninit
from repro_torch.parallel.sharding import constrain

_BF16 = torch.bfloat16
_F32 = torch.float32


def init_moe(gen: torch.Generator, cfg: ArchConfig, device,
             dtype=_F32) -> dict:
    """``router`` (d, E) and the experts' gated FFN weights ``gate`` /
    ``up`` (E, d, ff) and ``down`` (E, ff, d)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    expert_in = ("experts", "param_embed", "expert_ff")
    return {"router": ninit(gen, (d, e), d, device, dtype,
                            axes=("param_embed", None)),
            "gate": ninit(gen, (e, d, ff), d, device, dtype, axes=expert_in),
            "up": ninit(gen, (e, d, ff), d, device, dtype, axes=expert_in),
            "down": ninit(gen, (e, ff, d), ff, device, dtype,
                          axes=("experts", "expert_ff", "param_embed"))}


def prepare_moe(p: dict) -> dict:
    """A MoE dict (one layer's or stacked) with the f32 router and bf16
    experts that ``moe_ffn`` would cast at every call."""
    return {**p, "router": p["router"].to(_F32),
            **{k: p[k].to(_BF16) for k in ("gate", "up", "down")}}


def _count_routes(top_i: torch.Tensor, b: int, e: int,
                  counts: torch.Tensor) -> torch.Tensor:
    """``counts`` (b, e) plus the executed top-k assignments ``top_i``
    ((b, s, k) or (b * s, k)) of each lane. Every executed row counts,
    bucket padding and parked lanes included: a record of device work,
    not of what a request was billed. The one-hot is a comparison with
    the expert ids: ``one_hot`` reads the ids' maximum to the host on
    the CPU, a host sync inside the tick."""
    experts = torch.arange(e, device=top_i.device)
    hits = (top_i.reshape(b, -1, 1) == experts).sum(dim=1)
    return counts + hits.to(counts.dtype)


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """f32 router logits, softmax and the renormalised top-k of each
    token: (gate probabilities, expert ids), each (..., k)."""
    logits = x.to(_F32) @ router.to(_F32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    return top_p / top_p.sum(dim=-1, keepdim=True), top_i


def _experts(p: dict, x_e: torch.Tensor, act: str) -> torch.Tensor:
    """The gated FFN of every expert over its gathered rows: x_e
    (E, rows, d) bf16 -> (E, rows, d) bf16."""
    g = _act(act)(torch.matmul(x_e, p["gate"].to(_BF16)))
    u = torch.matmul(x_e, p["up"].to(_BF16))
    h = constrain(g * u, "experts", None, "expert_ff")
    return torch.matmul(h, p["down"].to(_BF16))


def _combine(sel_tok: torch.Tensor, y_e: torch.Tensor,
             n: int) -> torch.Tensor:
    """Add each entry's f32 output y_e (..., rows, d) into token
    sel_tok (..., rows) of n, as a one-hot (..., n, rows) product."""
    onehot = (sel_tok[..., None, :] == torch.arange(
        n, device=sel_tok.device)[:, None]).to(_F32)
    return torch.matmul(onehot, y_e)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig,
            grouped: bool = True, route_counts=None, valid_len=None):
    """x: (B, S, d) -> (B, S, d); capacity and each expert's top-C per
    batch row (``grouped``, the reference's default) or over all B * S
    tokens. ``route_counts`` ((B, E) int, the serving cache's routing
    plane): returns ``(out, counts + this call's assignments)``.
    ``valid_len`` (serving prefill): positions at or past it are bucket
    padding, whose gates are zeroed before the capacity cut, so padding
    never takes a live token's place in an expert."""
    if not grouped:
        return _moe_ffn_global(p, x, cfg, route_counts, valid_len)
    b, s, d = x.shape
    e, top_k = cfg.n_experts, cfg.top_k
    cap = min(s, max(top_k, int(cfg.capacity_factor * s * top_k / e)))

    top_p, top_i = _route(x, p["router"], top_k)              # (b, s, k)
    gate = torch.zeros((b, s, e), dtype=_F32, device=x.device) \
        .scatter(-1, top_i, top_p)
    if valid_len is not None:
        live = torch.arange(s, device=x.device) < valid_len
        gate = gate * live[None, :, None]
    gate_t = constrain(gate.transpose(1, 2), "batch", "experts", None)
    sel_gate, sel_tok = torch.topk(gate_t, cap, dim=-1)        # (b, e, cap)

    rows = torch.arange(b, device=x.device)[:, None, None]
    x_e = x.to(_BF16)[rows, sel_tok]                           # (b, e, cap, d)
    x_e = constrain(x_e, "batch", "experts", None, "embed")
    y_e = _experts(p, x_e.transpose(0, 1).reshape(e, b * cap, d), cfg.act)
    y_e = y_e.reshape(e, b, cap, d).transpose(0, 1) \
        * sel_gate[..., None].to(_BF16)                        # combine weights
    y_e = constrain(y_e, "batch", "experts", None, "embed")
    out = _combine(sel_tok.reshape(b, e * cap),
                   y_e.reshape(b, e * cap, d).to(_F32), s).to(x.dtype)
    out = constrain(out, "batch", "q_seq", "embed")
    if route_counts is not None:
        return out, _count_routes(top_i, b, e, route_counts)
    return out


def _moe_ffn_global(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    route_counts=None, valid_len=None):
    """The reference's ``REPRO_BASELINE`` dispatch: one capacity and one
    top-C per expert over all B * S tokens."""
    b, s, d = x.shape
    e, top_k = cfg.n_experts, cfg.top_k
    n = b * s
    cap = min(n, max(top_k, int(cfg.capacity_factor * n * top_k / e)))

    xf = x.reshape(n, d)
    top_p, top_i = _route(xf, p["router"], top_k)             # (n, k)
    gate = torch.zeros((n, e), dtype=_F32, device=x.device) \
        .scatter(-1, top_i, top_p)
    if valid_len is not None:
        live = (torch.arange(s, device=x.device) < valid_len).repeat(b)
        gate = gate * live[:, None]
    gate_t = constrain(gate.T, "experts", None)                # (e, n)
    sel_gate, sel_tok = torch.topk(gate_t, cap, dim=-1)       # (e, cap)

    x_e = constrain(xf[sel_tok].to(_BF16), "experts", None, "embed")
    y_e = _experts(p, x_e, cfg.act).to(_F32) * sel_gate[..., None]
    y_e = constrain(y_e, "experts", None, "embed")
    out = _combine(sel_tok.reshape(-1), y_e.reshape(e * cap, d), n)
    out = constrain(out.to(x.dtype).reshape(b, s, d), "batch", "q_seq",
                    "embed")
    if route_counts is not None:
        return out, _count_routes(top_i, b, e, route_counts)
    return out
