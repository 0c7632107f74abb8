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

The combine adds each token's at most top_k weighted outputs back in
f32, in ascending expert id, gathered through an inverse map from
(token, expert) to the expert's capacity slot (``_combine``): no
scatter-add, whose atomics on the card land in an order that changes
from run to run, and no intermediate of tokens x (expert, capacity)
entries. Ascending expert id is the order in which a one-hot product
over the entries meets them, so the two are bit-equal on the CPU where
the library sums that product's entries in order (the tests' oracle).
Among tokens of equal gate, ``torch.topk`` and
``jax.lax.top_k`` may take different ones; such ties are tokens of gate
0 (weighed 0 in the combine) or exact copies, so the output and the
routing counters do not depend on which.

Under a meshed serving step with ``model`` > 1 the layer takes its
``model`` shard (``layers.unit_form``). The ``experts`` form, where the
experts divide ``model`` (expert parallelism), runs this rank's experts
on the tokens they took, then all-reduces its f32 partial of the
combine once before the one rounding. The ``expert_ff`` form runs every
expert on this rank's columns of its FFN and all-reduces the ``down``
product's f32 partial before that product's rounding
(``layers.row_parallel``). Every rank computes the routing whole, from
the whole router, so it and the routing counters are the same on every
rank.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import (_act, model_axis, model_dim, ninit,
                                       row_parallel)
from repro_torch.parallel.sharding import constrain

_BF16 = torch.bfloat16
#: the least elements the combine gathers at once ((b, chunk, k, d)):
#: below it a prompt's combine is one chunk of a few kernels
COMBINE_ELEMS = 1 << 24
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
    (E, rows, d) bf16 -> (E, rows, d) bf16. In the ``expert_ff`` form
    (``down``: this rank's rows of each expert's FFN) the ``down``
    product's f32 partial (of the exact bf16 products) is all-reduced,
    then rounded once, where the unsplit product rounds."""
    g = _act(act)(torch.matmul(x_e, p["gate"].to(_BF16)))
    u = torch.matmul(x_e, p["up"].to(_BF16))
    h = constrain(g * u, "experts", None, "expert_ff")
    if model_dim(p["down"]) == 1:
        return row_parallel(_partial_down(h, p["down"].to(_BF16)))
    return torch.matmul(h, p["down"].to(_BF16))


def _partial_down(h: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The ``expert_ff`` form's f32 partial of h @ down: bf16 operands,
    whose products f32 holds exactly, summed in f32."""
    return torch.matmul(h.to(_F32), down.to(_F32))


def _own_experts(p: dict, sel_gate: torch.Tensor, sel_tok: torch.Tensor):
    """(sel_gate, sel_tok, first): the selection ((..., E, C), experts on
    dim -2) of the experts this rank runs, and the id of the first: in
    the ``experts`` form (``gate`` holds this rank's E / tp experts) its
    block, else every expert from 0."""
    if model_dim(p["gate"]) != 0:
        return sel_gate, sel_tok, 0
    n = p["gate"].shape[0]
    first = model_axis().rank * n
    return (sel_gate.narrow(-2, first, n), sel_tok.narrow(-2, first, n),
            first)


def _combine(sel_tok: torch.Tensor, y_e: torch.Tensor, top_i: torch.Tensor,
             first: int = 0, n_experts: int = 0) -> torch.Tensor:
    """Each token's weighted expert outputs, summed in f32. ``sel_tok``
    ((b,) E', C): the tokens each of E' experts (ids ``first`` on, of
    ``n_experts``, by default E') took; ``y_e`` ((b,) E' * C, d): their
    weighted outputs; ``top_i`` ((b,) n, k): each token's experts. An
    inverse map (b, n, n_experts) holds the entry (e * C + slot) of token
    t in expert e, or -1 where e is another rank's or did not take it (a
    scatter whose targets are unique: an expert takes a token once).
    Gathered at each token's experts in ascending id, it gives the
    token's k entries (a zero for -1), which one sum over k adds in that
    order, in f32. A chunk of ceil(n / k) tokens at a time, or of
    ``COMBINE_ELEMS`` gathered elements where that is more: the gather
    (b, chunk, k, d) is no larger than the (b, n, d) f32 sum or that
    constant, and a decode step or a short prompt is one chunk. Returns
    ((b,) n, d) f32."""
    lead = sel_tok.dim() == 2
    if lead:
        sel_tok, y_e, top_i = sel_tok[None], y_e[None], top_i[None]
    b, n_exp, cap = sel_tok.shape
    n, k = top_i.shape[1:]
    dev = sel_tok.device
    inv = torch.full((b, n, n_experts or n_exp), -1, dtype=torch.long,
                     device=dev)
    inv[..., first:first + n_exp].scatter_(
        1, sel_tok.transpose(1, 2),
        torch.arange(n_exp * cap, device=dev).view(n_exp, cap).T
        .expand(b, cap, n_exp))
    entry = inv.gather(-1, torch.sort(top_i, dim=-1).values)    # (b, n, k)
    rows = torch.arange(b, device=dev)[:, None, None]
    chunk = max(-(-n // k), COMBINE_ELEMS // (b * k * y_e.shape[-1]))
    sums = []
    for t in range(0, n, chunk):
        at = entry[:, t:t + chunk]
        g = y_e[rows, at.clamp(min=0)]                     # (b, chunk, k, d)
        sums.append(torch.where(at[..., None] >= 0, g, 0)
                    .sum(2, dtype=_F32))
    out = sums[0] if len(sums) == 1 else torch.cat(sums, 1)
    return out[0] if lead else out


def _finish(p: dict, out: torch.Tensor, dtype) -> torch.Tensor:
    """The combine's f32 sum in ``dtype``; in the ``experts`` form this
    rank's partial is all-reduced over ``model`` first, then rounded
    once."""
    if model_dim(p["gate"]) == 0:
        return row_parallel(out, dtype)
    return out.to(dtype)


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
    sel_gate, sel_tok, first = _own_experts(p, sel_gate, sel_tok)
    n_exp = sel_tok.shape[1]

    rows = torch.arange(b, device=x.device)[:, None, None]
    x_e = x.to(_BF16)[rows, sel_tok]                           # (b, e, cap, d)
    x_e = constrain(x_e, "batch", "experts", None, "embed")
    y_e = _experts(p, x_e.transpose(0, 1).reshape(n_exp, b * cap, d),
                   cfg.act)
    y_e = y_e.reshape(n_exp, b, cap, d).transpose(0, 1) \
        * sel_gate[..., None].to(_BF16)                        # combine weights
    y_e = constrain(y_e, "batch", "experts", None, "embed")
    out = _finish(p, _combine(sel_tok, y_e.reshape(b, n_exp * cap, d),
                              top_i, first, e), x.dtype)
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
    sel_gate, sel_tok, first = _own_experts(p, sel_gate, sel_tok)

    x_e = constrain(xf[sel_tok].to(_BF16), "experts", None, "embed")
    y_e = _experts(p, x_e, cfg.act).to(_F32) * sel_gate[..., None]
    y_e = constrain(y_e, "experts", None, "embed")
    out = _finish(p, _combine(sel_tok, y_e.reshape(-1, d), top_i, first, e),
                  x.dtype)
    out = constrain(out.reshape(b, s, d), "batch", "q_seq", "embed")
    if route_counts is not None:
        return out, _count_routes(top_i, b, e, route_counts)
    return out
