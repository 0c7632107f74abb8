"""Step builders of the port (the JAX package's ``train/step.py``):
train (autograd + AdamW), prefill and decode, on one device.

The train forward runs under ``kernels.api.grad_safe_context``: the
Hopper kernels define no backward, so every dispatched op binds its
differentiable torch implementation there, as the reference binds XLA
under value_and_grad. Gradients come from ``torch.autograd.grad`` over
the parameter leaves; AdamW then updates the state in place under
``no_grad``. A step reads nothing back to the host: its metrics are 0-d
tensors on the state's device, and the loop's ``float(loss)`` is its
one synchronisation. ``n_micro > 1`` sums f32 gradients over equal
microbatches and divides, as the reference's ``lax.scan`` does.

The sharded variants (mesh arguments, ``state_shardings``,
``batch_shardings``, ``cache_shardings``, the compressed-DP step) are
not here: they belong to the port's parallel layer.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.api import grad_safe_context, use_context
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.platforms import resolve_device

TrainState = dict  # {"params": tree, "opt": {m, v, step}}

PREFILL_CACHE_PAD = 16   # decode headroom


def prefill_cache_len(seq: int) -> int:
    return seq + PREFILL_CACHE_PAD


# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Token-mean CE. logits: (B, S, V) any float; targets: (B, S) int.
    In f32; positions whose target is ``ignore_id`` carry no loss."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.clamp(targets, min=0).to(torch.int64)
    picked = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = lse - picked
    mask = (targets != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _loss_fn(model: Model, params, batch) -> tuple[torch.Tensor, dict]:
    # this forward sits under autograd; the kernels define no backward,
    # so the dispatch binds the differentiable torch implementations
    with use_context(grad_safe_context()):
        logits, _ = model.forward(params, batch, mode="train")
    tgt = batch["targets"]
    # VLM: logits cover img-prefix + text; targets already full-seq length.
    if logits.shape[1] != tgt.shape[1]:
        tgt = tgt[:, :logits.shape[1]]
    loss = cross_entropy(logits, tgt)
    return loss, {"loss": loss}


# ----------------------------------------------------------------------------
# Train step
# ----------------------------------------------------------------------------

def init_train_state(model: Model, generator: torch.Generator,
                     device=None) -> TrainState:
    """f32 parameters drawn from ``generator`` on ``device`` (default
    ``cuda``) and a fresh AdamW state."""
    params = model.init_values(generator, resolve_device(device))
    return {"params": params, "opt": adamw.init_state(params)}


def _on_device(batch: dict, device) -> dict:
    """The batch as tensors on ``device`` (numpy arrays are copied)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(model: Model, params, batch) -> tuple:
    """(loss, gradients shaped as ``params``) of one batch: the
    reference's ``value_and_grad(_loss_fn)``. ``params`` are not
    modified; the gradients are in each leaf's dtype."""
    live = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, _ = _loss_fn(model, live, batch)
        grads = iter(torch.autograd.grad(loss, list(adamw.leaves(live)),
                                         allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), adamw.tree_map(lambda _: next(grads), live)


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig, *,
                    n_micro: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): the state
    updated in place, metrics ``loss``, ``grad_norm`` and ``lr`` (0-d
    tensors on the state's device). ``n_micro > 1`` accumulates f32
    gradients over microbatches (the batch must divide evenly). A batch
    of numpy arrays is moved to the parameters' device."""

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        device = next(adamw.leaves(params)).device
        batch = _on_device(batch, device)
        if n_micro == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"a batch of {b} rows does not split into "
                                 f"{n_micro} microbatches")
            mb = b // n_micro
            grads, losses = None, []
            for i in range(n_micro):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = value_and_grad(model, params, part)
                losses.append(l)
                if grads is None:
                    grads = [x.to(torch.float32) for x in adamw.leaves(g)]
                else:
                    for acc, x in zip(grads, adamw.leaves(g)):
                        acc.add_(x)
            mean = iter([g / n_micro for g in grads])
            grads = adamw.tree_map(lambda _: next(mean), params)
            loss = torch.stack(losses).mean()
        _, opt, metrics = adamw.apply_updates(params, grads, state["opt"],
                                              opt_cfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


# ----------------------------------------------------------------------------
# Serving steps (prefill / decode)
# ----------------------------------------------------------------------------

def make_prefill_step(model: Model) -> Callable:
    """prefill_step(params, batch) -> (last_logits, cache), the cache
    ``prefill_cache_len(seq)`` long."""

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, seq = tokens.shape
        cache = model.init_cache(b, prefill_cache_len(seq),
                                 device=tokens.device)
        logits, cache = model.forward(params, batch, mode="prefill",
                                      cache=cache)
        return logits[:, -1], cache

    return prefill


def make_decode_step(model: Model, *, sample: bool = False) -> Callable:
    """decode_step(params, cache, tokens, pos) -> (next_tokens|logits,
    cache). ``tokens``: (B, 1); ``pos``: the position, a scalar or (B,)."""

    def decode(params, cache, tokens, pos):
        logits, new_cache = model.forward(
            params, {"tokens": tokens}, mode="decode", cache=cache, pos=pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return (nxt if sample else logits[:, -1]), new_cache

    return decode
