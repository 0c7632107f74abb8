"""Decoder-only stack of the port (the JAX package's
``models/transformer.py``), for the families ported so far: xLSTM.

The layer stack is ``n_segments`` repetitions of a per-arch segment
pattern ((mLSTM, sLSTM) pairs for xLSTM); each parameter and cache leaf
carries a leading ``(n_segments, ...)`` axis, as the reference's
``lax.scan`` stacks them, and a Python loop over the segments takes the
scan's place. Prefill returns a fresh stacked cache; decode writes each
block's new state into the pool it was given, **in place** (the
reference rewrites the state in full every step too), and returns that
pool. The other decoder-only families (attention, MoE, mamba blocks) are
not ported yet: ``segment_pattern`` raises ``NotImplementedError`` for
them (ROADMAP queue 1, item 14).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (embed, init_embedding, init_rmsnorm,
                                       layer_slice, logits_head, ninit,
                                       pad_vocab, prepare_head, rmsnorm,
                                       stack_layers)

_NOT_PORTED = "ROADMAP queue 1, item 14"


def segment_pattern(cfg: ArchConfig) -> list[tuple[str, str]]:
    """[(block_type, attn_kind)] per segment: (mLSTM, sLSTM) for xLSTM.
    Every other family is refused here."""
    if not cfg.xlstm:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is "
                                  f"not ported yet ({_NOT_PORTED})")
    return [("mlstm", "-"), ("slstm", "-")]


def n_segments(cfg: ArchConfig) -> int:
    unit = len(segment_pattern(cfg))
    assert cfg.n_layers % unit == 0, (cfg.name, cfg.n_layers, unit)
    return cfg.n_layers // unit


# ----------------------------------------------------------------------------
# Block init / apply
# ----------------------------------------------------------------------------

#: block type -> (state kind, init, apply, state init)
_BLOCKS = {"mlstm": ("mstate", xlstm_mod.init_mlstm, xlstm_mod.mlstm_block,
                     xlstm_mod.init_mlstm_cache),
           "slstm": ("sstate", xlstm_mod.init_slstm, xlstm_mod.slstm_block,
                     xlstm_mod.init_slstm_cache)}


def _init_block(gen, cfg: ArchConfig, btype: str, device) -> dict:
    return {"ln1": init_rmsnorm(cfg.d_model, device),
            btype: _BLOCKS[btype][1](gen, cfg, device)}


def _apply_block(bp: dict, x, cfg: ArchConfig, btype: str, *, mode: str,
                 cache: Optional[dict]):
    """One block with its residual. ``cache``: this block's subtree of
    one segment (``{"mstate": ...}`` / ``{"sstate": ...}``) or None.
    Returns (x, new subtree or None)."""
    kind, _, fn, _ = _BLOCKS[btype]
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    sub = None if cache is None else cache.get(kind)
    y, new = fn(bp[btype], h, cfg, mode=mode, cache=sub)
    return x + y, (None if new is None else {kind: new})


def _block_cache(cfg: ArchConfig, btype: str, batch: int, dtype,
                 device) -> dict:
    # "q8_0"/"q4_0" quantize KV planes only; recurrent states stay bf16
    if isinstance(dtype, str):
        dtype = torch.bfloat16
    kind, _, _, init = _BLOCKS[btype]
    return {kind: init(cfg, batch, dtype, device)}


# ----------------------------------------------------------------------------
# Whole-model init / apply
# ----------------------------------------------------------------------------

def init_decoder(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Parameters with the reference's tree, shapes and distributions
    (``models/transformer.py:191-226``): ``embed``, ``segments`` stacked
    on a leading (n_segments, ...) axis, ``final_norm`` and, for an
    untied head, ``lm_head`` (d, padded vocab)."""
    pattern = segment_pattern(cfg)
    segs = [{f"block{j}": _init_block(gen, cfg, bt, device)
             for j, (bt, _) in enumerate(pattern)}
            for _ in range(n_segments(cfg))]
    params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device),
        "segments": stack_layers(segs),
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ninit(gen, (cfg.d_model, pad_vocab(cfg.vocab)),
                                  cfg.d_model, device)
    return params


_PREPARE = {"mlstm": xlstm_mod.prepare_mlstm,
            "slstm": xlstm_mod.prepare_slstm}


def prepare_serving(params: dict, cfg: ArchConfig) -> dict:
    """The serving tree of ``params``: each block's weights with what its
    forward derives from them made once (``xlstm.prepare_mlstm`` /
    ``prepare_slstm``), and a tied head's f32 operand."""
    segs = dict(params["segments"])
    for j, (bt, _) in enumerate(segment_pattern(cfg)):
        blk = segs[f"block{j}"]
        segs[f"block{j}"] = {**blk, bt: _PREPARE[bt](blk[bt])}
    out = {**params, "segments": segs}
    if "lm_head" not in params:
        out["embed"] = prepare_head(params["embed"])
    return out


def _write_state(pool, new, i: int) -> None:
    """Write segment ``i``'s new block state into the stacked pool."""
    for key, sub in new.items():
        if isinstance(sub, dict):
            _write_state(pool[key], sub, i)
        else:
            pool[key][i].copy_(sub)


def decoder_forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
                    mode: str = "train", cache=None, pos=None):
    """tokens: (B, S) (S = 1 for decode). Returns (logits (B, S, padded
    vocab) f32, cache): None for train, a fresh stacked cache for
    prefill (``cache`` names its dtype), and for decode the pool
    ``cache`` itself, with every block's new state written into it."""
    pattern = segment_pattern(cfg)
    x = embed(params["embed"], tokens)
    seg_cache = None if cache is None else cache["segments"]
    new_segs = []
    for i in range(n_segments(cfg)):
        sp = layer_slice(params["segments"], i)
        sc = None if seg_cache is None else layer_slice(seg_cache, i)
        new = {}
        for j, (bt, _) in enumerate(pattern):
            name = f"block{j}"
            x, nc = _apply_block(sp[name], x, cfg, bt, mode=mode,
                                 cache=None if sc is None else sc[name])
            new[name] = nc
        if mode == "decode":
            _write_state(seg_cache, new, i)
        new_segs.append(new)
    new_cache = None
    if mode == "decode":
        new_cache = cache
    elif mode == "prefill":
        new_cache = {"segments": stack_layers(new_segs)}
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_head(params["embed"], x, cfg.vocab,
                         softcap=cfg.final_softcap,
                         head=params.get("lm_head"))
    return logits, new_cache


def init_decoder_cache(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None) -> dict:
    """The stacked per-segment state cache, ``{"segments": {blockJ:
    {kind: {leaf: (n_segments, batch, ...)}}}}``. Recurrent state is O(1)
    in ``max_len``."""
    pattern = segment_pattern(cfg)
    segs = [{f"block{j}": _block_cache(cfg, bt, batch, dtype, device)
             for j, (bt, _) in enumerate(pattern)}
            for _ in range(n_segments(cfg))]
    return {"segments": stack_layers(segs)}
