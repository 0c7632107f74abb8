"""Decoder-only stack of the port (the JAX package's
``models/transformer.py``): the dense and MoE attention families, xLSTM
and the zamba2 hybrid.

The layer stack is ``n_segments`` repetitions of a per-arch segment
pattern (one attention block for dense and MoE models, (local, global)
attention pairs for gemma2, (mLSTM, sLSTM) pairs for xLSTM, five mamba
blocks and a shared attention block for zamba2); each parameter and
cache leaf carries a leading ``(n_segments, ...)`` axis, as the
reference's ``lax.scan`` stacks them, and a Python loop over the
segments takes the scan's place. The hybrid's layers that do not fill a
whole segment (zamba2: 81 % 6 = 3 mamba blocks) form the ``tail``,
stacked the same way and run after the segments.

zamba2's attention block is shared: its parameters live once in
``params["shared"]`` (a segment's ``shared_attn`` subtree is empty, as in
the reference), and each of its occurrences keeps its own K/V planes in
the stacked pool.

An attention block is rmsnorm, attention with rotary positions, and a
gated MLP or a MoE FFN, each with its residual. Its cache subtree holds
``kv`` (the K/V planes) and, for MoE, ``routing``: per-lane counters of
the executed top-k assignments, (lanes, n_experts) int32. Prefill
returns a fresh stacked cache (the prompt's K/V padded to the cache's
length, the prompt's routing counts). Decode writes in place into the
pool it was given: each attention layer its new K/V rows, each MoE layer
its counters, each recurrent block its whole new state (the reference
rewrites that in full every step too); it returns that pool. Under a
meshed decode step each block reads and writes one layer of its cache,
this rank's rows, gathered (``layers.gather_cache_layer``), and the
layer's new values go back into the pool's shards.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (attention_form, bf16_proj, embed,
                                       init_embedding,
                                       gather_cache_layer, gather_layer,
                                       init_mlp, init_rmsnorm, keep_layer,
                                       layer_slice,
                                       logits_head, mlp, ninit, pad_vocab,
                                       prepare_head, remat, remat_on,
                                       rmsnorm, stack_layers,
                                       write_cache_layer)
from repro_torch.parallel.sharding import constrain


def segment_pattern(cfg: ArchConfig) -> list[tuple[str, str]]:
    """[(block_type, attn_kind)] per segment: (mLSTM, sLSTM) for xLSTM,
    ``attn_every - 1`` mamba blocks and the shared attention block for
    the hybrid, (local, global) attention for gemma2, one global
    attention block for the other dense and MoE models."""
    if cfg.xlstm:
        return [("mlstm", "-"), ("slstm", "-")]
    if cfg.family == "hybrid" and cfg.attn_every:
        return [("mamba", "-")] * (cfg.attn_every - 1) \
            + [("shared_attn", "global")]
    if cfg.local_global:
        return [("attn", "local"), ("attn", "global")]
    return [("attn", "global")]


#: the decoder leaves that ``mm`` / ``mm_out``, the embedding and the head
#: take quantized, blocked along axis -2, their contraction axis
_QUANT_LEAVES = frozenset({"wo", "up", "gate", "down", "table", "lm_head"})


def quantizable(path: tuple, leaf) -> bool:
    """``quantize_tree``'s predicate for a decoder tree: the output and
    MLP projections, the embedding table and the head. The Q/K/V
    projections stay float (their axis -2 is the heads, along which
    ``quantize_tree`` would block them at 32 heads; at fewer it leaves
    them float as well), and so do the norms, biases, the MoE router and
    its experts, which the forward casts as float tensors."""
    return path[-1] in _QUANT_LEAVES and "moe" not in path


def tail_pattern(cfg: ArchConfig) -> list[tuple[str, str]]:
    """The layers that do not fill a whole segment (zamba2: 81 % 6 = 3
    mamba blocks)."""
    if cfg.family == "hybrid" and cfg.attn_every \
            and cfg.n_layers % cfg.attn_every:
        return [("mamba", "-")] * (cfg.n_layers % cfg.attn_every)
    return []


def n_segments(cfg: ArchConfig) -> int:
    unit = len(segment_pattern(cfg))
    if cfg.family == "hybrid" and cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    assert cfg.n_layers % unit == 0, (cfg.name, cfg.n_layers, unit)
    return cfg.n_layers // unit


# ----------------------------------------------------------------------------
# Block init / apply
# ----------------------------------------------------------------------------

#: recurrent block type -> (state kind, init, apply, state init)
_BLOCKS = {"mlstm": ("mstate", xlstm_mod.init_mlstm, xlstm_mod.mlstm_block,
                     xlstm_mod.init_mlstm_cache),
           "slstm": ("sstate", xlstm_mod.init_slstm, xlstm_mod.slstm_block,
                     xlstm_mod.init_slstm_cache),
           "mamba": ("ssm", ssm_mod.init_mamba, ssm_mod.mamba_block,
                     ssm_mod.init_mamba_cache)}

#: the block types whose subtree holds attention K/V planes
_KV_BLOCKS = ("attn", "shared_attn")


def _init_block(gen, cfg: ArchConfig, btype: str, device, dtype) -> dict:
    """One block's parameters; ``shared_attn`` has none (they live in
    ``params["shared"]``). The mamba projections take ``dtype`` as the
    attention's do; the xLSTM blocks stay f32."""
    if btype == "shared_attn":
        return {}
    if btype == "mamba":
        return {"ln1": init_rmsnorm(cfg.d_model, device),
                "mamba": ssm_mod.init_mamba(gen, cfg, device, dtype)}
    if btype == "attn":
        p = {"ln1": init_rmsnorm(cfg.d_model, device),
             "attn": attn_mod.init_attention(gen, cfg, device, dtype)}
        if cfg.d_ff:
            p["ln2"] = init_rmsnorm(cfg.d_model, device)
            if cfg.is_moe:
                p["moe"] = moe_mod.init_moe(gen, cfg, device, dtype)
            else:
                p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, device,
                                    dtype)
        return p
    return {"ln1": init_rmsnorm(cfg.d_model, device),
            btype: _BLOCKS[btype][1](gen, cfg, device)}


def _attn_block(bp: dict, x, cfg: ArchConfig, kind: str, *, mode: str,
                cache: Optional[dict], pos, layer_idx, n_valid):
    """One attention block with its residuals. ``cache``: this block's
    subtree, ``{"kv": ..., "routing": ...}``; in decode a stacked pool
    (``layer_idx`` its layer: ``gather_cache_layer``'s), whose K/V rows
    and routing counts the block writes in place. Returns (x, the
    prefill's new subtree, else None)."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    a, new_kv = attn_mod.attention(
        bp["attn"], h, cfg, kind=kind, mode=mode,
        cache=None if cache is None else cache["kv"], pos=pos,
        use_rope=True, layer_idx=layer_idx)
    x = x + a
    routing = None
    if "ln2" in bp:
        h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
        if cfg.is_moe:
            rsub = None if cache is None else cache.get("routing")
            if rsub is None:
                x = x + moe_mod.moe_ffn(bp["moe"], h, cfg, valid_len=n_valid)
            else:
                counts = rsub if layer_idx is None else rsub[layer_idx]
                y, routing = moe_mod.moe_ffn(bp["moe"], h, cfg,
                                             route_counts=counts,
                                             valid_len=n_valid)
                x = x + y
                if layer_idx is not None:
                    counts.copy_(routing)
        else:
            x = x + mlp(bp["mlp"], h, cfg.act)
    if mode != "prefill":
        return x, None
    new = {"kv": new_kv}
    if routing is not None:
        new["routing"] = routing
    return x, new


def _state_block(bp: dict, x, cfg: ArchConfig, btype: str, *, mode: str,
                 cache: Optional[dict]):
    """One recurrent block with its residual. ``cache``: this block's
    subtree of one segment (``{"mstate": ...}``, ``{"sstate": ...}``,
    ``{"ssm": ...}``) or None. Returns (x, new subtree or None)."""
    kind, _, fn, _ = _BLOCKS[btype]
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    sub = None if cache is None else cache.get(kind)
    y, new = fn(bp[btype], h, cfg, mode=mode, cache=sub)
    return x + y, (None if new is None else {kind: new})


def _block_cache(cfg: ArchConfig, btype: str, batch: int, max_len: int,
                 dtype, device) -> dict:
    if btype in _KV_BLOCKS:
        c = {"kv": attn_mod.init_kv_cache(cfg, batch, max_len, dtype,
                                          device)}
        if cfg.is_moe and cfg.d_ff:
            c["routing"] = torch.zeros((batch, cfg.n_experts),
                                       dtype=torch.int32, device=device)
        return c
    # "q8_0"/"q4_0" quantize KV planes only; recurrent states stay bf16
    if isinstance(dtype, str):
        dtype = torch.bfloat16
    kind, _, _, init = _BLOCKS[btype]
    return {kind: init(cfg, batch, dtype, device)}


# ----------------------------------------------------------------------------
# Whole-model init / apply
# ----------------------------------------------------------------------------

def init_decoder(gen: torch.Generator, cfg: ArchConfig, device,
                 dtype=torch.float32) -> dict:
    """Parameters with the reference's tree, shapes and distributions
    (``models/transformer.py:191-226``): ``embed``, ``segments`` stacked
    on a leading (n_segments, ...) axis, ``final_norm``, for the hybrid
    ``tail`` (stacked the same way) and ``shared`` (the one attention
    block) and, for an untied head, ``lm_head`` (d, padded vocab).
    ``dtype``: the storage type of the attention, MLP, MoE, mamba
    projection, embedding and head weights (each drawn in f32 and cast
    at once); norms, biases, the mamba's ``wdt``, decay and conv leaves
    and the xLSTM blocks stay f32."""
    pattern = segment_pattern(cfg)
    segs = [{f"block{j}": _init_block(gen, cfg, bt, device, dtype)
             for j, (bt, _) in enumerate(pattern)}
            for _ in range(n_segments(cfg))]
    params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, device, dtype),
        "segments": stack_layers(segs),
        "final_norm": init_rmsnorm(cfg.d_model, device),
    }
    del segs   # the unstacked draws: one copy of the weights at a time
    tail = tail_pattern(cfg)
    if tail:
        params["tail"] = stack_layers(
            [{"block0": _init_block(gen, cfg, bt, device, dtype)}
             for bt, _ in tail])
    if any(bt == "shared_attn" for bt, _ in pattern):
        params["shared"] = _init_block(gen, cfg, "attn", device, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = ninit(gen, (cfg.d_model, pad_vocab(cfg.vocab)),
                                  cfg.d_model, device, dtype,
                                  axes=("param_embed", "vocab"))
    return params


def _prepare_block(bp: dict, btype: str) -> dict:
    if btype == "shared_attn":
        return bp
    if btype == "mamba":
        return {**bp, "mamba": ssm_mod.prepare_mamba(bp["mamba"])}
    if btype == "mlstm":
        return {**bp, "mlstm": xlstm_mod.prepare_mlstm(bp["mlstm"])}
    if btype == "slstm":
        return {**bp, "slstm": xlstm_mod.prepare_slstm(bp["slstm"])}
    bp = bf16_proj(bp)
    sa = bp["attn"]
    if all(isinstance(sa[k], torch.Tensor) for k in ("wq", "wk", "wv")):
        sa["wqkv"] = torch.cat([sa["wq"], sa["wk"], sa["wv"]], dim=-2)
    if "moe" in bp:
        bp["moe"] = moe_mod.prepare_moe(bp["moe"])
    return bp


def prepare_serving(params: dict, cfg: ArchConfig) -> dict:
    """The serving tree of ``params``: each block's weights with what its
    forward derives from them made once (attention and MLP projections
    in bf16 with the fused ``wqkv``, the MoE router in f32 and its experts
    in bf16; ``ssm.prepare_mamba``, ``xlstm.prepare_mlstm`` /
    ``prepare_slstm``), the hybrid's shared block prepared once, and a
    tied head's f32 operand."""
    segs = dict(params["segments"])
    for j, (bt, _) in enumerate(segment_pattern(cfg)):
        segs[f"block{j}"] = _prepare_block(segs[f"block{j}"], bt)
    out = {**params, "segments": segs}
    if "tail" in params:
        out["tail"] = {"block0": _prepare_block(params["tail"]["block0"],
                                                "mamba")}
    if "shared" in params:
        out["shared"] = _prepare_block(params["shared"], "attn")
    if "lm_head" not in params:
        out["embed"] = prepare_head(params["embed"])
    return out


def _write_state(pool, new, i: int) -> None:
    """Write a block's new state into layer ``i`` of the stacked pool
    (``gather_cache_layer``'s pool: the stacked cache, or a meshed decode
    step's one-layer pool)."""
    for key, sub in new.items():
        if isinstance(sub, dict):
            _write_state(pool[key], sub, i)
        else:
            pool[key][i].copy_(sub)


def _run_stack(stack: dict, cache: Optional[dict], x, cfg: ArchConfig,
               pattern: list, n: int, *, mode: str, pos,
               shared: Optional[dict], n_valid):
    """Run the ``n`` stacked layers of ``stack`` (the segments, or the
    hybrid's tail) over x, with their ``cache`` subtree (the
    prefill's fresh one, or the decode's pool, which each block writes in
    place). Returns (x, the prefill's new stacked subtree, else None).
    A train forward under ``remat_on`` recomputes each layer's
    activations in the backward. Each layer's parameters are gathered
    at the start of ``layer`` (``gather_layer``), a decode block's cache
    fetched at its start and written back after it
    (``gather_cache_layer``, ``write_cache_layer``: the pool itself at
    layer i, or under a meshed decode step this rank's rows of the
    layer, gathered, but over ``model`` where the block's attention is
    split, or for a split mamba block's state ``h`` and an xLSTM block's
    state split over its heads), and a prefill's new
    cache is kept a layer at a time
    (``keep_layer``)."""
    decode = mode == "decode"

    def layer(x, sp, i):
        sp = gather_layer(sp)
        sc = None
        if cache is not None and not decode:
            sc = layer_slice(cache, i)
        new = {}
        for j, (bt, kind) in enumerate(pattern):
            name = f"block{j}"
            bp = shared if bt == "shared_attn" else sp[name]
            # a split attention reads and writes its model shard of the
            # cache (the K/V heads or head_dim this rank holds), a split
            # mamba block its state's heads (its conv tail whole), an
            # xLSTM block split over its heads its state's heads
            if bt in _KV_BLOCKS:
                keep = attention_form(bp["attn"]) is not None
            elif bt == "mamba":
                keep = ssm_mod.is_split(bp["mamba"]) and ssm_mod.SPLIT_STATE
            else:
                keep = xlstm_mod.keeps_state(bp[bt])
            at = None
            if decode:
                bc, at = gather_cache_layer(cache[name], i, keep)
            else:
                bc = None if sc is None else sc[name]
            if bt in _KV_BLOCKS:
                x, nc = _attn_block(bp, x, cfg, kind, mode=mode,
                                    cache=bc, pos=pos, layer_idx=at,
                                    n_valid=n_valid)
            else:
                x, nc = _state_block(sp[name], x, cfg, bt, mode=mode,
                                     cache=bc if at is None
                                     else layer_slice(bc, at))
                if decode:
                    _write_state(bc, nc, at)
            if decode:
                write_cache_layer(cache[name], i, bc,
                                  pos if bt in _KV_BLOCKS else None,
                                  x.shape[1], keep)
            del bc   # a meshed decode's gathered layer: freed before the next
            new[name] = nc
        return constrain(x, "batch", "q_seq", "embed"), new

    ckpt = remat_on(cfg, mode)
    new_layers = []
    for i in range(n):
        sp = layer_slice(stack, i)
        if ckpt:
            x = remat(lambda x, sp, i=i: layer(x, sp, i)[0], x, sp)
            continue
        x, new = layer(x, sp, i)
        if mode == "prefill":
            new_layers.append(keep_layer(new))
    return x, stack_layers(new_layers) if mode == "prefill" else None


def decoder_forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
                    mode: str = "train", cache=None, pos=None,
                    prefix_embed: Optional[torch.Tensor] = None,
                    n_valid=None, last_only: bool = False):
    """tokens: (B, S) (S = 1 for decode, or the verify's Q). Returns
    (logits (B, S, padded vocab) f32, cache): None for train, a fresh
    stacked cache for prefill (``cache`` names its length and dtype),
    and for decode the pool ``cache`` itself, written in place.
    ``prefix_embed`` (B, P, d): embeddings put before the tokens (the VLM
    patch stub; the logits cover them too). ``n_valid`` (serving
    prefill): the live prompt length of a padded bucket, whose padding
    the MoE capacity cut must not count. ``last_only``: the head on the
    last position alone, logits (B, 1, padded vocab)."""
    x = embed(params["embed"], tokens)
    if prefix_embed is not None:
        x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
        if n_valid is not None:
            n_valid = n_valid + prefix_embed.shape[1]
    x = constrain(x, "batch", "q_seq", "embed")
    kw = dict(mode=mode, pos=pos, n_valid=n_valid)
    x, segs = _run_stack(params["segments"],
                         None if cache is None else cache["segments"], x,
                         cfg, segment_pattern(cfg), n_segments(cfg),
                         shared=params.get("shared"), **kw)
    new_cache = None
    if mode == "decode":
        new_cache = cache
    elif mode == "prefill":
        new_cache = {"segments": segs}
    tail = tail_pattern(cfg)
    if tail:
        x, new_tail = _run_stack(params["tail"],
                                 None if cache is None else cache["tail"],
                                 x, cfg, tail[:1], len(tail), shared=None,
                                 **kw)
        if mode == "prefill":
            new_cache["tail"] = new_tail
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_head(params["embed"], x, cfg.vocab,
                         softcap=cfg.final_softcap,
                         head=params.get("lm_head"))
    return logits, new_cache


def init_decoder_cache(cfg: ArchConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, device=None) -> dict:
    """The stacked per-segment cache, ``{"segments": {blockJ: {kind:
    (n_segments, batch, ...)}}}`` and for the hybrid ``"tail"``, stacked
    the same way: an attention block's ``kv`` planes (each occurrence of
    the shared block its own; ``attention.init_kv_cache``: a dtype or a
    q8_0 / q4_0 tier, O(max_len) a lane) and, for MoE, its ``routing``
    counters; a recurrent block's state, O(1) in ``max_len`` and in bf16
    under a quantized tier."""
    def stacked(pattern, n):
        return stack_layers([{f"block{j}": _block_cache(
            cfg, bt, batch, max_len, dtype, device)
            for j, (bt, _) in enumerate(pattern)} for _ in range(n)])

    cache = {"segments": stacked(segment_pattern(cfg), n_segments(cfg))}
    tail = tail_pattern(cfg)
    if tail:
        cache["tail"] = stacked(tail[:1], len(tail))
    return cache
