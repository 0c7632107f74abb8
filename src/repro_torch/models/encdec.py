"""Whisper-style encoder-decoder of the port (the JAX package's
``models/encdec.py``).

The model consumes frame embeddings (B, S_enc, d_model) from the log-mel
frontend; a learnable square projection stands in for Whisper's conv
stem. Encoder: sinusoidal positions + bidirectional attention + GELU MLP
(``encode_chunked`` for the block-diagonal streaming variant;
``cross_attn_kv`` projects new states for a streamed slot). Decoder:
learned positions, causal self-attention, cross-attention, GELU MLP and
the tied embedding head. The reference's ``lax.scan`` over the stacked
layer axis is a Python loop over it here.

Under a meshed serving step whose heads do not divide ``model`` (the
reference's ``serve_row_tp``), the frontend's projection is
row-parallel on d_model and the decoder positions come as this rank's
columns, all-gathered; the attention and MLP take their forms
(``layers.unit_form``) and the encoder runs every frame on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (attention_form, bf16_proj, draw,
                                       embed, filled,
                                       gather_cache_layer, gather_layer,
                                       init_embedding,
                                       keep_layer, layer_slice,
                                       layernorm, logits_head, mlp, mm,
                                       model_axis, model_chunk, model_dim,
                                       ninit, prepare_head,
                                       remat, remat_on, row_parallel_mm,
                                       sinusoidal_positions, stack_layers,
                                       take_rows, write_cache_layer)
from repro_torch.parallel.sharding import constrain
from repro_torch.quantize import QTENSORS, as_array

MAX_DEC_POS = 32768  # learned decoder positions (the reference's table)


def _init_layernorm(d: int, device) -> dict:
    return {"scale": filled((d,), 1.0, device, ("embed",)),
            "bias": filled((d,), 0.0, device, ("embed",))}


def _init_mlp(gen, d: int, ff: int, device) -> dict:
    return {"up": ninit(gen, (d, ff), d, device, axes=("param_embed", "ff")),
            "down": ninit(gen, (ff, d), ff, device,
                          axes=("ff", "param_embed"))}


def _init_enc_layer(gen, cfg: ArchConfig, device) -> dict:
    return {
        "ln1": _init_layernorm(cfg.d_model, device),
        "attn": attn_mod.init_attention(gen, cfg, device),
        "ln2": _init_layernorm(cfg.d_model, device),
        "mlp": _init_mlp(gen, cfg.d_model, cfg.d_ff, device),
    }


def _init_dec_layer(gen, cfg: ArchConfig, device) -> dict:
    return {
        "ln1": _init_layernorm(cfg.d_model, device),
        "self_attn": attn_mod.init_attention(gen, cfg, device),
        "ln_x": _init_layernorm(cfg.d_model, device),
        "cross_attn": attn_mod.init_attention(gen, cfg, device),
        "ln2": _init_layernorm(cfg.d_model, device),
        "mlp": _init_mlp(gen, cfg.d_model, cfg.d_ff, device),
    }


def init_encdec(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Parameters with the reference's shapes and distributions
    (``models/encdec.py:58-75``): scaled normals, N(0, 0.02^2) decoder
    positions, unit/zero LayerNorms, layers stacked on a leading axis."""
    d = cfg.d_model
    return {
        "frontend": ninit(gen, (d, d), d, device,
                          axes=("param_embed", "embed")),
        "embed": init_embedding(gen, cfg.vocab, d, device),
        "dec_pos": draw(gen, (MAX_DEC_POS, d), 0.02, device, torch.float32,
                        (None, "param_embed")),
        "enc_layers": stack_layers([_init_enc_layer(gen, cfg, device)
                                    for _ in range(cfg.enc_layers)]),
        "enc_ln": _init_layernorm(d, device),
        "dec_layers": stack_layers([_init_dec_layer(gen, cfg, device)
                                    for _ in range(cfg.n_layers)]),
        "dec_ln": _init_layernorm(d, device),
    }


def prepare_serving(params: dict) -> dict:
    """The serving tree of ``params``: what a decode step would derive
    from the decoder's weights at every call, made once. The decoder's
    float projection weights in bf16 (every product casts them so), the
    self-attention's Q, K and V weights concatenated (``wqkv``, the
    product ``attention`` makes one), and the tied head's f32 operand
    (``head_f32``). The encoder's weights are as given."""
    layers = bf16_proj(params["dec_layers"])
    sa = layers["self_attn"]
    if all(isinstance(sa[k], torch.Tensor) for k in ("wq", "wk", "wv")):
        sa["wqkv"] = torch.cat([sa["wq"], sa["wk"], sa["wv"]], dim=-2)
    return {**params, "dec_layers": layers,
            "embed": prepare_head(params["embed"])}


def _n_stacked(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return (tree.q if isinstance(tree, QTENSORS) else tree).shape[0]


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor,
           mode: str = "prefill") -> torch.Tensor:
    """frames: (B, S_enc, d_model) frame embeddings -> encoder states.
    ``mode="train"``: a training forward, whose layers ``remat_on``
    may recompute in the backward."""
    b, s, d = frames.shape
    front = params["frontend"]
    if model_dim(front) == 0:    # serve_row_tp: its rows, d_model
        x = row_parallel_mm(model_chunk(frames.to(torch.bfloat16)), front)
    else:
        x = frames.to(torch.bfloat16) @ as_array(front)
    x = x + sinusoidal_positions(s, d, x.device).to(x.dtype)[None]
    x = constrain(x, "batch", "q_seq", "embed")
    layers = params["enc_layers"]

    def layer(x, lp):
        lp = gather_layer(lp)
        h = layernorm(lp["ln1"], x)
        a, _ = attn_mod.attention(lp["attn"], h, cfg, kind="bidir",
                                  mode="train")
        x = x + a
        h = layernorm(lp["ln2"], x)
        return constrain(x + mlp(lp["mlp"], h, cfg.act), "batch", "q_seq",
                         "embed")

    ckpt = remat_on(cfg, mode)
    for i in range(_n_stacked(layers)):
        lp = layer_slice(layers, i)
        x = remat(layer, x, lp) if ckpt else layer(x, lp)
    return layernorm(params["enc_ln"], x)


def encode_chunked(params: dict, cfg: ArchConfig, frames: torch.Tensor,
                   chunk: int) -> torch.Tensor:
    """Block-diagonal encode: fixed-size chunks encoded independently
    (attention within a chunk only), states concatenated."""
    s = frames.shape[1]
    outs = [encode(params, cfg, frames[:, i:i + chunk])
            for i in range(0, s, chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def cross_attn_kv(params: dict, cfg: ArchConfig, states: torch.Tensor):
    """Each decoder layer's cross-attention K/V of new encoder states.

    states: (B, S_new, d_model) -> (k, v), each (L, B, S_new, Hkv, Dh) in
    the compute dtype: the products the prefill's ``attention`` makes for
    ``x_kv`` (``mm`` of the states with ``wk`` and ``wv`` of ``params``,
    the serving tree's bf16 or Q8_0/Q4_0 weights), so the engine can
    extend a slot's cached encoder K/V as audio chunks arrive instead of
    prefilling again, with the biases and k-norm ``attention`` adds after
    the products where a config has them."""
    layers = params["dec_layers"]["cross_attn"]
    ks, vs = [], []
    for i in range(_n_stacked(layers)):
        lp = gather_layer(layer_slice(layers, i))
        ks.append(attn_mod.bias_norm(lp, mm(states, lp["wk"]), cfg, "k"))
        vs.append(attn_mod.bias_norm(lp, mm(states, lp["wv"]), cfg, "v"))
    return torch.stack(ks), torch.stack(vs)


def _positions(table, idx: torch.Tensor, dtype=torch.float32):
    """Rows ``idx`` of the learned decoder positions (``take_rows``);
    a table split over ``model`` along d_model (``serve_row_tp``) gives
    this rank's columns of them, all-gathered over ``model``."""
    rows = take_rows(table, idx, dtype)
    if model_dim(table) is None:
        return rows
    return model_axis().all_gather(rows, dim=-1)


def decode_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  enc_out: Optional[torch.Tensor] = None, *,
                  mode: str = "train", cache=None, pos=None, enc_lens=None,
                  pages=None, last_only: bool = False):
    """Decoder pass. train/prefill: tokens (B, S) with ``enc_out`` given;
    prefill returns the per-layer self and cross K/V stacked as
    ``{"layers": {"self": {k, v}, "cross": {k, v}}}`` (padded to
    ``cache``'s lengths). decode: tokens (B, Q) at per-lane positions
    ``pos`` (B,) + j, against the stacked pool ``cache``, updated in
    place at every one of the Q positions (Q > 1 is the speculative
    verify); ``enc_lens`` (B,) masks each lane's cross-attention.
    ``pages`` (decode): ``{"self": (B, n_lp), "cross": (B, n_lp_c)}``
    page tables, when ``cache`` is a paged pool (``repro_torch.paging``)
    that each attention writes and reads through its lane's row.
    ``last_only``: the head on the last position alone."""
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    if mode == "decode":
        posv = torch.as_tensor(pos, device=x.device).reshape(-1).expand(b)
        idx = posv[:, None] + torch.arange(s, device=x.device)[None, :]
        x = x + _positions(params["dec_pos"], idx).to(x.dtype)
    else:
        x = x + _positions(params["dec_pos"],
                           torch.arange(s, device=x.device), x.dtype)[None]
    x = constrain(x, "batch", "q_seq", "embed")

    layers = params["dec_layers"]
    n_layers = _n_stacked(layers)

    def layer(x, lp, i):
        lp = gather_layer(lp)
        h = layernorm(lp["ln1"], x)
        if mode == "decode":
            # the stacked pools at layer i, or under a meshed decode step
            # this rank's rows of the layer, gathered but over ``model``
            # where the attention is split (layers.py)
            keep = attention_form(lp["self_attn"]) is not None
            pool, at = gather_cache_layer(cache["layers"]["self"], i, keep)
            a = attn_mod.attention(
                lp["self_attn"], h, cfg, kind="global", mode=mode,
                cache=pool, pos=posv, layer_idx=at,
                page_table=None if pages is None else pages["self"])[0]
            write_cache_layer(cache["layers"]["self"], i, pool, posv, s,
                              keep)
            del pool   # a meshed decode's gathered layer: freed first
            x = x + a
            h = layernorm(lp["ln_x"], x)
            keep = attention_form(lp["cross_attn"]) is not None
            pool, at = gather_cache_layer(cache["layers"]["cross"], i, keep)
            c = attn_mod.attention(
                lp["cross_attn"], h, cfg, kind="bidir", mode=mode,
                cache=pool, pos=posv, x_kv=h,
                layer_idx=at, kv_lens=enc_lens,
                page_table=None if pages is None else pages["cross"])[0]
            self_c = cross_c = None
        else:
            lc = None if cache is None else layer_slice(cache["layers"], i)
            a, self_c = attn_mod.attention(
                lp["self_attn"], h, cfg, kind="global", mode=mode,
                cache=None if lc is None else lc["self"])
            x = x + a
            h = layernorm(lp["ln_x"], x)
            c, cross_c = attn_mod.attention(
                lp["cross_attn"], h, cfg, kind="bidir", mode=mode,
                cache=None if lc is None else lc["cross"], x_kv=enc_out)
        x = x + c
        h = layernorm(lp["ln2"], x)
        x = constrain(x + mlp(lp["mlp"], h, cfg.act), "batch", "q_seq",
                      "embed")
        return x, {"self": self_c, "cross": cross_c}

    ckpt = remat_on(cfg, mode)
    per_layer = []
    for i in range(n_layers):
        lp = layer_slice(layers, i)
        if ckpt:
            x = remat(lambda x, lp, i=i: layer(x, lp, i)[0], x, lp)
        else:
            x, new = layer(x, lp, i)
            if mode == "prefill":
                per_layer.append(keep_layer(new))

    if last_only:
        x = x[:, -1:]
    x = layernorm(params["dec_ln"], x)
    logits = logits_head(params["embed"], x, cfg.vocab,
                         softcap=cfg.final_softcap)
    if mode == "decode":
        return logits, cache
    if mode == "train":
        return logits, None
    return logits, {"layers": stack_layers(per_layer)}


def init_encdec_cache(cfg: ArchConfig, batch: int, max_len: int,
                      enc_len: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """The stacked (L, batch, ., Hkv, .) self and cross planes."""
    def stacked(length):
        one = attn_mod.init_kv_cache(cfg, batch, length, dtype, device)
        return {k: v.unsqueeze(0).repeat(cfg.n_layers, *([1] * v.dim()))
                for k, v in one.items()}
    return {"layers": {"self": stacked(max_len), "cross": stacked(enc_len)}}


def init_paged_encdec_cache(cfg: ArchConfig, n_pages: int,
                            n_cross_pages: int, page_size: int,
                            dtype=torch.bfloat16, device=None) -> dict:
    """The paged pool of ``init_encdec_cache``: the per-lane (batch, seq)
    axes become shared (n_pages, P) self and (n_cross_pages, P) cross
    pools, read through per-lane page tables (``repro_torch.paging``),
    stacked (L, n_pages, P, Hkv, .)."""
    def stacked(n):
        one = attn_mod.init_paged_kv_cache(cfg, n, page_size, dtype, device)
        return {k: v.unsqueeze(0).repeat(cfg.n_layers, *([1] * v.dim()))
                for k, v in one.items()}
    return {"layers": {"self": stacked(n_pages),
                       "cross": stacked(n_cross_pages)}}
