"""Model API of the port (the JAX package's ``models/model.py``, for the
encoder-decoder Whisper models and the decoder-only families: dense and
MoE attention, xLSTM and the zamba2 hybrid) and the per-lane serving
state spec."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.platforms import resolve_device
from repro_torch.quantize import quantize_tree


@dataclasses.dataclass(frozen=True)
class LaneStateSpec:
    """What one serving lane of a model carries between decode steps.

    The serving engine asks the model for this spec and drives
    admission, the decode tick, quantized cache storage, abort/free and
    the accounting off it. State kinds: ``self_kv`` (causal K/V,
    O(max_len) per lane), ``cross_kv`` (encoder K/V, O(enc_len) per
    lane), ``recurrent`` (constant-size per-lane state: ``"ssm"``,
    ``"mstate"``, ``"sstate"``) and ``moe_experts > 0`` (per-lane
    expert-routing counters). ``prefill_exact``: recurrent scans fold
    every input position into the state, so such lanes prefill at the
    exact prompt length. ``quant_tiers``: the quantized cache tiers the
    family can serve under."""
    family: str
    self_kv: bool
    cross_kv: bool
    recurrent: tuple = ()
    recurrent_dtype: str = "bfloat16"
    moe_experts: int = 0
    moe_top_k: int = 0
    prefill_exact: bool = False
    quant_tiers: tuple = ()

    def supports_tier(self, cache_dtype: str) -> bool:
        if cache_dtype in ("q8_0", "q4_0"):
            return cache_dtype in self.quant_tiers
        return True

    @property
    def state_kinds(self) -> tuple:
        """Every state kind a lane holds, in engine order."""
        out = []
        if self.self_kv:
            out.append("self_kv")
        if self.cross_kv:
            out.append("cross_kv")
        out.extend(self.recurrent)
        if self.moe_experts:
            out.append("routing")
        return tuple(out)


_RECURRENT_KIND = {"mlstm": "mstate", "slstm": "sstate", "mamba": "ssm"}

#: the key sets of a KV-plane dict in a cache tree (bf16, q8_0, q4_0)
_KV_PLANE_KEYS = ({"k", "v"}, {"kq", "ks", "vq", "vs"},
                 {"kp", "ks", "vp", "vs"})


def cache_bytes(tree) -> tuple[int, int]:
    """(KV-plane bytes, recurrent-state bytes) of a cache tree."""
    if isinstance(tree, dict):
        if set(tree) in _KV_PLANE_KEYS:
            return sum(_nbytes(v) for v in tree.values()), 0
        kv = st = 0
        for sub in tree.values():
            a, b = cache_bytes(sub)
            kv, st = kv + a, st + b
        return kv, st
    return 0, _nbytes(tree)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init_values(self, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> dict:
        """Fresh parameters drawn from ``generator`` (the reference's
        shapes and distributions), placed on ``device`` (default
        ``cuda``). ``dtype`` (decoder-only models): the storage type of
        the projection, expert, embedding and head weights, each drawn in
        f32 and cast at once, so a CUDA generator and bf16 keep the f32
        peak at one leaf."""
        device = resolve_device(device)
        if self.cfg.enc_dec:
            return encdec_mod.init_encdec(generator, self.cfg, device)
        return tf_mod.init_decoder(generator, self.cfg, device, dtype)

    def quantize(self, values, tier: str = "q8_0"):
        """``values`` with its weights quantized to ``tier`` (``q8_0``, or
        ``q4_0`` for the speculative draft), as ``quantize_tree`` does;
        a decoder-only tree only where ``transformer.quantizable``
        says. A tree with mamba blocks is refused: the reference's
        ``mamba_block`` casts its weights with ``.astype``, which a
        quantized weight does not have, so it serves them float only."""
        if any(bt == "mamba" for bt in self._blocks()):
            raise ValueError(
                f"{self.cfg.name}: mamba blocks take float weights only "
                f"(the reference's mamba_block cannot take Q8_0 or Q4_0 "
                f"weights); serve it unquantized")
        if self.cfg.enc_dec:
            return quantize_tree(values, tier=tier)
        return quantize_tree(values, predicate=tf_mod.quantizable,
                             tier=tier)

    def forward(self, values, batch: dict, *, mode: str = "train",
                cache=None, pos=None, pages=None):
        """Returns (logits, new_cache). ``batch``: ``tokens``; for the
        enc-dec model also ``enc_frames`` or ``enc_states``
        (train/prefill; states skip the encoder) or ``enc_lens`` (decode:
        per-lane valid encoder lengths); for a decoder-only model
        optionally ``img_embed`` (train/prefill: the VLM's patch
        embeddings, put before the tokens) and ``n_valid`` (prefill: the
        live prompt length of a padded bucket, which MoE capacity
        routing must not fill with padding). A decoder-only decode writes
        the new K/V rows, routing counts and recurrent state into
        ``cache`` in place and returns it. ``pages`` (enc-dec decode):
        the per-lane page tables when ``cache`` is a paged pool
        (``init_paged_cache``)."""
        cfg = self.cfg
        if not cfg.enc_dec:
            prefix = batch.get("img_embed") if mode != "decode" else None
            return tf_mod.decoder_forward(values, cfg, batch["tokens"],
                                          mode=mode, cache=cache, pos=pos,
                                          prefix_embed=prefix,
                                          n_valid=batch.get("n_valid"))
        if mode == "decode":
            return encdec_mod.decode_tokens(
                values, cfg, batch["tokens"], mode="decode", cache=cache,
                pos=pos, enc_lens=batch.get("enc_lens"), pages=pages)
        enc_out = batch.get("enc_states")
        if enc_out is None:
            enc_out = encdec_mod.encode(values, cfg, batch["enc_frames"],
                                        mode=mode)
        return encdec_mod.decode_tokens(values, cfg, batch["tokens"],
                                        enc_out, mode=mode, cache=cache)

    def prepare_serving(self, values):
        """The serving tree of ``values``: the tensors a forward derives
        from the weights, and would remake at every call, made once and
        added (the decoder's float projections of the enc-dec model are
        stored in bf16, the dtype every product casts them to). A
        forward on it equals one on ``values`` bit for bit; the weights
        must not change while it is in use."""
        if self.cfg.enc_dec:
            return encdec_mod.prepare_serving(values)
        return tf_mod.prepare_serving(values, self.cfg)

    def encode(self, values, frames: torch.Tensor) -> torch.Tensor:
        """Encoder-only pass: (B, S, d_model) frames -> states."""
        if not self.cfg.enc_dec:
            raise ValueError(f"{self.cfg.name} is not encoder-decoder")
        return encdec_mod.encode(values, self.cfg, frames)

    def init_cache(self, batch: int, max_len: int, enc_len: int = 1500,
                   dtype=torch.bfloat16, device: Optional[Any] = None):
        """Stacked cache planes: self/cross KV (enc-dec) or per-segment
        K/V, routing counters and recurrent state (decoder-only,
        ``enc_len`` unused). ``dtype`` a tensor dtype, ``"q8_0"`` or
        ``"q4_0"`` (KV planes only; recurrent state stays bf16)."""
        if not self.cfg.enc_dec:
            return tf_mod.init_decoder_cache(self.cfg, batch, max_len,
                                             dtype, device)
        return encdec_mod.init_encdec_cache(self.cfg, batch, max_len,
                                            enc_len, dtype, device)

    def init_paged_cache(self, n_pages: int, n_cross_pages: int,
                         page_size: int, dtype=torch.bfloat16,
                         device: Optional[Any] = None):
        """Paged-pool cache (enc-dec only): shared (n_pages, P) self and
        (n_cross_pages, P) cross planes read through per-lane page tables
        (``repro_torch.paging``). The same ``dtype`` contract as
        ``init_cache``."""
        if not self.cfg.enc_dec:
            raise ValueError(
                f"{self.cfg.name}: paged KV cache requires an enc-dec "
                f"model (the serving engine's paged mode)")
        return encdec_mod.init_paged_encdec_cache(
            self.cfg, n_pages, n_cross_pages, page_size, dtype, device)

    def state_spec(self) -> LaneStateSpec:
        """The per-lane serving state of this model."""
        cfg = self.cfg
        if cfg.enc_dec:
            return LaneStateSpec(
                family=cfg.family, self_kv=True, cross_kv=True,
                quant_tiers=("q8_0", "q4_0") if cfg.head_dim % 32 == 0
                else ())
        # decoder-only: attention blocks (the hybrid's shared one too)
        # carry causal K/V (and MoE its routing counters); mamba, mLSTM
        # and sLSTM blocks recurrent state, with no KV plane to quantize.
        # The quantized tiers need plain softmax decode attention, as the
        # reference's do
        blocks = self._blocks()
        recurrent = tuple(dict.fromkeys(_RECURRENT_KIND[bt] for bt in blocks
                                        if bt in _RECURRENT_KIND))
        self_kv = any(bt in ("attn", "shared_attn") for bt in blocks)
        quant = (self_kv and cfg.head_dim % 32 == 0
                 and cfg.attn_softcap is None and cfg.sliding_window is None
                 and not cfg.local_global)
        return LaneStateSpec(
            family=cfg.family, self_kv=self_kv, cross_kv=False,
            recurrent=recurrent,
            moe_experts=cfg.n_experts if cfg.is_moe else 0,
            moe_top_k=cfg.top_k if cfg.is_moe else 0,
            prefill_exact=bool(recurrent),
            quant_tiers=("q8_0", "q4_0") if quant else ())

    def _blocks(self) -> list:
        """The block types of a decoder-only model's segment and tail
        patterns (none for the enc-dec model)."""
        if self.cfg.enc_dec:
            return []
        return [bt for bt, _ in tf_mod.segment_pattern(self.cfg)
                + tf_mod.tail_pattern(self.cfg)]

    def lane_state_bytes(self, max_len: int, enc_len: int = 1500,
                         dtype=torch.bfloat16) -> dict:
        """Per-lane state footprint by kind, in bytes: ``{"kv": ...,
        "state": ..., "total": ...}``. ``kv`` grows with ``max_len`` (and
        ``enc_len`` for cross K/V); ``state`` is the constant-size
        recurrent and routing-counter footprint. Counted on the ``meta`` device: nothing is
        allocated."""
        cache = self.init_cache(1, max_len, enc_len, dtype, device="meta")
        kv, st = cache_bytes(cache)
        return {"kv": kv, "state": st, "total": kv + st}


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)
