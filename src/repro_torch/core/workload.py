"""GEMM/dot-product workload extraction (paper Secs III-A, V-C): the
port's copy of the JAX package's ``core/workload.py``.

The paper's unit of offload is the ggml ``mul_mat`` dot-product kernel:
``C[m, n] = sum_k A[n, k] * B[m, k]`` — every output element is one
K-length dot product. The functions here enumerate those kernels for a
whole model run (Whisper: one encoder pass + T decoder steps;
decoder-only LMs: prefill and/or decode), so that the coverage, offload
and energy analyses reason about the real kernel-size *distribution*, as
Sec III-B does for burst-length selection and Secs III-C/V-C do for LMM
sizing. ``KernelSpec`` is also what each dispatched kernel call builds
for the ACCEL/HOST law (``kernels/registry.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

__all__ = [
    "KernelSpec", "WhisperDims", "WHISPER_TINY", "WHISPER_BASE",
    "WHISPER_SMALL", "whisper_workload", "lm_workload", "total_flops",
    "total_dot_products", "total_calls", "k_length_histogram",
    "iter_unique_gemms",
]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One mul_mat call site: A is (n, k) [weights or cached tensor],
    B is (m, k) [activations]; invoked ``count`` times per run."""

    name: str
    m: int            # rows of B (tokens/queries in this call)
    n: int            # rows of A (output features / kv positions)
    k: int            # dot-product length
    dtype: str        # storage dtype of A: 'f16' | 'q8_0' | 'q4_0' | 'f32'
    count: int = 1    # invocations per run
    tag: str = "proj"  # proj | attn_qk | attn_av | mlp | logits | conv |
    #                    ssm | frontend (audio log-mel/projection GEMMs)

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k * self.count

    @property
    def dot_products(self) -> int:
        """Number of K-length dot products (output elements) per run."""
        return self.m * self.n * self.count

    @property
    def calls(self) -> int:
        """Per-B-row kernel invocations (the offload granularity)."""
        return self.m * self.count


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    name: str
    d_model: int
    n_heads: int
    enc_layers: int
    dec_layers: int
    d_ff: int
    vocab: int
    enc_frames: int = 1500   # 30s window after conv stride-2
    n_mels: int = 80


WHISPER_TINY = WhisperDims("tiny", 384, 6, 4, 4, 1536, 51865)
WHISPER_BASE = WhisperDims("base", 512, 8, 6, 6, 2048, 51865)
WHISPER_SMALL = WhisperDims("small", 768, 12, 12, 12, 3072, 51865)


def whisper_workload(dims: WhisperDims, dec_steps: int = 28,
                     dtype: str = "f16") -> list[KernelSpec]:
    """Kernel inventory for one transcription (jfk.wav ≈ 10 s → ~28 tokens).

    Weight-bearing GEMMs use ``dtype`` storage; attention score/value
    kernels read the fp16 KV cache in both model variants (as whisper.cpp
    does — Q8_0 quantizes weights only).
    """
    d, h, ff, v = dims.d_model, dims.n_heads, dims.d_ff, dims.vocab
    dh = d // h
    S = dims.enc_frames
    out: list[KernelSpec] = []
    add = out.append

    # --- encoder (one pass over S frames) ---
    L = dims.enc_layers
    add(KernelSpec("enc.conv1", S, d, dims.n_mels * 3, dtype, 1, "conv"))
    add(KernelSpec("enc.conv2", S, d, d * 3, dtype, 1, "conv"))
    add(KernelSpec("enc.attn.qkv", S, 3 * d, d, dtype, L, "proj"))
    add(KernelSpec("enc.attn.out", S, d, d, dtype, L, "proj"))
    add(KernelSpec("enc.attn.qk", S, S, dh, "f16", L * h, "attn_qk"))
    add(KernelSpec("enc.attn.av", S, dh, S, "f16", L * h, "attn_av"))
    add(KernelSpec("enc.mlp.up", S, ff, d, dtype, L, "mlp"))
    add(KernelSpec("enc.mlp.down", S, d, ff, dtype, L, "mlp"))

    # --- decoder cross-KV precompute (once) ---
    Ld = dims.dec_layers
    add(KernelSpec("dec.cross.kv", S, 2 * d, d, dtype, Ld, "proj"))

    # --- decoder steps (m=1 incremental) ---
    for t in range(1, dec_steps + 1):
        add(KernelSpec("dec.attn.qkv", 1, 3 * d, d, dtype, Ld, "proj"))
        add(KernelSpec("dec.attn.out", 1, d, d, dtype, Ld, "proj"))
        add(KernelSpec("dec.attn.qk", 1, t, dh, "f16", Ld * h, "attn_qk"))
        add(KernelSpec("dec.attn.av", 1, dh, t, "f16", Ld * h, "attn_av"))
        add(KernelSpec("dec.cross.q", 1, d, d, dtype, Ld, "proj"))
        add(KernelSpec("dec.cross.out", 1, d, d, dtype, Ld, "proj"))
        add(KernelSpec("dec.cross.qk", 1, S, dh, "f16", Ld * h, "attn_qk"))
        add(KernelSpec("dec.cross.av", 1, dh, S, "f16", Ld * h, "attn_av"))
        add(KernelSpec("dec.mlp.up", 1, ff, d, dtype, Ld, "mlp"))
        add(KernelSpec("dec.mlp.down", 1, d, ff, dtype, Ld, "mlp"))
        add(KernelSpec("dec.logits", 1, v, d, dtype, 1, "logits"))
    return out


# ----------------------------------------------------------------------------
# Generic decoder-only LM workloads (ties the paper's analysis to every
# served architecture).
# ----------------------------------------------------------------------------

def lm_workload(*, name: str, n_layers: int, d_model: int, n_heads: int,
                n_kv_heads: int, d_ff: int, vocab: int, seq: int,
                mode: str = "decode", dtype: str = "f16",
                n_experts: int = 0, top_k: int = 0,
                steps: int = 1) -> list[KernelSpec]:
    """Kernel inventory for a decoder-only LM.

    ``mode='decode'``: ``steps`` incremental steps against a KV cache of
    length ``seq``. ``mode='prefill'``: one pass over ``seq`` tokens.
    MoE layers contribute top_k active expert GEMMs per token.
    """
    d, h, hk, ff, v = d_model, n_heads, n_kv_heads, d_ff, vocab
    dh = d // h
    m = 1 if mode == "decode" else seq
    S = seq
    out: list[KernelSpec] = []
    add = out.append
    L = n_layers
    c = steps if mode == "decode" else 1

    add(KernelSpec(f"{name}.attn.q", m, h * dh, d, dtype, L * c, "proj"))
    add(KernelSpec(f"{name}.attn.kv", m, 2 * hk * dh, d, dtype, L * c, "proj"))
    add(KernelSpec(f"{name}.attn.out", m, d, h * dh, dtype, L * c, "proj"))
    add(KernelSpec(f"{name}.attn.qk", m, S, dh, "f16", L * h * c, "attn_qk"))
    add(KernelSpec(f"{name}.attn.av", m, dh, S, "f16", L * h * c, "attn_av"))
    if n_experts and top_k:
        add(KernelSpec(f"{name}.moe.router", m, n_experts, d, dtype, L * c, "proj"))
        # top_k active experts per token; gate+up+down per expert.
        add(KernelSpec(f"{name}.moe.gate", m, ff, d, dtype, L * top_k * c, "mlp"))
        add(KernelSpec(f"{name}.moe.up", m, ff, d, dtype, L * top_k * c, "mlp"))
        add(KernelSpec(f"{name}.moe.down", m, d, ff, dtype, L * top_k * c, "mlp"))
    elif ff:
        add(KernelSpec(f"{name}.mlp.gate", m, ff, d, dtype, L * c, "mlp"))
        add(KernelSpec(f"{name}.mlp.up", m, ff, d, dtype, L * c, "mlp"))
        add(KernelSpec(f"{name}.mlp.down", m, d, ff, dtype, L * c, "mlp"))
    add(KernelSpec(f"{name}.logits", m, v, d, dtype, c, "logits"))
    return out


# ----------------------------------------------------------------------------


def total_flops(work: list[KernelSpec]) -> int:
    return sum(k.flops for k in work)


def total_dot_products(work: list[KernelSpec]) -> int:
    return sum(k.dot_products for k in work)


def total_calls(work: list[KernelSpec]) -> int:
    return sum(k.calls for k in work)


def k_length_histogram(work: list[KernelSpec]) -> dict[int, int]:
    """Histogram of dot-product lengths weighted by dot-product count —
    the distribution behind the paper's burst-length selection (Sec III-B)."""
    hist: dict[int, int] = {}
    for spec in work:
        hist[spec.k] = hist.get(spec.k, 0) + spec.dot_products
    return hist


def iter_unique_gemms(work: list[KernelSpec]) -> Iterator[KernelSpec]:
    seen = set()
    for spec in work:
        key = (spec.m, spec.n, spec.k, spec.dtype)
        if key not in seen:
            seen.add(key)
            yield spec
