"""CUDA route of ``paged_decode_attention``: the page gather
(``plain.gather_pages``), then for a q8_0 or q4_0 pool the tier's
hand-written decode-attention kernel (``csrc/q8_attention.cu`` /
``csrc/q4_attention.cu`` through their stacked-cache wrappers, which
take the gathered planes' strides, so no transpose copy runs), and for a
bf16 pool the same torch-op chain as the plain version (the reference
has no kernel there either). The reference has no Pallas kernel for this
op; the gather that feeds the kernels is a torch ``index_select``. On
CPU tensors the wrappers run their plain versions."""

from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.plain import paged
from repro_torch.kernels.q4_attention import ops as q4_ops
from repro_torch.kernels.q8_attention import ops as q8_ops


def paged_decode_attention(q, kc, vc, table, lens) -> torch.Tensor:
    """The plain version's signature and result; see the module."""
    return paged(q, kc, vc, table, lens, q8_ops.q8_decode_attention_cache,
                 q4_ops.q4_decode_attention_cache)
