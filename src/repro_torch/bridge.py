"""Carry the JAX package's parameters across to the port.

The port cannot reproduce ``jax.random``, so a test that holds the two
packages against each other builds the reference's parameter pytree,
maps its leaves to numpy, and hands the result to ``params_from_numpy``.
The tree keeps its nesting, including the stacked leading layer axis of
``enc_layers`` and ``dec_layers``. Quantized leaves are recognised by
duck typing (an object with ``.q`` and ``.scale``), so this module needs
nothing from the JAX package; the dtype of the codes names the tier:
uint8 nibble pairs are a ``Q4Tensor``, int8 codes a ``Q8Tensor``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.quantize import QTENSORS, Q4Tensor, Q8Tensor


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy array (bfloat16 from ``ml_dtypes`` included) -> tensor.

    ``torch.from_numpy`` refuses numpy's bfloat16, so those bits move as
    ``uint16`` and are viewed as ``torch.bfloat16``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Convert a nested dict of numpy leaves (and ``.q``/``.scale``
    quantized leaves: uint8 codes -> ``Q4Tensor``, int8 -> ``Q8Tensor``)
    into the port's parameters on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        q = tensor_from_numpy(tree.q, device)
        if q.dtype == torch.uint8:
            cls = Q4Tensor
        elif q.dtype == torch.int8:
            cls = Q8Tensor
        else:
            raise TypeError(f"quantized leaf with {q.dtype} codes: expected "
                            f"uint8 (Q4_0) or int8 (Q8_0)")
        return cls(q=q, scale=tensor_from_numpy(tree.scale, device))
    return tensor_from_numpy(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """The inverse walk, for round-trip checks: tensors -> numpy arrays
    (bfloat16 as ``ml_dtypes.bfloat16``); Q8Tensor / Q4Tensor ->
    ``(q, scale)``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, QTENSORS):
        return (params_to_numpy(tree.q), params_to_numpy(tree.scale))
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
