"""PyTorch + CUDA port of the Whisper-on-CGLA reproduction, for the
NVIDIA H100.

A package of its own beside the JAX reference ``repro``: it imports
``torch`` and nothing of JAX or of ``repro``. It serves the paper's
whisper-tiny.en and the decoder-only xlstm-350m. Each Pallas kernel of
the JAX package has a hand-written CUDA kernel under ``csrc/`` with a
plain PyTorch version beside it (``kernels/<op>/``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from repro_torch.audio.transcribe import TranscribeResult, transcribe

__all__ = ["TranscribeResult", "transcribe"]
