"""Audio frontend and streaming encode: samples -> log-mel -> frame
embeddings -> (chunked) encoder states -> tokens (the JAX package's
``repro.audio``).

* ``features``   — the Whisper-style log-mel frontend (framing, Hann
  window, rfft power spectrum, the mel filterbank and the projection as
  dispatched f32 GEMMs) with a NumPy golden reference;
* ``stream``     — the streaming frontend (sample-exact incremental
  framing), fixed-size encoder chunks, the synthetic test waveform;
* ``transcribe`` — the one-call ``repro_torch.transcribe()`` over the
  serving engine, one-shot or streamed.
"""

from repro_torch.audio.features import (FrontendConfig, audio_frames,
                                        hann_window, log_mel, log_mel_ref,
                                        mel_filterbank, mel_to_frames)
from repro_torch.audio.stream import (StreamingFrontend, chunk_list,
                                      synth_waveform)
from repro_torch.audio.transcribe import TranscribeResult, transcribe

__all__ = [
    "FrontendConfig", "StreamingFrontend", "TranscribeResult",
    "audio_frames", "chunk_list", "hann_window", "log_mel", "log_mel_ref",
    "mel_filterbank", "mel_to_frames", "synth_waveform", "transcribe",
]
