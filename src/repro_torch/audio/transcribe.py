"""``repro_torch.transcribe``: samples in, tokens out, on the card.

The port of the JAX package's ``audio/transcribe.py``: log-mel frontend
-> chunked encoder -> slot-pool decode, one-shot or streamed chunk by
chunk, with platform-aware dispatch and the energy report. The models
are randomly initialized reproductions, so the token ids are not text;
what runs is the compute pipeline the paper measures.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.audio.features import (FrontendConfig, audio_frames,
                                        resample_linear)
from repro_torch.audio.stream import chunk_list
from repro_torch.configs import get_config
from repro_torch.configs import reduced as reduced_cfg
from repro_torch.models.model import build
from repro_torch.platforms import get_platform, resolve_device
from repro_torch.serving.engine import (AudioRequest, ServeEngine,
                                        StreamingAudioRequest)
from repro_torch.serving.scheduler import BatchScheduler

DEFAULT_PROMPT = (1,)        # stand-in for whisper's <|sot|> sequence
DEFAULT_CHUNK_FRAMES = 16    # encoder chunk (frame embeddings) for streaming


@dataclasses.dataclass
class TranscribeResult:
    """What one transcription produced and what it cost."""

    tokens: list
    partials: list                   # streaming: one hypothesis per chunk
    audio_s: float
    n_frames: int
    ticks: int
    wall_s: float                    # serve wall time, host clock
    compute_ms_per_audio_s: float
    platform: Optional[str]
    cache_dtype: str
    energy: Optional[dict]
    decode_block: int = 1
    decode_steps: int = 0
    host_syncs: int = 0
    decode_s: float = 0.0            # one-shot: decode ticks after the
                                     # prefill, host clock (every tick ends
                                     # in a fetch); 0 for a stream
    engine: Any = dataclasses.field(default=None, repr=False)
    # the logits row of each token, when the engine keeps them
    logits: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def text(self) -> str:
        """Space-joined token ids (no trained tokenizer exists here)."""
        return " ".join(str(t) for t in self.tokens)


def _default_model(arch: str, reduced: bool, seed: int, device):
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_cfg(cfg)
    model = build(cfg)
    gen = torch.Generator().manual_seed(seed)
    return model, model.init_values(gen, device)


def transcribe(samples, sr: int = 16_000, *,
               arch: str = "whisper-tiny-en", reduced: bool = True,
               model=None, params=None,
               platform: Optional[str] = None,
               cache_dtype: Optional[str] = None,
               decode_block: Optional[int] = None,
               chunk_frames: int = DEFAULT_CHUNK_FRAMES,
               prompt=DEFAULT_PROMPT, max_new: int = 16,
               eos_id: int = -1, stream: bool = False,
               frontend: Optional[FrontendConfig] = None,
               seed: int = 0, engine: Optional[ServeEngine] = None,
               device=None) -> TranscribeResult:
    """Transcribe one waveform end to end on ``device`` (default
    ``cuda``). ``platform`` (a ``repro_torch.platforms`` name) derives
    the dispatch context and enables the energy report.
    ``decode_block`` fuses that many decode steps per engine tick (one
    host sync per tick). ``stream=True`` serves through the streaming
    path (one chunk of ``chunk_frames`` a scheduler tick, partial
    hypotheses in ``result.partials``); the final tokens are those of
    ``stream=False`` on the same audio. Pass ``engine=`` to reuse an
    engine of the same shapes; its platform and cache policy apply and
    its serve stats are reset."""
    if decode_block is not None and int(decode_block) < 1:
        raise ValueError(f"decode_block must be >= 1, got {decode_block}")
    dev = engine.device if engine is not None else resolve_device(device)
    fe = frontend or FrontendConfig()
    x = resample_linear(samples, sr, fe.sample_rate)
    audio_s = len(x) / fe.sample_rate
    if model is None or params is None:
        model, params = _default_model(arch, reduced, seed, dev)
    if not model.cfg.enc_dec:
        raise ValueError(f"transcribe needs an enc-dec (audio) model; "
                         f"{model.cfg.name} is {model.cfg.family}")
    with torch.no_grad():
        frames = audio_frames(x, model.cfg.d_model, fe, device=dev)
    if frames.shape[0] == 0:
        raise ValueError(f"audio too short: {len(x)} samples produce no "
                         f"frames (need >= 1 hop = {fe.hop} samples)")
    chunks = chunk_list(frames, chunk_frames)
    n_frames = frames.shape[0]
    if engine is None:
        cache_dtype = cache_dtype or "bf16"
        engine = ServeEngine(
            model, params, n_slots=1,
            max_len=len(prompt) + max_new + 2, enc_len=n_frames,
            cache_dtype=cache_dtype, decode_block=decode_block or 1,
            platform=platform, device=dev)
    else:
        if cache_dtype is not None and cache_dtype != engine.cache_dtype:
            raise ValueError(f"cache_dtype={cache_dtype!r} conflicts with "
                             f"the reused engine's {engine.cache_dtype!r}")
        if platform is not None:
            want = get_platform(platform).name
            have = engine.platform.name if engine.platform else None
            if want != have:
                raise ValueError(f"platform={platform!r} conflicts with "
                                 f"the reused engine's {have!r}")
        cache_dtype = engine.cache_dtype
        if decode_block is not None:
            engine.decode_block = int(decode_block)
    engine.reset_serve_stats()
    t0 = time.monotonic()
    if stream:
        sched = BatchScheduler(engine)
        sched.submit(StreamingAudioRequest(uid=0, tokens=list(prompt),
                                           max_new=max_new, eos_id=eos_id,
                                           chunks=chunks))
        sched.run_until_drained()
        st = sched.results[0]
        if st.error:
            raise ValueError(st.error)
        t_dec = t_end = time.monotonic()
    else:
        states = engine.encode_chunks(chunks)
        st = engine.admit(AudioRequest(uid=0, tokens=list(prompt),
                                       max_new=max_new, eos_id=eos_id,
                                       enc_states=states[0]))
        t_dec = time.monotonic()
        while engine.n_active:
            engine.step()
        t_end = time.monotonic()
    wall = t_end - t0
    energy = None
    if engine.platform is not None:
        energy = engine.energy_report("fp16")
        energy["joules_per_audio_s"] = energy["pdp_j"] / max(audio_s, 1e-9)
    return TranscribeResult(
        tokens=list(st.out), partials=[list(p) for p in st.partials],
        audio_s=audio_s,
        n_frames=n_frames, ticks=engine._ticks, wall_s=wall,
        compute_ms_per_audio_s=wall / max(audio_s, 1e-9) * 1e3,
        platform=engine.platform.name if engine.platform else None,
        cache_dtype=cache_dtype, energy=energy,
        decode_block=engine.decode_block,
        decode_steps=engine._decode_steps, host_syncs=engine._host_syncs,
        decode_s=t_end - t_dec, engine=engine, logits=list(st.logits))
