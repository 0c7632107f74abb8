"""What a training run starts from, shared by the train launcher,
``python -m repro_torch.breakdown --train`` and ``chip_smoke.py``'s
phase o: the model, its f32 state drawn by a generator on the device,
the synthetic pipeline and the AdamW settings."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config, reduced as reduced_config
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.models.model import build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.platforms import resolve_device
from repro_torch.train.step import init_train_state

#: phase o of chip_smoke.py: each trained model's batch rows, sequence
#: length (an enc-dec row is half encoder frames and half tokens), layers
#: kept (None: all), peak learning rate, warmup steps and steps in all
TRAIN_SETUP = {
    "whisper-tiny-en": dict(batch=8, seq=896, layers=None, lr=1e-3,
                            warmup=5, steps=20),
    "qwen3-4b": dict(batch=4, seq=256, layers=4, lr=1e-4, warmup=2,
                     steps=8)}


def adamw_config(lr: float, warmup: int, steps: int) -> AdamWConfig:
    """The launcher's AdamW: peak ``lr`` after ``warmup`` steps, the
    cosine ending at ``steps``, the reference's other defaults."""
    return AdamWConfig(lr=lr, warmup_steps=warmup, total_steps=steps)


def train_setup(arch: str, *, batch: int, seq: int, seed: int = 0,
                device=None, reduced: bool = False, layers=None):
    """``arch`` (its ``reduced`` config, cut to ``layers`` where that is
    set), f32 weights and a fresh AdamW state drawn by a generator on
    ``device`` (default ``cuda``) seeded with ``seed``, and the synthetic
    pipeline of ``batch`` rows of ``seq`` keyed by ``seed``. Returns
    (model, state, dataset)."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(model, gen, device)
    return model, state, SyntheticDataset(cfg, seq_len=seq,
                                          global_batch=batch, seed=seed)


def preset(arch: str, seed: int = 0, device="cuda"):
    """``TRAIN_SETUP[arch]``'s run: (model, state, dataset, AdamW
    config)."""
    p = TRAIN_SETUP[arch]
    model, state, ds = train_setup(arch, batch=p["batch"], seq=p["seq"],
                                   layers=p["layers"], seed=seed,
                                   device=device)
    return model, state, ds, adamw_config(p["lr"], p["warmup"], p["steps"])
