"""Deterministic sharded synthetic data pipeline (a numpy copy of the JAX
package's ``data/synthetic.py``: the same batches, bit for bit).

Every batch is a pure function of ``(seed, step, shard)`` via Philox
counter-based RNG — no iterator state exists, so:

* **restart determinism** — resuming from a checkpoint at step *t* replays
  exactly the batches a non-interrupted run would have seen;
* **elastic resharding** — a restore onto a different data-parallel degree
  re-partitions the *same* global batch (shards are slices of the global
  sample index space, not per-host streams);
* **straggler-free** — no host ever waits on a shared queue.

Token streams follow a Zipfian unigram distribution (vocab realism for the
CE loss); audio-frame / image-patch stubs are Gaussian embeddings.
``targets`` are next-token shifted with the final position masked
(ignore_id = -1). Batches are numpy arrays: moving one to the device is
the caller's (``TrainLoop``'s ``put_batch``, or the train step itself).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import ArchConfig

IGNORE_ID = -1


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    # Philox counter-based: key packs (seed, step<<20 | shard) — pure
    # function of the triple, no sequential state.
    return np.random.Generator(
        np.random.Philox(key=[seed, (step << 20) | shard]))


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf(1.1)-distributed token ids folded into [0, vocab)."""
    z = rng.zipf(1.1, size=shape).astype(np.int64)
    return (z % vocab).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1

    def __post_init__(self):
        assert self.global_batch % self.n_shards == 0, (
            self.global_batch, self.n_shards)

    @property
    def shard_batch(self) -> int:
        return self.global_batch // self.n_shards

    def shard_batch_at(self, step: int, shard: int) -> dict:
        """The ``shard``-th slice of the global batch for ``step``."""
        return batch_for_step(self.cfg, self.seq_len, self.shard_batch,
                              seed=self.seed, step=step,
                              shard=shard, n_shards=self.n_shards)

    def global_batch_at(self, step: int) -> dict:
        out = [self.shard_batch_at(step, s) for s in range(self.n_shards)]
        return {k: np.concatenate([o[k] for o in out], axis=0)
                for k in out[0]}


def batch_for_step(cfg: ArchConfig, seq_len: int, batch: int, *,
                   seed: int = 0, step: int = 0, shard: int = 0,
                   n_shards: int = 1) -> dict:
    """One training batch: tokens/targets (+ frontend stub tensors)."""
    rng = _rng(seed, step, shard)
    d = cfg.d_model

    if cfg.enc_dec:
        s2 = seq_len // 2
        tokens = _zipf_tokens(rng, (batch, s2 + 1), cfg.vocab)
        frames = rng.standard_normal((batch, s2, d)).astype(np.float32)
        return {"enc_frames": frames * 0.02,
                "tokens": tokens[:, :-1],
                "targets": _shift_targets(tokens)}
    if cfg.vlm:
        n_img = cfg.n_img_tokens
        s_text = seq_len - n_img
        tokens = _zipf_tokens(rng, (batch, s_text + 1), cfg.vocab)
        img = rng.standard_normal((batch, n_img, d)).astype(np.float32)
        tgt_text = _shift_targets(tokens)
        # image-prefix positions carry no next-token loss
        tgt = np.concatenate(
            [np.full((batch, n_img), IGNORE_ID, np.int32), tgt_text], axis=1)
        return {"img_embed": img * 0.02, "tokens": tokens[:, :-1],
                "targets": tgt}
    tokens = _zipf_tokens(rng, (batch, seq_len + 1), cfg.vocab)
    return {"tokens": tokens[:, :-1], "targets": _shift_targets(tokens)}


def _shift_targets(tokens: np.ndarray) -> np.ndarray:
    """Next-token targets for tokens[:, :-1]: i.e. tokens[:, 1:]."""
    return tokens[:, 1:].astype(np.int32)
