"""Synthetic data pipeline (numpy only).

The port's copy of `repro.data.pipeline`: deterministic on-the-fly token
streams (no external datasets), a mix of Zipfian unigram draws and short
repeated motifs so the LM loss has learnable structure, packed to a fixed
sequence length, and the modality stub's inputs (frame embeddings for an
encoder-decoder).  The same seed yields arrays bit-identical to the
reference's: the draws are the same numpy generator calls in the same
order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch_size: int
    seq_len: int
    seed: int = 0


class SyntheticTokenStream:
    """Zipf unigrams + motif repetition; yields packed (tokens, labels)."""

    def __init__(self, vocab_size: int, cfg: DataConfig):
        self.vocab = vocab_size
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # motif table: 64 motifs of length 8
        self.motifs = self.rng.integers(0, vocab_size,
                                        size=(64, 8), dtype=np.int32)

    def _sample_seq(self, length: int) -> np.ndarray:
        out = np.empty(length + 1, dtype=np.int32)
        i = 0
        while i < length + 1:
            if self.rng.random() < 0.3:
                m = self.motifs[self.rng.integers(0, len(self.motifs))]
                n = min(len(m), length + 1 - i)
                out[i:i + n] = m[:n]
                i += n
            else:
                n = min(int(self.rng.integers(4, 17)), length + 1 - i)
                # Zipf-ish draw, clipped to vocab
                z = self.rng.zipf(1.3, size=n).astype(np.int64) % self.vocab
                out[i:i + n] = z.astype(np.int32)
                i += n
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        b, t = self.cfg.batch_size, self.cfg.seq_len
        while True:
            seqs = np.stack([self._sample_seq(t) for _ in range(b)])
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def make_batch(cfg: ModelConfig, batch_size: int, seq_len: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """One synthetic batch with the right extra inputs for the modality."""
    stream = SyntheticTokenStream(cfg.vocab_size,
                                  DataConfig(batch_size, seq_len, seed))
    batch = next(iter(stream))
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(seed + 1)
        batch["frames"] = rng.normal(
            0, 1, size=(batch_size, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32) * 0.02
    return batch
