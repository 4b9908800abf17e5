"""Deterministic synthetic LM data, structured enough that loss decreases.

A copy of src/repro/data/synthetic.py (numpy only, copied so that the port
imports nothing of the JAX package): the same draws, so its batches are
bit-equal to the reference's.  Token streams are Markov-ish:
token_{t+1} = (a * token_t + b + noise) % V with per-sequence (a, b), so a
model can reduce loss well below uniform.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    noise: float = 0.02
    fixed_map: bool = False  # one global (a, b): a memorizable bigram task
    # (per-sequence (a, b) requires in-context inference — much harder)

    def batch(self, step: int, batch_size: int):
        rng = np.random.default_rng(self.seed * 1_000_003 + step)
        if self.fixed_map:
            a = np.full((batch_size, 1), 5)
            b = np.full((batch_size, 1), 131 % self.vocab)
        else:
            a = rng.integers(1, 17, (batch_size, 1))
            b = rng.integers(0, self.vocab, (batch_size, 1))
        t0 = rng.integers(0, self.vocab, (batch_size, 1))
        toks = np.zeros((batch_size, self.seq_len + 1), np.int64)
        toks[:, :1] = t0
        for t in range(self.seq_len):
            nxt = (a[:, 0] * toks[:, t] + b[:, 0]) % self.vocab
            flip = rng.random(batch_size) < self.noise
            nxt = np.where(flip, rng.integers(0, self.vocab, batch_size), nxt)
            toks[:, t + 1] = nxt
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
