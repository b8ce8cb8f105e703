"""Deterministic synthetic token pipeline (local fallback when not
streaming from the edge), a copy of the reference's
``repro.data.tokens``.  Produces a learnable distribution (Zipfian
unigrams + short-range bigram structure) so example training losses
decrease meaningfully.  NumPy only: the same ``default_rng(seed)`` draws
in the same order, so both packages give the same batches bit for bit."""

from __future__ import annotations

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 batch_size: int = 8):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # deterministic "successor" structure: each token strongly predicts
        # (token * 7 + 3) % vocab, giving a model something to learn
        self.successor = (np.arange(vocab_size) * 7 + 3) % vocab_size

    def sample_batch(self) -> dict:
        B, S = self.batch, self.seq
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self.rng.choice(self.vocab, size=B, p=self.unigram)
        for t in range(1, S + 1):
            follow = self.rng.random(B) < 0.8
            toks[:, t] = np.where(
                follow, self.successor[toks[:, t - 1]],
                self.rng.choice(self.vocab, size=B, p=self.unigram))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        while True:
            yield self.sample_batch()
