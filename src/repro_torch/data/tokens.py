"""Deterministic synthetic token pipeline (local fallback when not
streaming from the edge), a copy of the reference's
``repro.data.tokens``.  Produces a learnable distribution (Zipfian
unigrams + short-range bigram structure) so example training losses
decrease meaningfully.  NumPy only: the same ``default_rng(seed)`` draws
in the same order, so both packages give the same batches bit for bit.
One difference: each unigram draw is ``Generator.choice``'s own (one
``random(n)`` into the normalised cumulative distribution, searched from
the right), with the distribution summed once instead of at every
position (the chip smoke took 29.4 s to draw granite-8b's 17 train
batches of 4 x 4096 that way)."""

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
        cdf = self.unigram.cumsum()
        self._cdf = cdf / cdf[-1]

    def _unigram(self, n: int) -> np.ndarray:
        """``rng.choice(vocab, size=n, p=unigram)``, drawn as it draws."""
        return self._cdf.searchsorted(self.rng.random(n), side="right")

    def sample_batch(self) -> dict:
        B, S = self.batch, self.seq
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self._unigram(B)
        for t in range(1, S + 1):
            follow = self.rng.random(B) < 0.8
            toks[:, t] = np.where(
                follow, self.successor[toks[:, t - 1]], self._unigram(B))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        while True:
            yield self.sample_batch()
