"""The benchmark's inputs, drawn from the seed: uniform token documents for
scoring (on the device) and a seeded synthetic token stream for training
(on the host), each a pure function of (seed, index), so that the check
draws the same inputs again for the reference."""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.weights import derive, generator


def documents(seed: int, index: int, batch: int, length: int, vocab: int,
              device) -> torch.Tensor:
    """Batch ``index``: [batch, length + 1] token ids, uniform over the
    vocabulary (the last column is only ever a label)."""
    g = generator(device, derive(seed, 2, index))
    return torch.randint(0, vocab, (batch, length + 1), generator=g,
                         device=device)


class SyntheticLM:
    """A frozen copy of ``repro_torch.data.pipeline.SyntheticLM``'s
    semantics: batch ``index`` is ``rows`` sequences of ``length + 1`` ids
    drawn with probabilities proportional to ``rank ** -1.1`` from
    ``np.random.SeedSequence([seed, index, 0])``, split into tokens and
    next-token labels, with a mask of ones. It has the ``batch(index)``
    method the port's ``PrefetchPipeline`` calls."""

    def __init__(self, seed: int, rows: int, length: int, vocab: int):
        self.seed, self.rows, self.length, self.vocab = seed, rows, length, vocab
        p = 1.0 / np.arange(1, vocab + 1) ** 1.1
        self._p = p / p.sum()

    def batch(self, index: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, index, 0]))
        toks = rng.choice(self.vocab, size=(self.rows, self.length + 1),
                          p=self._p).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "mask": np.ones((self.rows, self.length), np.float32)}
