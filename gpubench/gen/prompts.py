"""Prompts for the serving drivers: token ids uniform over the published
vocabulary, from a numpy PCG64 stream of the seed.  Every seed gives the
same lengths and the same number of requests a wave; only the ids
differ."""
from __future__ import annotations

import numpy as np

from gpubench.lib.common import seed_stream


class PromptStream:
    def __init__(self, seed: int, tag: str, vocab: int, length: int):
        self._rng = np.random.Generator(np.random.PCG64(seed_stream(seed,
                                                                    tag)))
        self.vocab = int(vocab)
        self.length = int(length)

    def batch(self, rows: int) -> np.ndarray:
        """(rows, length) int64 token ids, the stream's next rows."""
        return self._rng.integers(0, self.vocab, size=(rows, self.length),
                                  dtype=np.int64)
