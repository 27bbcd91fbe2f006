"""Synthetic token stream for LM training (the `make_lm_stream` of
`repro.data.synthetic`).  It follows the reference's law — Zipf unigram
draws mixed half-and-half with the deterministic bigram drift
next = (prev*7 + 3) mod V — from a numpy seed; it matches the reference
statistically, not token for token."""
from __future__ import annotations

import numpy as np
import torch


def make_lm_stream(seed: int, n_tokens: int, vocab: int, device,
                   alpha: float = 1.2) -> torch.Tensor:
    """(n_tokens,) int64 token ids on `device`."""
    rng = np.random.default_rng(seed)
    probs = np.arange(1, vocab + 1, dtype=np.float64) ** (-alpha)
    z = rng.choice(vocab, size=n_tokens, p=probs / probs.sum())
    mix = rng.random(n_tokens) < 0.5
    out = np.empty(n_tokens, dtype=np.int64)
    prev = 0
    for i, (zi, mi) in enumerate(zip(z.tolist(), mix.tolist())):
        prev = (prev * 7 + 3) % vocab if mi else zi
        out[i] = prev
    return torch.from_numpy(out).to(device)
