"""Copies of ``repro.data.synthetic`` for the port.

MNIST is unavailable offline, so ``class_images`` generates an MNIST-shaped
surrogate: each class is a fixed random prototype image; samples are
prototype + per-sample Gaussian noise + random shift.  ``lm_tokens`` gives
the LLM zoo's token streams: a mixture of Markov chains.  The arrays are
bitwise those of the reference for the same arguments.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def class_images(n: int, seed: int = 0, hw: int = 28, n_classes: int = 10,
                 noise: float = 0.2, shift: int = 2
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images [n, hw, hw, 1] float32 in [0,1]-ish, labels [n]).

    Memoized, and the cached arrays are read-only so shared references
    cannot be corrupted; callers that need to write must copy.
    """
    rng = np.random.default_rng(seed)
    protos = rng.uniform(0.0, 1.0, size=(n_classes, hw, hw)).astype(np.float32)
    # smooth the prototypes so classes differ at low frequencies (digit-like)
    for _ in range(3):
        protos = 0.25 * (np.roll(protos, 1, 1) + np.roll(protos, -1, 1)
                         + np.roll(protos, 1, 2) + np.roll(protos, -1, 2))
    protos = (protos - protos.min((1, 2), keepdims=True)) \
        / np.ptp(protos, axis=(1, 2), keepdims=True).clip(1e-6)
    labels = rng.integers(0, n_classes, size=n)
    imgs = protos[labels].copy()
    dx = rng.integers(-shift, shift + 1, size=n)
    dy = rng.integers(-shift, shift + 1, size=n)
    for i in range(n):
        imgs[i] = np.roll(np.roll(imgs[i], dx[i], 0), dy[i], 1)
    imgs += rng.normal(0.0, noise, size=imgs.shape).astype(np.float32)
    imgs, labels = imgs[..., None], labels.astype(np.int32)
    imgs.flags.writeable = False
    labels.flags.writeable = False
    return imgs, labels


def lm_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0
              ) -> np.ndarray:
    """Markov-mixture token streams [n_seqs, seq_len] int32."""
    rng = np.random.default_rng(seed)
    k = min(vocab, 64)
    trans = rng.dirichlet(np.ones(k) * 0.1, size=k)
    out = np.zeros((n_seqs, seq_len), np.int64)
    state = rng.integers(0, k, size=n_seqs)
    for t in range(seq_len):
        out[:, t] = state
        u = rng.random((n_seqs, 1))
        state = (trans[state].cumsum(1) > u).argmax(1)
    return (out % vocab).astype(np.int32)
