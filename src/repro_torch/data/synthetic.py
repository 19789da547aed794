"""Synthetic image datasets (no MNIST/CIFAR downloads).

``make_image_dataset`` builds classification problems with the same shapes
and a tunable difficulty so the paper's relative comparisons (scheme A
converges in fewer rounds / less traffic than scheme B) are preserved:

* each class has a prototype image (low-frequency random pattern);
* samples = prototype + structured noise + random shift, so the Bayes error
  is controlled by ``noise``;
* "mnist"-like: 28x28x1 easy; "fmnist": 28x28x1 harder; "cifar10": 32x32x3
  hardest (more noise, colour channels).

A numpy copy of ``repro.data.synthetic``'s image datasets and its LM
token stream (``synthetic_token_batches``); the port imports nothing of
``repro``, and the same seed gives the same arrays bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class SyntheticImageDataset:
    x: np.ndarray  # (N, H, W, C) float32 in [0, 1]
    y: np.ndarray  # (N,) int32
    num_classes: int

    def split(self, frac: float = 0.9, seed: int = 0):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(len(self.x))
        k = int(len(self.x) * frac)
        tr, te = idx[:k], idx[k:]
        return (SyntheticImageDataset(self.x[tr], self.y[tr], self.num_classes),
                SyntheticImageDataset(self.x[te], self.y[te], self.num_classes))


_PRESETS = {
    "mnist": dict(size=28, channels=1, noise=0.25, shift=2),
    "fmnist": dict(size=28, channels=1, noise=0.45, shift=2),
    "cifar10": dict(size=32, channels=3, noise=0.65, shift=3),
}


def make_image_dataset(name: str, n: int = 4000, num_classes: int = 10,
                       seed: int = 0) -> SyntheticImageDataset:
    p = _PRESETS[name]
    rng = np.random.RandomState(seed)
    size, ch = p["size"], p["channels"]
    # low-frequency class prototypes
    low = rng.randn(num_classes, 8, 8, ch)
    protos = np.stack([_upsample(low[c], size) for c in range(num_classes)])
    protos /= np.abs(protos).max(axis=(1, 2, 3), keepdims=True) + 1e-9

    y = rng.randint(0, num_classes, size=n).astype(np.int32)
    x = protos[y].copy()
    # random shifts (translation invariance makes convs meaningful)
    for i in range(n):
        sx, sy = rng.randint(-p["shift"], p["shift"] + 1, 2)
        x[i] = np.roll(np.roll(x[i], sx, axis=0), sy, axis=1)
    x += p["noise"] * rng.randn(*x.shape)
    x = (x - x.min()) / (x.max() - x.min() + 1e-9)
    return SyntheticImageDataset(x.astype(np.float32), y, num_classes)


def _upsample(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear-ish upsample from 8x8 to size x size via repetition + box blur."""
    rep = int(np.ceil(size / img.shape[0]))
    big = np.repeat(np.repeat(img, rep, axis=0), rep, axis=1)[:size, :size]
    k = 3
    pad = np.pad(big, ((k, k), (k, k), (0, 0)), mode="wrap")
    out = np.zeros_like(big)
    for dx in range(-k, k + 1):
        for dy in range(-k, k + 1):
            out += pad[k + dx:k + dx + size, k + dy:k + dy + size]
    return out / (2 * k + 1) ** 2


def synthetic_token_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                            zipf_a: float = 1.2) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite iterator of (tokens, labels) with learnable structure:
    next token = (3*tok + 7) % vocab with prob 0.8, else Zipf sample."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    while True:
        toks = np.zeros((batch, seq + 1), np.int32)
        toks[:, 0] = rng.choice(vocab, size=batch, p=probs)
        noise = rng.rand(batch, seq)
        rand_tok = rng.choice(vocab, size=(batch, seq), p=probs)
        for t in range(seq):
            det = (3 * toks[:, t] + 7) % vocab
            toks[:, t + 1] = np.where(noise[:, t] < 0.8, det, rand_tok[:, t])
        yield toks[:, :-1], toks[:, 1:]
