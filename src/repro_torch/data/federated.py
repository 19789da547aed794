"""Federated data partitioning: a numpy copy of
``repro.data.federated``.

``iid_partition`` and ``dirichlet_partition`` (non-IID label skew)
return per-client index arrays; ``CyclicPartition`` is their O(1)-memory
view for huge client counts; ``client_batches`` builds one round's
mini-batch tensor (K, B, ...) for the simulator -- for the whole bank,
or (``idx=``) just the round's cohort -- and ``round_batches`` the tau
local epochs of it; ``rho_weights`` gives the paper's rho^n = D^n / D
aggregation weights (eq. 5); ``replacement_fraction`` the share of
clients whose draws repeat data. The same seeds draw the same batches
as the reference.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset


def iid_partition(n_samples: int, n_clients: int, seed: int = 0,
                  sizes: List[int] = None) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n_samples)
    if sizes is None:
        if n_clients > n_samples:
            warnings.warn(
                f"iid_partition: {n_clients} clients > {n_samples} samples; "
                f"{n_clients - n_samples} clients get EMPTY partitions",
                stacklevel=2)
        return list(np.array_split(idx, n_clients))
    if len(sizes) != n_clients:
        raise ValueError(f"sizes has {len(sizes)} entries for {n_clients} "
                         "clients")
    if sum(sizes) > n_samples:
        raise ValueError(f"requested {sum(sizes)} samples, dataset has "
                         f"{n_samples}")
    leftover = n_samples - sum(sizes)
    if leftover:
        warnings.warn(
            f"iid_partition: sizes sum to {sum(sizes)} < {n_samples}; "
            f"dropping {leftover} samples ({leftover / n_samples:.1%} of "
            f"the dataset) that no client will ever see", stacklevel=2)
    out, start = [], 0
    for s in sizes:
        out.append(idx[start:start + s])
        start += s
    return out


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.5,
                        seed: int = 0) -> List[np.ndarray]:
    """Non-IID label-skew split (standard Dirichlet protocol)."""
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    out = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, cuts)):
            out[cl].extend(part.tolist())
    return [np.asarray(sorted(v), dtype=np.int64) for v in out]


class CyclicPartition:
    """O(1)-memory partition view for huge client counts (fig11 at
    N=1M): client ``i`` owns ``part_size`` consecutive sample indices
    starting at ``(i * part_size) % n_samples``, wrapping cyclically.
    ``iid_partition`` would materialize a million index arrays before
    the first round ever runs; this computes each client's indices on
    access and supports the same len/indexing/iteration surface, so
    ``client_batches``/``round_batches`` (which only ever touch the
    round's K participants) work unchanged. Sample coverage matches the
    IID split when ``n_clients * part_size >= n_samples``; samples are
    shared across clients when the wrap overlaps — the deliberate
    trade for never holding O(N) partition state."""

    def __init__(self, n_samples: int, n_clients: int,
                 part_size: Optional[int] = None):
        if n_samples <= 0 or n_clients <= 0:
            raise ValueError("CyclicPartition needs n_samples, n_clients > 0")
        self.n_samples = int(n_samples)
        self.n_clients = int(n_clients)
        self.part_size = int(part_size) if part_size \
            else max(1, self.n_samples // self.n_clients)

    def __len__(self) -> int:
        return self.n_clients

    def __getitem__(self, i: int) -> np.ndarray:
        i = int(i)
        if not -self.n_clients <= i < self.n_clients:
            raise IndexError(f"client {i} outside bank of {self.n_clients}")
        start = (i % self.n_clients) * self.part_size % self.n_samples
        return (start + np.arange(self.part_size)) % self.n_samples

    def __iter__(self):
        for i in range(self.n_clients):
            yield self[i]


def rho_weights(parts: List[np.ndarray]) -> np.ndarray:
    """rho^n = D^n / D (eq. 5)."""
    d = np.asarray([len(p) for p in parts], np.float64)
    return (d / d.sum()).astype(np.float32)


def replacement_fraction(parts: List[np.ndarray], batch: int,
                         idx: Optional[Sequence[int]] = None) -> float:
    """Fraction of (participating) clients whose partition is smaller
    than ``batch`` — i.e. whose draws sample WITH replacement and repeat
    data within a mini-batch. 0.0 means every draw is replacement-free."""
    if isinstance(parts, CyclicPartition):
        # every client owns exactly part_size samples — answer without
        # iterating the (possibly million-entry) partition
        return float(parts.part_size < batch)
    sel = parts if idx is None else [parts[i] for i in idx]
    if not sel:
        return 0.0
    return sum(len(p) < batch for p in sel) / len(sel)


def client_batches(ds: SyntheticImageDataset, parts: List[np.ndarray],
                   batch: int, rng: np.random.RandomState,
                   idx: Optional[Sequence[int]] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One round's mini-batches: x (K, B, H, W, C), y (K, B).

    ``idx`` selects the participating clients (``None``: all). Clients
    with fewer than ``batch`` samples draw with replacement, with a
    warning; an empty partition is an error."""
    sel = parts if idx is None else [parts[i] for i in idx]
    short = [i for i, p in enumerate(sel) if len(p) < batch]
    if any(len(sel[i]) == 0 for i in short):
        raise ValueError(
            "client_batches: empty client partition(s) "
            f"{[i for i in short if len(sel[i]) == 0]} — more clients than "
            "samples? (see iid_partition warning)")
    if short:
        warnings.warn(
            f"client_batches: {len(short)}/{len(sel)} participating "
            f"clients have < {batch} samples; drawing WITH replacement "
            f"(replacement_fraction={len(short) / len(sel):.2f})",
            stacklevel=2)
    xs, ys = [], []
    for p in sel:
        take = rng.choice(p, size=batch, replace=len(p) < batch)
        xs.append(ds.x[take])
        ys.append(ds.y[take])
    return np.stack(xs), np.stack(ys)


def round_batches(ds: SyntheticImageDataset, parts: List[np.ndarray],
                  batch: int, tau: int, rng: np.random.RandomState,
                  idx: Optional[Sequence[int]] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One round's tau local-epoch batches: x (K, tau, B, ...), y (K, tau,
    B). Each local epoch gets its own draw per client; tau=1 consumes
    exactly one ``client_batches`` draw."""
    draws = [client_batches(ds, parts, batch, rng, idx=idx)
             for _ in range(tau)]
    return (np.stack([d[0] for d in draws], axis=1),
            np.stack([d[1] for d in draws], axis=1))
