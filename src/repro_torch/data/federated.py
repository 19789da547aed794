"""Federated data partitioning: a numpy copy of the parts of
``repro.data.federated`` that the paper's main path uses.

``iid_partition`` returns per-client index arrays; ``client_batches``
builds one round's mini-batch tensor (K, B, ...) for the simulator and
``round_batches`` the tau local epochs of it; ``rho_weights`` gives the
paper's rho^n = D^n / D aggregation weights (eq. 5). The same seeds draw
the same batches as the reference.
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


def rho_weights(parts: List[np.ndarray]) -> np.ndarray:
    """rho^n = D^n / D (eq. 5)."""
    d = np.asarray([len(p) for p in parts], np.float64)
    return (d / d.sum()).astype(np.float32)


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
