"""The inputs of a run, made from ``--seed`` by the benchmark itself.

* :func:`token_batches` -- a frozen copy of the port's synthetic token
  stream (``repro_torch.data.synthetic_token_batches``): next token =
  (3 tok + 7) mod vocab with probability 0.8, else a Zipf draw. Every
  step's rows differ; the same seed gives the same batches.
* :func:`round_seed` -- the per-step uint32 codec seed, the port's
  ``core.protocol.round_seed`` formula.
* :class:`CutSchedule` -- the cut each step runs at: the set-up's own
  list of cuts, then the window's cycle, each cut held for
  ``steps_per_cut`` steps. It depends on no seed.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np

ROUND_SEED_STRIDE = 1000003
_U32 = 0xFFFFFFFF


def numpy_seed(seed: int) -> int:
    """``--seed`` (any whole number) as a ``RandomState`` seed."""
    return int(seed) % (2 ** 32)


def token_batches(vocab: int, batch: int, seq: int, seed: int,
                  zipf_a: float = 1.2
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite iterator of (tokens, labels), each (batch, seq) int32."""
    rng = np.random.RandomState(numpy_seed(seed))
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


def round_seed(base_seed: int, t: int) -> int:
    """uint32 codec seed of step ``t``."""
    return (int(base_seed) + int(t) * ROUND_SEED_STRIDE) & _U32


class CutSchedule:
    """Set-up steps run at ``setup_cuts`` in turn; window step ``i`` runs
    at ``cycle[(i // steps_per_cut) % len(cycle)]``."""

    def __init__(self, setup_cuts: Sequence[int], cycle: Sequence[int],
                 steps_per_cut: int):
        if not setup_cuts or not cycle or steps_per_cut < 1:
            raise ValueError("a schedule needs set-up cuts, a cycle and "
                             "steps_per_cut >= 1")
        self.setup_cuts = tuple(int(v) for v in setup_cuts)
        self.cycle = tuple(int(v) for v in cycle)
        self.steps_per_cut = int(steps_per_cut)

    @classmethod
    def of(cls, traffic: dict) -> "CutSchedule":
        return cls(traffic["setup_cuts"], traffic["cut_cycle"],
                   traffic["steps_per_cut"])

    @property
    def cuts(self) -> tuple:
        return tuple(sorted(set(self.setup_cuts) | set(self.cycle)))

    def window_cut(self, i: int) -> int:
        return self.cycle[(i // self.steps_per_cut) % len(self.cycle)]
