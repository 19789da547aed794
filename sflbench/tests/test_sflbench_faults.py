"""A whole run on the CPU (the look for a card skipped), with the port's
timed path broken underneath: ``correct`` comes out false for every
fault a training cell can have, and true for the unbroken path.

The faults: a step that returns its state unchanged; half of the batch
left out of the loss, the mean taken over the rest; the exchange at the
cut left out (eq. 5's aggregation skipped: each client keeps its own
cotangent). The cells run on one card, so no exchange between cards
exists to leave out, and a training step produces no token to alter.
"""
import pytest

from conftest import tiny_cell
from harness import program, session, spec

CELLS = ("granite8b-4l.sflga-fp32-s1024",
         "mamba2-130m.sflga-fp32-b2-s1024",
         "granite8b-4l.sflga-int8-cutmig-s1024")


def _frozen(monkeypatch):
    from repro_torch.core import algorithms as alg

    real = alg.make_train_step

    def make(*a, **k):
        step = real(*a, **k)

        def frozen(params, opt_state, batch):
            _, _, m = step(params, opt_state, batch)
            return params, opt_state, m

        return frozen

    monkeypatch.setattr(alg, "make_train_step", make)


def _half_batch(monkeypatch):
    from repro_torch.models import lm

    real = lm.cross_entropy

    def half(logits, labels, *a, **k):
        rows = logits.shape[0] // 2
        return real(logits[:rows], labels[:rows], *a, **k)

    monkeypatch.setattr(lm, "cross_entropy", half)


def _no_exchange(monkeypatch):
    from repro_torch.core import gradagg

    monkeypatch.setattr(gradagg, "_aggregate_broadcast",
                        lambda g, rho, codec=None, seed=0: g)


FAULTS = {"state_unchanged": _frozen, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


def _run(name):
    return session.run_cell(tiny_cell(spec.cell(name)), 2 ** 31 + 99, 0.3,
                            False, "cpu", log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] is True, r["check"]
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, monkeypatch):
    program.import_program()
    FAULTS[fault](monkeypatch)
    r = _run(name)
    assert r["correct"] is False, r["check"]
