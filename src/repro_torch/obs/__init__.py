"""Observability subsystem: a copy of ``repro.obs`` (DESIGN.md §14).

One process-wide *active recorder* -- :class:`NullRecorder` by default,
every operation a no-op -- that launchers swap for a real
:class:`Recorder` (``--metrics-dir``). Instrumented code holds whatever
recorder was active when it was built.

* **recorder** -- counters / gauges / events + wall-clock spans, buffered
  to a JSONL event sink with a per-run ``manifest.json`` (config hash,
  git SHA, torch version, device).
* **ledger** -- the traffic ledger: actual bits crossing each protocol
  boundary, added by the host code that ran the transport op and
  reconciled per step against ``sysmodel.traffic``; any divergence is a
  pricing bug.

The event schema is the reference's (``repro.obs.v1``): the port's
report CLI, ``python -m repro_torch.obs.report RUN_DIR`` (``report``),
and the reference's render and reconcile a port run's metrics directory
alike.

``obs.span(name)`` is the active recorder's span: a timed JSONL event
under a real recorder, and under ``torch.profiler`` also the range
``repro_torch.<name>`` on the device trace's clock (``recorder``).

``obs.counter(name, value)`` adds to the active recorder's counter;
``obs.takes_counters()`` says whether it keeps them, so that a value
that costs device work is made only then. A value may be a device
tensor: a JSONL recorder reads it, an in-memory one may keep it there.

``obs.log(msg)`` is the uniform stderr text sink: it honors ``--quiet``,
keeps stdout parseable, and (when metrics are on) mirrors the line into
the event stream.
"""
from __future__ import annotations

from repro_torch.obs.ledger import LEDGER_CATEGORIES, TrafficLedger, reconcile
from repro_torch.obs.recorder import NullRecorder, Recorder, null_recorder
from repro_torch.obs.stats import percentile

_active = null_recorder


def get_recorder():
    """The process-wide active recorder (NullRecorder unless a launcher
    or test installed a real one)."""
    return _active


def set_recorder(rec) -> None:
    global _active
    _active = rec if rec is not None else null_recorder


class use_recorder:
    """Context manager installing ``rec`` as the active recorder (tests)."""

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self._prev = get_recorder()
        set_recorder(self.rec)
        return self.rec

    def __exit__(self, *exc):
        set_recorder(self._prev)
        return False


def span(name: str, **attrs):
    """The active recorder's span ``name`` (a context manager)."""
    return _active.span(name, **attrs)


def counter(name: str, value=1, **attrs) -> None:
    """The active recorder's counter ``name`` += ``value``."""
    _active.counter(name, value, **attrs)


def takes_counters() -> bool:
    """Whether the active recorder keeps counters (the Null recorder's
    drop them): a counter whose value costs device work is computed only
    then."""
    return type(_active).counter is not NullRecorder.counter


def set_quiet(quiet: bool = True) -> None:
    """Silence (or re-enable) the stderr text sink on every recorder --
    including the Null default, so ``--quiet`` works without metrics."""
    null_recorder.quiet = bool(quiet)
    _active.quiet = bool(quiet)


def log(msg: str) -> None:
    """Progress line -> stderr (honoring ``--quiet``) and, when metrics
    are enabled, the event stream."""
    _active.log(msg)


__all__ = [
    "LEDGER_CATEGORIES", "NullRecorder", "Recorder", "TrafficLedger",
    "counter", "get_recorder", "log", "null_recorder", "percentile",
    "reconcile", "set_quiet", "set_recorder", "span", "takes_counters",
    "use_recorder",
]
