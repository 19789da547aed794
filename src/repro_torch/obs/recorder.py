"""Metrics core: counters / gauges / spans -> buffered JSONL + manifest.

A copy of ``repro.obs.recorder`` with the same event schema
(``repro.obs.v1`` -- one JSON object per line, DESIGN.md §14): every
record carries ``seq`` (monotonic), ``ts`` (unix seconds), ``kind``,
``name`` and ``round`` (the recorder's current round scope, ``None``
outside one), plus kind-specific fields:

=========  ==============================================================
kind       fields
=========  ==============================================================
counter    ``value`` (the increment) -- totals land in the ``summary``
gauge      ``value``
span       ``dur_s``, ``depth``, ``parent`` (closing-time emission)
event      free-form payload (``traffic``, ``serve_token``,
           ``serve_summary`` ...)
log        ``msg`` (the stderr text sink's mirror)
summary    final counter totals, written on close
=========  ==============================================================

The port runs eagerly, so values reach the recorder by plain host calls:
there is no emit path from inside a compiled graph. The manifest names
the torch version and the device in place of the reference's jax fields.

While a ``torch.profiler`` runs, every span -- the Null recorder's too --
also opens the profiler range ``repro_torch.<name>``, so a device trace
puts each kernel, copy and idle gap down to the program's spans on the
profiler's own clock. With the profiler off a span costs one check, and
the Null recorder's stays the shared no-op.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.obs.ledger import TrafficLedger

SCHEMA = "repro.obs.v1"
EVENTS_FILE = "events.jsonl"
MANIFEST_FILE = "manifest.json"


def _json_safe(v: Any):
    """JSON has no inf/nan; don't let one non-finite latency corrupt a
    line for every downstream reader."""
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:  # np scalars
        return _json_safe(v.item())
    return v


def git_sha() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=5,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def config_hash(config: Dict) -> str:
    blob = json.dumps(_json_safe(config), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def build_manifest(config: Optional[Dict] = None) -> Dict:
    """The per-run provenance header: enough to compare two runs'
    JSONLs without guessing what produced them."""
    import torch

    man = {
        "schema": SCHEMA,
        "started": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "argv": sys.argv,
        "git_sha": git_sha(),
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "torch_version": torch.__version__,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count(),
        "device_name": (torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else None),
    }
    if config is not None:
        man["config"] = _json_safe(config)
        man["config_hash"] = config_hash(config)
    return man


PROFILER_PREFIX = "repro_torch."


def _profiler_range(name: str):
    """``torch.profiler.record_function("repro_torch." + name)`` while a
    profiler runs in this thread (the autograd engine's threads inherit
    it), else None. Never imports torch: with torch not imported no
    profiler can run."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    return torch.profiler.record_function(PROFILER_PREFIX + name)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The disabled default: every method a no-op. Keeps the stderr text
    sink so ``obs.log`` works metrics-off too."""

    enabled = False
    ledger = None

    def __init__(self):
        self.quiet = False

    # -- no-op metric surface -------------------------------------------
    def set_round(self, t):
        pass

    def span(self, name, **attrs):
        rng = _profiler_range(name)
        return _NULL_SPAN if rng is None else rng

    def counter(self, name, value=1, **attrs):
        pass

    def gauge(self, name, value, **attrs):
        pass

    def event(self, kind, name=None, **fields):
        pass

    def tap_bits(self, category, bits):
        pass

    def flush(self):
        pass

    def close(self):
        pass

    # -- text sink -------------------------------------------------------
    def log(self, msg: str) -> None:
        if not self.quiet:
            print(msg, file=sys.stderr, flush=True)


null_recorder = NullRecorder()


class _Span:
    __slots__ = ("rec", "name", "attrs", "t0", "parent", "depth", "rng")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        st = self.rec._span_stack
        self.parent = st[-1] if st else None
        self.depth = len(st)
        st.append(self.name)
        self.rng = _profiler_range(self.name)
        if self.rng is not None:
            self.rng.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(*exc)
        self.rec._span_stack.pop()
        self.rec._emit(dict(kind="span", name=self.name, dur_s=dur,
                            depth=self.depth, parent=self.parent,
                            **self.attrs))
        return False


class Recorder:
    """The enabled recorder: JSONL event sink + manifest + traffic ledger.

    ``metrics_dir=None`` keeps everything in memory (``self.events``) --
    what the tests use; with a directory, events stream to
    ``events.jsonl`` (``append=True`` continues a resumed run's file
    and keeps its manifest).
    """

    enabled = True

    def __init__(self, metrics_dir: Optional[str] = None, *,
                 config: Optional[Dict] = None, quiet: bool = False,
                 append: bool = False, flush_every: int = 256,
                 keep_events: Optional[bool] = None):
        self.metrics_dir = metrics_dir
        self.quiet = quiet
        self.ledger = TrafficLedger()
        self.events = []  # in-memory mirror (always on when no dir)
        self._keep = keep_events if keep_events is not None \
            else metrics_dir is None
        self._lock = threading.Lock()
        self._buf = []
        self._flush_every = max(1, flush_every)
        self._seq = 0
        self._round = None
        self._span_stack = []
        self._counters: Dict[str, float] = {}
        self._fh = None
        self.manifest = build_manifest(config)
        if metrics_dir is not None:
            os.makedirs(metrics_dir, exist_ok=True)
            man_path = os.path.join(metrics_dir, MANIFEST_FILE)
            if not (append and os.path.exists(man_path)):
                with open(man_path, "w") as f:
                    json.dump(self.manifest, f, indent=2, sort_keys=True)
            self._fh = open(os.path.join(metrics_dir, EVENTS_FILE),
                            "a" if append else "w")

    # ------------------------------------------------------------------
    def set_round(self, t: Optional[int]) -> None:
        """Round scope: every event until the next call is tagged with
        ``round = t`` (None leaves events unscoped)."""
        self._round = None if t is None else int(t)

    @property
    def round(self) -> Optional[int]:
        return self._round

    # ------------------------------------------------------------------
    def _emit(self, rec: Dict) -> None:
        with self._lock:
            rec.setdefault("round", self._round)
            rec["seq"] = self._seq
            self._seq += 1
            rec["ts"] = time.time()
            rec = _json_safe(rec)
            if self._keep:
                self.events.append(rec)
            if self._fh is not None:
                self._buf.append(json.dumps(rec))
                if len(self._buf) >= self._flush_every:
                    self._flush_locked()

    def _flush_locked(self) -> None:
        if self._fh is not None and self._buf:
            self._fh.write("\n".join(self._buf) + "\n")
            self._fh.flush()
        self._buf = []

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._counters:
                self._buf.append(json.dumps(_json_safe(
                    {"kind": "summary", "seq": self._seq,
                     "ts": time.time(), "round": None,
                     "counters": dict(self._counters)})))
                if self._keep:
                    self.events.append(json.loads(self._buf[-1]))
                self._seq += 1
            self._flush_locked()
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # ------------------------------------------------------------------
    def counter(self, name: str, value=1, **attrs) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value
        self._emit(dict(kind="counter", name=name, value=value, **attrs))

    def gauge(self, name: str, value, **attrs) -> None:
        self._emit(dict(kind="gauge", name=name, value=value, **attrs))

    def event(self, kind: str, name: Optional[str] = None, **fields) -> None:
        self._emit(dict(kind=kind, name=name, **fields))

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def log(self, msg: str) -> None:
        if not self.quiet:
            print(msg, file=sys.stderr, flush=True)
        self._emit({"kind": "log", "name": "log", "msg": msg})

    def tap_bits(self, category: str, bits: int) -> None:
        """Add ``bits`` that crossed a boundary to the traffic ledger.
        Called by the host code that ran the transport op, once per real
        execution (the reference stages the same add as a jit callback)."""
        bits = int(bits)
        if bits > 0:
            self.ledger.add(category, bits)


def read_events(metrics_dir: str):
    """Decode ``events.jsonl`` (skipping blank/corrupt lines) -> list."""
    path = os.path.join(metrics_dir, EVENTS_FILE)
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def read_manifest(metrics_dir: str) -> Optional[Dict]:
    """Decode ``manifest.json``, or None when the run wrote none."""
    path = os.path.join(metrics_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
