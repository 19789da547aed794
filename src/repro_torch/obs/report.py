"""``python -m repro_torch.obs.report RUN_DIR`` — render a run's JSONL.

Sections (each skipped when the run produced no matching events):

* manifest summary (schema, git SHA, backend, config hash)
* round timeline — per-round wall-clock broken into top-level spans,
  with loss and cut when the run recorded them
* traffic reconciliation — measured ledger vs ``sysmodel/traffic``
  prediction per round (and migration events), per-category deltas for
  any mismatch. **Exit code 1 on any mismatch** — this is the CI
  contract: a red report means a pricing bug, not a style issue.
* cohort summary (participation counts, HT-weight stats, replacement)
* async engine summary (merge cadence on the virtual clock, queue-depth
  and staleness gauges) — async per-merge traffic events are ordinary
  ``traffic`` events, so they sit under the same exit-1 gate
* DDQN summary (per-episode reward/ε/loss + reward decomposition)
* serve per-token latency (p50/p99)

Port of ``repro.obs.report``: the same sections, text and exit codes
for the same directory. The module is stdlib only (the package's
``__init__`` still loads torch); it reads the JSONL that
:mod:`repro_torch.obs.recorder` or the reference's recorder writes. The
manifest keys are the reference's, so the port's ``torch_version`` is
not shown.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.ledger import reconcile_events, totals
from repro_torch.obs.stats import percentile as _pct


def _fmt_bits(bits) -> str:
    try:
        bits = float(bits)
    except (TypeError, ValueError):
        return str(bits)
    for unit, scale in (("Gb", 1e9), ("Mb", 1e6), ("kb", 1e3)):
        if abs(bits) >= scale:
            return f"{bits / scale:.3f} {unit}"
    return f"{int(bits)} b"


def _fmt_bytes(b) -> str:
    try:
        b = float(b)
    except (TypeError, ValueError):
        return str(b)
    for unit, scale in (("GB", 1e9), ("MB", 1e6), ("kB", 1e3)):
        if abs(b) >= scale:
            return f"{b / scale:.3f} {unit}"
    return f"{int(b)} B"


def _fmt_s(sec) -> str:
    try:
        sec = float(sec)
    except (TypeError, ValueError):
        return str(sec)
    if sec >= 1.0:
        return f"{sec:.2f} s"
    return f"{sec * 1e3:.1f} ms"


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    for r in rows:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(str(cell)))
    def line(cells):
        return "  ".join(str(c).rjust(w) for c, w in zip(cells, widths))
    out = [line(headers), line("-" * w for w in widths)]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


# ----------------------------------------------------------------------
def render_manifest(manifest: Optional[Dict]) -> str:
    if not manifest:
        return "manifest: (none)"
    keys = ("schema", "started", "git_sha", "backend", "jax_version",
            "platform", "config_hash")
    lines = ["== manifest =="]
    for k in keys:
        if manifest.get(k) is not None:
            lines.append(f"  {k:12s} {manifest[k]}")
    cfg = manifest.get("config")
    if isinstance(cfg, dict):
        brief = {k: cfg[k] for k in sorted(cfg) if not isinstance(
            cfg[k], (dict, list))}
        lines.append("  config       " + json.dumps(brief, sort_keys=True))
    return "\n".join(lines)


def render_timeline(events: List[dict], max_rows: int = 40) -> Optional[str]:
    """Per-round wall-clock: the ``round`` span plus its direct children,
    joined with per-round loss/cut gauges when present."""
    rounds: Dict[int, Dict] = defaultdict(lambda: {"spans": {}, "info": {}})
    for ev in events:
        t = ev.get("round")
        if t is None:
            continue
        if ev.get("kind") == "span":
            name, dur = ev.get("name"), ev.get("dur_s", 0.0)
            cur = rounds[t]["spans"]
            cur[name] = cur.get(name, 0.0) + float(dur)
        elif ev.get("kind") == "round":
            rounds[t]["info"].update(
                {k: v for k, v in ev.items()
                 if k in ("loss", "cut", "latency_modeled",
                          "latency_measured", "participants")})
    if not rounds:
        return None
    span_names: List[str] = []
    for r in rounds.values():
        for n in r["spans"]:
            if n not in span_names:
                span_names.append(n)
    span_names.sort(key=lambda n: (n != "round", n))
    info_keys = sorted({k for r in rounds.values() for k in r["info"]})
    headers = ["round"] + span_names + info_keys
    keys = sorted(rounds)
    shown = keys if len(keys) <= max_rows else keys[:max_rows // 2] + \
        keys[-max_rows // 2:]
    rows, prev = [], None
    for t in shown:
        if prev is not None and t != prev + 1:
            rows.append(["..."] * len(headers))
        prev = t
        r = rounds[t]
        row = [t]
        for n in span_names:
            row.append(_fmt_s(r["spans"][n]) if n in r["spans"] else "-")
        for k in info_keys:
            v = r["info"].get(k, "-")
            if isinstance(v, float):
                v = f"{v:.4g}"
            row.append(v)
        rows.append(row)
    return "== round timeline ==\n" + _table(headers, rows)


def render_reconciliation(events: List[dict]) -> (Optional[str], int):
    rows, bad = reconcile_events(events)
    if not rows:
        return None, 0
    headers = ["kind", "round", "scheme", "cut", "measured", "modeled", "ok"]
    tab = []
    for r in rows:
        tab.append([
            r["kind"], r.get("round", "-"), r.get("scheme") or "-",
            r.get("cut") if r.get("cut") is not None else "-",
            _fmt_bits(r["measured"].get("total_bits")),
            _fmt_bits(r["modeled"].get("total_bits")),
            "MISMATCH" if r["mismatches"] else "ok",
        ])
    lines = ["== traffic reconciliation (measured ledger vs "
             "sysmodel/traffic) ==", _table(headers, tab)]
    from repro_torch.sysmodel.payload import kind_for_category

    for r in rows:
        for m in r["mismatches"]:
            lines.append(
                f"  !! round {r.get('round')} {r['kind']} "
                f"[{m['category']}: {kind_for_category(m['category'])}]: "
                f"measured {m['measured_bits']} b != "
                f"modeled {m['modeled_bits']} b "
                f"(delta {m['delta_bits']:+d} b)")
    # Name the adapter flows when a PEFT run priced them, so the traffic
    # section says what kind of payload those bytes were.
    adapter_bits = sum(
        int((e.get("measured") or {}).get(c, 0))
        for e in events if e.get("kind") == "traffic"
        for c in ("up_adapter", "down_adapter"))
    if adapter_bits:
        lines.append(f"  adapter payloads: {_fmt_bits(adapter_bits)} "
                     f"({kind_for_category('up_adapter')})")
    n_ok = len(rows) - bad
    lines.append(f"  {n_ok}/{len(rows)} events reconcile exactly"
                 + ("" if not bad else f"; {bad} MISMATCHED — pricing bug"))
    return "\n".join(lines), bad


def render_cohort(events: List[dict]) -> Optional[str]:
    evs = [e for e in events if e.get("kind") == "cohort"]
    if not evs:
        return None
    counts: Dict[int, int] = defaultdict(int)
    w_sums, repl = [], []
    for e in evs:
        for i in e.get("participants", []):
            counts[int(i)] += 1
        if e.get("w_sum") is not None:
            w_sums.append(float(e["w_sum"]))
        if e.get("replacement_fraction") is not None:
            repl.append(float(e["replacement_fraction"]))
    lines = ["== cohort =="]
    n_rounds = sum(1 for e in evs if e.get("participants")) or len(evs)
    lines.append(f"  rounds observed      {n_rounds}")
    if counts:
        per = sorted(counts.values())
        lines.append(f"  distinct clients     {len(counts)}")
        lines.append(f"  participation/client min {per[0]}  "
                     f"median {per[len(per) // 2]}  max {per[-1]}")
    if w_sums:
        lines.append(f"  HT weight sum        mean {sum(w_sums) / len(w_sums):.4f}"
                     f"  min {min(w_sums):.4f}  max {max(w_sums):.4f}")
    if repl:
        lines.append(f"  replacement fraction mean {sum(repl) / len(repl):.4f}")
    return "\n".join(lines)


def render_ddqn(events: List[dict], max_rows: int = 12) -> Optional[str]:
    eps = [e for e in events if e.get("kind") == "ddqn_episode"]
    if not eps:
        return None
    headers = ["episode", "reward", "latency", "eps", "td_loss",
               "gamma_conv", "gamma_dist", "chi", "psi", "penalties"]
    shown = eps if len(eps) <= max_rows else eps[:max_rows // 2] + \
        eps[-max_rows // 2:]
    rows, skipped = [], len(eps) - len(shown)
    for e in shown:
        rows.append([
            e.get("episode", "-"),
            f"{e['reward']:.4f}" if e.get("reward") is not None else "-",
            f"{e['latency']:.4f}" if e.get("latency") is not None else "-",
            f"{e['eps']:.3f}" if e.get("eps") is not None else "-",
            f"{e['td_loss']:.3e}" if e.get("td_loss") is not None else "-",
            f"{e['gamma_conv']:.4f}" if e.get("gamma_conv") is not None else "-",
            f"{e['gamma_dist']:.4f}" if e.get("gamma_dist") is not None else "-",
            f"{e['chi']:.4f}" if e.get("chi") is not None else "-",
            f"{e['psi']:.4f}" if e.get("psi") is not None else "-",
            e.get("penalties", "-"),
        ])
    title = "== DDQN episodes =="
    if skipped:
        title += f" (showing {len(shown)}/{len(eps)})"
    return title + "\n" + _table(headers, rows)


def render_bank(events: List[dict]) -> Optional[str]:
    """Client-bank residency: backend, O(N) bank vs peak device bytes,
    prefetch hit rate (DESIGN.md §15). Reads the end-of-run ``bank``
    event; falls back to per-round ``bank`` snapshots for the peak."""
    banks = [e for e in events if e.get("kind") == "bank"]
    snaps = [e["bank"] for e in events
             if e.get("kind") == "round" and isinstance(e.get("bank"), dict)]
    if not banks and not snaps:
        return None
    st = dict(banks[-1]) if banks else dict(snaps[-1])
    if snaps:  # the true high-water mark across rounds
        st["device_bytes_peak"] = max(
            [s.get("device_bytes_peak", 0) for s in snaps]
            + [st.get("device_bytes_peak", 0)])
    lines = ["== client bank =="]
    lines.append(f"  backend              {st.get('backend', '?')}")
    bank_b = st.get("bank_bytes")
    if bank_b is not None:
        lines.append(f"  bank bytes (O(N))    {_fmt_bytes(bank_b)}")
    peak = st.get("device_bytes_peak")
    if peak is not None:
        lines.append(f"  peak device bytes    {_fmt_bytes(peak)}")
    hits = int(st.get("prefetch_hits", 0))
    miss = int(st.get("prefetch_misses", 0))
    if hits or miss:
        lines.append(f"  prefetch             {hits} hits / {miss} misses"
                     f"  gather wait {_fmt_s(st.get('gather_wait_s', 0.0))}")
    return "\n".join(lines)


def render_async(events: List[dict]) -> Optional[str]:
    """Event-engine summary (DESIGN.md §16): merge cadence on the
    virtual clock, queue-depth/staleness gauges, degenerate-sync count.
    The engine's per-merge traffic events are plain ``traffic`` events,
    so the reconciliation gate above already fails CI when the async
    measured wire diverges from ``sysmodel/traffic``."""
    merges = [e for e in events
              if e.get("kind") == "async" and e.get("name") == "merge"]
    depth = [float(e["value"]) for e in events
             if e.get("kind") == "gauge"
             and e.get("name") == "async_queue_depth"]
    stale = [float(e["value"]) for e in events
             if e.get("kind") == "gauge"
             and e.get("name") == "async_staleness"]
    if not merges and not depth and not stale:
        return None
    lines = ["== async engine =="]
    if merges:
        clock = max(float(e.get("clock", 0.0)) for e in merges)
        sizes = [int(e.get("merged", 0)) for e in merges]
        dispatched = sum(len(e.get("dispatched") or []) for e in merges)
        lines.append(f"  merges               {len(merges)}  "
                     f"(buffer sizes min {min(sizes)} / max {max(sizes)}; "
                     f"{dispatched} generations dispatched)")
        lines.append(f"  virtual clock        {_fmt_s(clock)}")
    if depth:
        lines.append(f"  queue depth          mean "
                     f"{sum(depth) / len(depth):.2f}  max {max(depth):.0f}")
    if stale:
        lines.append(f"  staleness (merges)   mean "
                     f"{sum(stale) / len(stale):.2f}  max {max(stale):.2f}")
    return "\n".join(lines)


def render_serve(events: List[dict]) -> Optional[str]:
    """Serving engine summary (DESIGN.md §18): per-step decode latency,
    batch occupancy and page usage from ``serve_token`` events, plus the
    end-to-end ``serve_summary`` (step wall-clock + modeled comm)."""
    toks = [e for e in events if e.get("kind") == "serve_token"]
    summaries = [e for e in events if e.get("kind") == "serve_summary"]
    if not toks and not summaries:
        return None
    lines = ["== serving =="]
    by_model: Dict[str, List[dict]] = defaultdict(list)
    for e in toks:
        by_model[e.get("model") or "?"].append(e)
    for model, evs in sorted(by_model.items()):
        lat = [float(e.get("latency_s", 0.0)) for e in evs]
        batch = [int(e.get("batch", 0)) for e in evs]
        lines.append(
            f"  {model}: {len(evs)} steps  "
            f"step p50 {_fmt_s(_pct(lat, 0.50))}  p99 {_fmt_s(_pct(lat, 0.99))}  "
            f"mean {_fmt_s(sum(lat) / len(lat))}")
        lines.append(
            f"    occupancy mean {sum(batch) / len(batch):.2f} slots  "
            f"admitted {sum(int(e.get('admitted', 0)) for e in evs)}  "
            f"retired {sum(int(e.get('retired', 0)) for e in evs)}"
            + (f"  peak pages {max(int(e.get('pages_in_use', 0)) for e in evs)}"
               if any("pages_in_use" in e for e in evs) else ""))
    for s in summaries:
        line = (f"  summary [{s.get('model', '?')}]: {s.get('users', '?')} "
                f"users  {s.get('tokens', '?')} tokens  "
                f"{float(s.get('tok_per_s', 0.0)):.1f} tok/s  "
                f"token p50 {_fmt_s(s.get('p50_s'))}  "
                f"p99 {_fmt_s(s.get('p99_s'))}")
        if s.get("slo_attainment") is not None:
            line += f"  SLO {float(s['slo_attainment']):.1%}"
        lines.append(line)
    return "\n".join(lines)


def render_report(events: List[dict],
                  manifest: Optional[Dict] = None) -> (str, int):
    """Full report text + number of reconciliation mismatches."""
    sections = [render_manifest(manifest)]
    sections.append(render_timeline(events))
    recon, bad = render_reconciliation(events)
    sections.append(recon)
    sections.append(render_cohort(events))
    sections.append(render_async(events))
    sections.append(render_bank(events))
    sections.append(render_ddqn(events))
    sections.append(render_serve(events))
    n = sum(1 for _ in events)
    sections.append(f"{n} events total")
    return "\n\n".join(s for s in sections if s), bad


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a metrics run directory (exit 1 on any "
                    "traffic-reconciliation mismatch).")
    ap.add_argument("run_dir", help="directory with events.jsonl/manifest.json")
    ap.add_argument("--strict", action="store_true",
                    help="also exit non-zero when the run has no traffic "
                         "events at all")
    args = ap.parse_args(list(argv) if argv is not None else None)

    from repro_torch.obs.recorder import read_events, read_manifest

    events_path = os.path.join(args.run_dir, "events.jsonl")
    if not os.path.exists(events_path):
        print(f"error: {events_path} not found", file=sys.stderr)
        return 2
    events = read_events(args.run_dir)
    manifest = read_manifest(args.run_dir)
    text, bad = render_report(events, manifest)
    print(text)
    if bad:
        print(f"\nRECONCILIATION FAILED: {bad} mismatched events",
              file=sys.stderr)
        return 1
    if args.strict and not any(
            e.get("kind") in ("traffic", "migration") for e in events):
        print("\nerror: --strict and no traffic/migration events",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
