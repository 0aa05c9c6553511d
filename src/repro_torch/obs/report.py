"""Render a run summary from a telemetry JSONL file.

Usage::

    python -m repro_torch.obs.report run.jsonl [--run INDEX] [--json]

Reads the ``run_start`` / ``round`` / ``run_end`` event stream a
``Telemetry(jsonl=...)`` session appended (``repro_torch.obs.sink``) and
prints, for one run (default: the last):

* the host round-time breakdown (per-span totals from the tracer),
* comm / wall-clock totals and cache residency,
* per-metric stats with a unicode sparkline over rounds.

``--json`` dumps the parsed summary as JSON instead (CI assertions).
Exits non-zero only on unreadable input.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

SPARK = "▁▂▃▄▅▆▇█"


def parse_runs(path: str) -> List[dict]:
    """Group the JSONL event stream into runs.

    Each run is ``{"start": {...}|None, "rounds": [...], "end":
    {...}|None}``; events before the first ``run_start`` open an
    implicit run so truncated files still render.
    """
    runs: List[dict] = []

    def fresh(start=None):
        runs.append({"start": start, "rounds": [], "end": None})

    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad JSON line "
                                 f"({e})") from e
            kind = ev.get("kind")
            if kind == "run_start":
                fresh(ev)
            else:
                if not runs:
                    fresh()
                if kind == "round":
                    runs[-1]["rounds"].append(ev)
                elif kind == "run_end":
                    runs[-1]["end"] = ev
    return runs


def sparkline(values, width: int = 32) -> str:
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:                    # resample to `width` cells
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(SPARK[int((v - lo) / span * (len(SPARK) - 1))]
                   for v in vals)


def _fmt(v, nd=3):
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _metric_series(rounds: List[dict]) -> dict:
    """Column -> list over rounds, for the non-History metric columns."""
    skip = {"kind", "round", "evaluated"}
    series: dict = {}
    for ev in rounds:
        for k, v in ev.items():
            if k in skip:
                continue
            series.setdefault(k, []).append(v)
    return series


def summarize(run: dict) -> dict:
    """Parsed summary of one run (what ``--json`` prints)."""
    start = run["start"] or {}
    end = run["end"] or {}
    rounds = run["rounds"]
    out = {"policy": start.get("policy"),
           "num_clients": start.get("num_clients"),
           "level": start.get("level"),
           "rounds": end.get("rounds", len(rounds)),
           "final_acc": end.get("final_acc"),
           "comm_mb": end.get("comm_mb"),
           "wall_clock": end.get("wall_clock"),
           "spans": end.get("spans", {}),
           "transfer_stats": end.get("transfer_stats"),
           "metrics": {}}
    for name, vals in _metric_series(rounds).items():
        flat = [v for v in vals if isinstance(v, (int, float))
                and v == v]                          # scalar, non-NaN
        if len(flat) == len(vals) and flat:
            s = sorted(flat)
            out["metrics"][name] = {
                "last": flat[-1], "min": s[0], "max": s[-1],
                "median": s[len(s) // 2], "n": len(flat)}
        elif vals:
            out["metrics"][name] = {"last": vals[-1], "n": len(vals)}
    return out


def render(run: dict, file=None) -> None:
    file = file or sys.stdout
    p = lambda *a: print(*a, file=file)   # noqa: E731
    s = summarize(run)
    rounds = run["rounds"]
    p(f"run: policy={s['policy']} clients={s['num_clients']} "
      f"level={s['level']} rounds={s['rounds']}")
    if s["final_acc"] is not None:
        p(f"final: acc={_fmt(s['final_acc'])} "
          f"comm={_fmt(s['comm_mb'])} MB "
          f"wall={_fmt(s['wall_clock'])} s (simulated)")

    spans = s["spans"]
    if spans:
        p("\nround-time breakdown (host seams, wall seconds):")
        total = sum(v["total_s"] for v in spans.values())
        p(f"  {'span':<18} {'calls':>6} {'total_s':>9} {'mean_ms':>9} "
          f"{'share':>6}")
        for name, v in sorted(spans.items(),
                              key=lambda kv: -kv[1]["total_s"]):
            p(f"  {name:<18} {v['count']:>6} {v['total_s']:>9.4f} "
              f"{v['mean_s'] * 1e3:>9.3f} "
              f"{v['total_s'] / total * 100 if total else 0:>5.1f}%")

    ts = s["transfer_stats"]
    if ts:
        p("\ncache stream: "
          f"d2h={ts.get('d2h_async', 0)}x/{ts.get('d2h_bytes', 0)}B "
          f"h2d={ts.get('h2d_async', 0)}x/{ts.get('h2d_bytes', 0)}B "
          f"sync_copies={ts.get('sync_copies', 0)}")

    if s["metrics"]:
        p("\nper-round metrics:")
        p(f"  {'metric':<20} {'last':>10} {'min':>10} {'median':>10} "
          f"{'max':>10}  trend")
        series = _metric_series(rounds)
        for name in sorted(s["metrics"]):
            m = s["metrics"][name]
            if "min" in m:
                p(f"  {name:<20} {_fmt(m['last']):>10} "
                  f"{_fmt(m['min']):>10} {_fmt(m['median']):>10} "
                  f"{_fmt(m['max']):>10}  {sparkline(series[name])}")
            else:
                p(f"  {name:<20} last={m['last']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("jsonl", help="telemetry JSONL file")
    ap.add_argument("--run", type=int, default=-1,
                    help="run index in the file (default: last)")
    ap.add_argument("--json", action="store_true",
                    help="print the parsed summary as JSON")
    args = ap.parse_args(argv)
    try:
        runs = parse_runs(args.jsonl)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not runs:
        print(f"error: no telemetry events in {args.jsonl}",
              file=sys.stderr)
        return 1
    try:
        run = runs[args.run]
    except IndexError:
        print(f"error: run index {args.run} out of range "
              f"({len(runs)} runs)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summarize(run), indent=1, default=float))
    else:
        render(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
