"""Summarise an obs run directory (trace.json + metrics.jsonl) as text.

    PYTHONPATH=src python -m repro_torch.launch.obs_report experiments/obs

Five sections, each skipped gracefully when its inputs are absent:

  * **top spans** -- wall time by span name (count / total / mean / max),
    from the Chrome-trace ``"ph": "X"`` events;
  * **async overlap** -- how much of each sweep the host spent free while
    the device sampled (``exec.sweep`` spans' ``overlap_pct``, i.e.
    ``1 - dispatch/total``) -- the executor's issue->overlap->await
    efficiency;
  * **push routes** -- per-``PushRoute`` cost table from the ``ps.push``
    spans: calls, mean ms, and the traffic shape the route planned
    (dense bytes vs COO bytes), paper section 3.3's dense/hybrid/COO
    trade made measurable;
  * **tiered storage** -- residency state of the device hot-row cache
    (``ps.tier.*`` gauges) and the H2D cost of cold misses
    (``tier.miss_fetch`` spans), present only for ``storage="tiered"``
    runs;
  * **network** -- the RPC transport's per-op cost table from the
    ``ps.rpc.*`` counters (calls, bytes out/in per wire op) plus the
    fault-tolerance tallies (retries, reconnects), present only for
    ``backend="net"`` runs (DESIGN.md section 15); per-op latency
    distributions appear with the other ``ps.rpc.ms.*`` histograms;
  * **serving latency** -- p50/p90/p95/p99 for every ``serve.*`` (and any
    other) histogram in the metrics dump -- the SLO view over
    ``QueryEngine`` requests;
  * **serving admission** -- the concurrent plane's outcome mix (DESIGN.md
    section 14): dual-trigger flush reasons (``serve.batch_trigger.*``),
    typed sheds (``serve.shed``), batch errors, and the live-refresh
    staleness gauge (``serve.version_lag``).

``render(trace_dir)`` returns the report string (used by tests and
``chip_smoke.py``); ``main()`` prints it.  The text is the JAX package's
``launch.obs_report`` text, line for line, so a directory written by either
package renders the same in both.  It reads files on the host only.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.obs.metrics import load_jsonl


def load_trace(path: str) -> List[dict]:
    """The trace's event list ([] when the file is missing/empty)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        doc = json.load(f)
    return doc.get("traceEvents", [])


def _fmt_ms(ms: float) -> str:
    return f"{ms:10.3f}"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:8.1f} {unit}"
        n /= 1024.0
    return f"{n:8.1f} GiB"


def span_rows(events: List[dict], top: int = 15) -> List[dict]:
    """Aggregate complete events by span name, ordered by total time."""
    agg: Dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        row = agg.setdefault(ev["name"], {"name": ev["name"], "count": 0,
                                          "total_ms": 0.0, "max_ms": 0.0})
        dur_ms = ev.get("dur", 0.0) / 1e3
        row["count"] += 1
        row["total_ms"] += dur_ms
        row["max_ms"] = max(row["max_ms"], dur_ms)
    rows = sorted(agg.values(), key=lambda r: -r["total_ms"])[:top]
    for r in rows:
        r["mean_ms"] = r["total_ms"] / r["count"]
    return rows


def overlap_stats(events: List[dict]) -> Optional[dict]:
    """Mean/min/max overlap efficiency over the run's exec.sweep spans."""
    pcts = [ev["args"]["overlap_pct"] for ev in events
            if ev.get("ph") == "X" and ev.get("name") == "exec.sweep"
            and "overlap_pct" in ev.get("args", {})]
    if not pcts:
        return None
    return {"sweeps": len(pcts), "mean": sum(pcts) / len(pcts),
            "min": min(pcts), "max": max(pcts)}


def route_rows(events: List[dict]) -> List[dict]:
    """Per-route ps.push cost table (calls, time, planned traffic)."""
    agg: Dict[str, dict] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != "ps.push":
            continue
        args = ev.get("args", {})
        route = args.get("route", "?")
        row = agg.setdefault(route, {"route": route, "calls": 0,
                                     "total_ms": 0.0, "batch": 0,
                                     "dense_bytes": 0, "coo_bytes": 0})
        row["calls"] += 1
        row["total_ms"] += ev.get("dur", 0.0) / 1e3
        row["batch"] += args.get("batch", 0)
        row["dense_bytes"] += args.get("dense_bytes", 0)
        row["coo_bytes"] += args.get("coo_bytes", 0)
    rows = sorted(agg.values(), key=lambda r: r["route"])
    for r in rows:
        r["mean_ms"] = r["total_ms"] / r["calls"]
    return rows


def tier_stats_rows(events: List[dict],
                    metrics: List[dict]) -> Optional[dict]:
    """Tiered-storage summary: miss-fetch traffic + ps.tier.* gauges.

    ``tier.miss_fetch`` spans carry the H2D bytes paid per cold pull;
    the ``ps.tier.*`` gauges carry the last observed residency state
    (hit rate, hot rows, device bytes, evictions).  None when the run
    never touched tiered storage.
    """
    fetches = [ev for ev in events
               if ev.get("ph") == "X" and ev.get("name") == "tier.miss_fetch"]
    gauges = {m["name"]: m.get("value") for m in metrics
              if m.get("kind") == "gauge"
              and m.get("name", "").startswith("ps.tier.")}
    if not fetches and not gauges:
        return None
    return {
        "fetches": len(fetches),
        "fetch_ms": sum(ev.get("dur", 0.0) for ev in fetches) / 1e3,
        "fetch_rows": sum(ev.get("args", {}).get("rows", 0)
                          for ev in fetches),
        "h2d_bytes": sum(ev.get("args", {}).get("h2d_bytes", 0)
                         for ev in fetches),
        "gauges": gauges,
    }


def admission_stats(metrics: List[dict]) -> Optional[dict]:
    """Concurrent-admission summary: trigger mix, sheds, errors, lag.

    None when the run never went through the ``ConcurrentEngine`` (no
    ``serve.batch_trigger.*`` counters, sheds, or version-lag gauge).
    """
    triggers = {m["name"].rsplit(".", 1)[-1]: m.get("value", 0)
                for m in metrics if m.get("kind") == "counter"
                and m.get("name", "").startswith("serve.batch_trigger.")}
    counters = {m["name"]: m.get("value", 0) for m in metrics
                if m.get("kind") == "counter"}
    gauges = {m["name"]: m.get("value") for m in metrics
              if m.get("kind") == "gauge"}
    shed = counters.get("serve.shed", 0)
    errors = counters.get("serve.batch_errors", 0)
    lag = gauges.get("serve.version_lag")
    if not triggers and not shed and lag is None:
        return None
    return {"triggers": triggers, "shed": shed, "errors": errors,
            "version_lag": lag,
            "version": gauges.get("serve.snapshot_version")}


def network_rows(metrics: List[dict]) -> Optional[dict]:
    """Per-op RPC traffic table + transport fault tallies.

    Built from the ``ps.rpc.calls.<op>`` / ``ps.rpc.bytes_out.<op>`` /
    ``ps.rpc.bytes_in.<op>`` counters the net transport emits, plus the
    ``ps.rpc.retries`` / ``ps.rpc.reconnects`` totals.  None when the
    run never used the network backend.
    """
    counters = {m["name"]: m.get("value", 0) for m in metrics
                if m.get("kind") == "counter"
                and m.get("name", "").startswith("ps.rpc.")}
    if not counters:
        return None
    ops: Dict[str, dict] = {}
    for name, value in counters.items():
        parts = name.split(".")
        if len(parts) != 4 or parts[2] not in ("calls", "bytes_out",
                                               "bytes_in"):
            continue
        ops.setdefault(parts[3], {"op": parts[3], "calls": 0,
                                  "bytes_out": 0,
                                  "bytes_in": 0})[parts[2]] += value
    return {"ops": sorted(ops.values(), key=lambda r: -r["calls"]),
            "retries": counters.get("ps.rpc.retries", 0),
            "reconnects": counters.get("ps.rpc.reconnects", 0)}


def latency_rows(metrics: List[dict]) -> List[dict]:
    """Every histogram's percentile summary (serve.* first)."""
    rows = [m for m in metrics if m.get("kind") == "histogram"
            and m.get("count", 0) > 0]
    return sorted(rows, key=lambda m: (not m["name"].startswith("serve."),
                                       m["name"]))


def render(trace_dir: str, trace_file: str = "trace.json",
           metrics_file: str = "metrics.jsonl", top: int = 15) -> str:
    """The full text report for one obs output directory."""
    events = load_trace(os.path.join(trace_dir, trace_file))
    mpath = os.path.join(trace_dir, metrics_file)
    metrics = load_jsonl(mpath) if os.path.exists(mpath) else []

    out: List[str] = [f"obs report: {trace_dir}"]

    rows = span_rows(events, top=top)
    if rows:
        out += ["", f"top spans (by total wall time, top {top})",
                f"  {'span':<24} {'count':>7} {'total ms':>10} "
                f"{'mean ms':>10} {'max ms':>10}"]
        for r in rows:
            out.append(f"  {r['name']:<24} {r['count']:>7} "
                       f"{_fmt_ms(r['total_ms'])} {_fmt_ms(r['mean_ms'])} "
                       f"{_fmt_ms(r['max_ms'])}")
    else:
        out += ["", "top spans: (no trace events)"]

    ov = overlap_stats(events)
    if ov is not None:
        out += ["", "async overlap (host free while device sweeps; "
                    "1 - dispatch/total)",
                f"  sweeps={ov['sweeps']}  mean={ov['mean']:.1f}%  "
                f"min={ov['min']:.1f}%  max={ov['max']:.1f}%"]

    routes = route_rows(events)
    if routes:
        out += ["", "push routes (ps.push cost per PushRoute policy)",
                f"  {'route':<8} {'calls':>6} {'mean ms':>10} "
                f"{'reassigns':>10} {'dense traffic':>14} "
                f"{'coo traffic':>14}"]
        for r in routes:
            out.append(f"  {r['route']:<8} {r['calls']:>6} "
                       f"{_fmt_ms(r['mean_ms'])} {r['batch']:>10} "
                       f"{_fmt_bytes(r['dense_bytes']):>14} "
                       f"{_fmt_bytes(r['coo_bytes']):>14}")

    tier = tier_stats_rows(events, metrics)
    if tier is not None:
        out += ["", "tiered storage (device hot rows over host memmap)"]
        g = tier["gauges"]
        if g:
            hit = g.get("ps.tier.hit_rate")
            parts = []
            if hit is not None:
                parts.append(f"hit_rate={hit:.3f}")
            if "ps.tier.hot_rows" in g:
                parts.append(f"hot_rows={int(g['ps.tier.hot_rows'])}")
            if "ps.tier.device_bytes" in g:
                parts.append(
                    f"device={_fmt_bytes(g['ps.tier.device_bytes']).strip()}")
            if "ps.tier.evictions" in g:
                parts.append(f"evictions={int(g['ps.tier.evictions'])}")
            out.append("  " + "  ".join(parts))
        if tier["fetches"]:
            out.append(
                f"  miss fetches: {tier['fetches']} "
                f"({tier['fetch_rows']} rows, "
                f"{_fmt_bytes(tier['h2d_bytes']).strip()} H2D, "
                f"{tier['fetch_ms']:.1f} ms total)")

    net = network_rows(metrics)
    if net is not None:
        out += ["", "network (ps.rpc transport, DESIGN.md sec. 15)",
                f"  {'op':<20} {'calls':>8} {'bytes out':>12} "
                f"{'bytes in':>12}"]
        for r in net["ops"]:
            out.append(f"  {r['op']:<20} {r['calls']:>8} "
                       f"{_fmt_bytes(r['bytes_out']):>12} "
                       f"{_fmt_bytes(r['bytes_in']):>12}")
        out.append(f"  retries={net['retries']}  "
                   f"reconnects={net['reconnects']}")

    lats = latency_rows(metrics)
    if lats:
        out += ["", "latency histograms (p50/p90/p95/p99)",
                f"  {'metric':<26} {'count':>7} {'p50':>9} {'p90':>9} "
                f"{'p95':>9} {'p99':>9} {'max':>9}  unit"]
        for m in lats:
            out.append(f"  {m['name']:<26} {m['count']:>7} "
                       f"{m['p50']:>9.3f} {m['p90']:>9.3f} "
                       f"{m['p95']:>9.3f} {m['p99']:>9.3f} "
                       f"{m['max']:>9.3f}  {m.get('unit', 'ms')}")
    elif metrics:
        out += ["", "latency histograms: (no histogram samples)"]

    adm = admission_stats(metrics)
    if adm is not None:
        out += ["", "serving admission (concurrent plane, DESIGN.md sec. 14)"]
        if adm["triggers"]:
            total = sum(adm["triggers"].values()) or 1
            mix = "  ".join(
                f"{name}={n} ({100.0 * n / total:.0f}%)"
                for name, n in sorted(adm["triggers"].items()))
            out.append(f"  batch triggers: {mix}")
        parts = [f"shed={adm['shed']}", f"batch_errors={adm['errors']}"]
        if adm["version_lag"] is not None:
            parts.append(f"version_lag={int(adm['version_lag'])}")
        if adm["version"] is not None:
            parts.append(f"serving_version={int(adm['version'])}")
        out.append("  " + "  ".join(parts))

    counters = [m for m in metrics if m.get("kind") == "counter"]
    if counters:
        out += ["", "counters"]
        for m in sorted(counters, key=lambda m: m["name"]):
            out.append(f"  {m['name']:<32} {m['value']:>12}")

    if not events and not metrics:
        out += ["", "(nothing recorded -- was the run traced?  enable with "
                    "LDAJob(obs=ObsConfig(enabled=True)) or --trace-dir)"]
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="summarise a repro_torch.obs output directory")
    ap.add_argument("trace_dir", nargs="?", default="experiments/obs",
                    help="directory holding trace.json / metrics.jsonl")
    ap.add_argument("--top", type=int, default=15,
                    help="span table rows")
    args = ap.parse_args(argv)
    print(render(args.trace_dir, top=args.top))


if __name__ == "__main__":
    main()
