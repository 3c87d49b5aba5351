"""Run reports: ``telemetry.jsonl`` (+ bench trajectories) -> markdown.

``render_report`` turns the event stream a sweep/train run lands in its
JSONL sink — phase spans from ``PhaseTracer``, merged ``metrics`` /
``group_metrics`` snapshots (registry or suite-sectioned), per-group
``probe_report`` records — into ONE self-contained markdown document:
phase-time breakdown (nested spans indented under their parent), counter
tables, ASCII histograms of the registry distributions, the per-device
straggler table, the theory-vs-measured probe table, and the
``BENCH_<suite>.json`` throughput trajectory.

Everything here is host-side string assembly over already-fetched
snapshots (numpy only), so a telemetry.jsonl written by either package
renders to the same text.  The module is also the report CLI:

    PYTHONPATH=src python -m repro_torch.telemetry.report \
        runs/train/telemetry.jsonl [--bench BENCH_x.json] [--out report.md]
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable, Optional

import numpy as np

from repro_torch.telemetry.export import load_bench, read_jsonl
from repro_torch.telemetry.metrics import AFL_REGISTRY, merge_fetched
from repro_torch.telemetry.perdevice import participation_gini, top_stragglers


# ---------------------------------------------------------------------------
# ASCII histograms
# ---------------------------------------------------------------------------


def _fmt_edge(e: float) -> str:
    return f"{e:g}" if abs(e) < 1e5 else f"{e:.1e}"


def bin_labels(num_bins: int, edges: Optional[Iterable[float]]) -> list[str]:
    """Under/interior/overflow labels matching ``Histogram`` semantics;
    generic ``bin i`` labels when the edges are unknown."""
    edges = list(edges) if edges is not None else None
    if edges is None or len(edges) + 1 != num_bins:
        return [f"bin {i}" for i in range(num_bins)]
    lab = [f"< {_fmt_edge(edges[0])}"]
    lab += [f"[{_fmt_edge(a)}, {_fmt_edge(b)})"
            for a, b in zip(edges[:-1], edges[1:])]
    lab.append(f">= {_fmt_edge(edges[-1])}")
    return lab


def ascii_hist(counts, edges=None, width: int = 40) -> list[str]:
    """Render binned counts as label-aligned ASCII bars."""
    c = np.asarray(counts, np.float64)
    labels = bin_labels(len(c), edges)
    peak = float(c.max()) if len(c) else 0.0
    lw = max(len(s) for s in labels)
    out = []
    for label, v in zip(labels, c):
        bar = "#" * (int(round(v / peak * width)) if peak > 0 else 0)
        out.append(f"{label:>{lw}s} | {bar:<{width}s} {v:g}")
    return out


def _registry_edges(name: str):
    for h in AFL_REGISTRY.histograms:
        if h.name == name:
            return h.edges
    return None


# ---------------------------------------------------------------------------
# Section renderers (each returns a list of markdown lines, possibly empty)
# ---------------------------------------------------------------------------


def _md_table(header: list[str], rows: list[list]) -> list[str]:
    fmt = lambda v: (f"{v:.4g}" if isinstance(v, float) else str(v))
    return (["| " + " | ".join(header) + " |",
             "|" + "---|" * len(header)]
            + ["| " + " | ".join(fmt(v) for v in r) + " |" for r in rows])


def _phase_section(spans: list[dict]) -> list[str]:
    if not spans:
        return []
    # aggregate by (name, parent) so nested spans group under their parent
    agg: dict = {}
    order: list = []
    for s in spans:
        key = (s.get("parent"), s["name"])
        if key not in agg:
            agg[key] = {"count": 0, "total": 0.0, "max": 0.0, "errors": 0,
                        "depth": int(s.get("depth", 0))}
            order.append(key)
        a = agg[key]
        a["count"] += 1
        a["total"] += float(s.get("duration_s", 0.0))
        a["max"] = max(a["max"], float(s.get("duration_s", 0.0)))
        a["errors"] += 1 if s.get("error") else 0
    # parents first, their children directly beneath
    order.sort(key=lambda k: (agg[k]["depth"], -agg[k]["total"]))
    rows = []
    for parent, name in order:
        a = agg[(parent, name)]
        label = ("&nbsp;&nbsp;↳ " * min(a["depth"], 1) + name
                 if parent else name)
        note = f" ({a['errors']} raised)" if a["errors"] else ""
        rows.append([label + note, a["count"], a["total"],
                     a["total"] / a["count"] * 1e3, a["max"] * 1e3])
    return (["## Phase breakdown", ""]
            + _md_table(["phase", "count", "total s", "mean ms", "max ms"],
                        rows) + [""])


def _registry_section(snap: Optional[dict]) -> list[str]:
    if snap is None:
        return []
    out = ["## Federation counters", ""]
    rows = [[k, float(v)] for k, v in snap["counters"].items()]
    sc = snap["counters"]
    if "successes" in sc and "contacts" in sc:
        rows.append(["success_rate",
                     float(sc["successes"]) / max(float(sc["contacts"]), 1.0)])
    rows += [[f"{k} (gauge)", float(v)] for k, v in snap["gauges"].items()]
    out += _md_table(["metric", "value"], rows) + [""]
    out += ["## Distributions", ""]
    for name, counts in snap["hist"].items():
        out.append(f"### {name}")
        out.append("```")
        out += ascii_hist(counts, _registry_edges(name))
        out += ["```", ""]
    return out


def _groups_section(groups: list[dict]) -> list[str]:
    if not groups:
        return []
    rows = []
    for g in groups:
        snap = g.get("metrics") if "metrics" in g else g
        if "counters" not in (snap or {}):
            continue
        c = snap["counters"]
        contacts = float(c.get("contacts", 0.0))
        rows.append([
            g.get("group", "?"), int(g.get("seeds", 1)),
            float(c.get("rounds", 0.0)), contacts,
            float(c.get("successes", 0.0)),
            float(c.get("successes", 0.0)) / max(contacts, 1.0),
            float(c.get("bits_total", 0.0)) / 1e6,
        ])
    if not rows:
        return []
    return (["## Per-group results", ""]
            + _md_table(["group", "seeds", "rounds", "contacts", "successes",
                         "success rate", "Mbits"], rows) + [""])


def _straggler_section(device: Optional[dict], k: int = 8) -> list[str]:
    if device is None:
        return []
    rows = [
        [r["device"], r["contacts"], r["successes"], r["failures"],
         r["success_rate"], r["staleness_mean"], r["last_contact"],
         r["bits_sum"] / 1e6, r["energy_sum"]]
        for r in top_stragglers(device, k=k)
    ]
    gini = participation_gini(device)
    return (["## Stragglers (per-device flight recorder)", "",
             f"Participation Gini: **{gini:.3f}** "
             "(0 = uniform, 1 = one device does everything).", ""]
            + _md_table(["device", "contacts", "succ", "fail", "succ rate",
                         "stale mean", "last round", "Mbits", "J"], rows)
            + [""])


def _probes_section(reports: list[dict]) -> list[str]:
    if not reports:
        return []
    out = ["## Theory vs measured (online probes)", ""]
    for rep in reports:
        group = rep.get("group")
        if group:
            out.append(f"### {group}")
        out.append(
            f"Operating point: s={rep.get('s')} u={rep.get('u')} "
            f"c={rep.get('c'):.4g} lam={rep.get('lam'):.4g} "
            f"delta={rep.get('delta'):.4g} rate={rep.get('rate'):.4g} bit/s"
        )
        out.append("")
        rows = [[name, t["measured"], t["expected"], t["delta"], t["rel"]]
                for name, t in rep.get("terms", {}).items()]
        out += _md_table(["probe", "measured", "expected", "delta", "rel"],
                         rows)
        th = rep.get("theorem1")
        if th:
            out.append("")
            out.append("Theorem-1 bound decomposition: "
                       + "  ".join(f"{k}={v:.4g}" for k, v in th.items()))
        out.append("")
    return out


def _bench_section(bench: Optional[dict]) -> list[str]:
    if not bench:
        return []
    out = [f"## Bench trajectory ({bench.get('suite', '?')})", ""]
    history = bench.get("history", [])
    rows = []
    for rec in bench.get("rows", []):
        trail = [
            r["us_per_call"] for h in history for r in h.get("rows", [])
            if r.get("name") == rec.get("name")
        ]
        rows.append([
            rec.get("name", "?"), float(rec.get("us_per_call", 0.0)),
            rec.get("metrics", {}).get("rounds_per_s", ""),
            " → ".join(f"{v:.0f}" for v in trail) or "(first export)",
        ])
    return out + _md_table(
        ["bench", "us/call", "rounds/s", "history (us/call)"], rows) + [""]


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------


def _suite_sections(ev: dict):
    """(registry snapshot, device snapshot, probes snapshot) from a
    ``metrics`` event — suite-sectioned or plain registry."""
    if "counters" in ev:
        return ev, None, None
    return ev.get("metrics"), ev.get("device"), ev.get("probes")


def render_report(events: list[dict], bench: Optional[dict] = None,
                  title: str = "Run report") -> str:
    """Assemble the markdown report from JSONL events (+ optional BENCH).

    Understands the event kinds train/sweep emit: ``span``, ``metrics``
    (sweep-wide total), ``group_metrics``, ``probe_report``.  Missing
    kinds simply drop their section — a loop-engine train run without
    probes still gets phases + counters + histograms.
    """
    spans = [e for e in events if e.get("kind") == "span"]
    totals = [e for e in events if e.get("kind") == "metrics"]
    groups = [e for e in events if e.get("kind") == "group_metrics"]
    probe_reports = [e for e in events if e.get("kind") == "probe_report"]

    if totals:
        registry, device, probes = _suite_sections(totals[-1])
    elif groups:
        merged = merge_fetched([
            {k: v for k, v in g.items() if k not in ("kind", "group",
                                                     "seeds")}
            for g in groups
        ])
        registry, device, probes = _suite_sections(merged)
    else:
        registry = device = probes = None

    lines = [f"# {title}", "",
             f"_{len(events)} telemetry events; {len(spans)} spans, "
             f"{len(groups)} group snapshot(s), {len(probe_reports)} probe "
             "report(s)._", ""]
    lines += _phase_section(spans)
    lines += _registry_section(registry)
    lines += _groups_section(groups)
    lines += _straggler_section(device)
    lines += _probes_section(probe_reports)
    lines += _bench_section(bench)
    return "\n".join(lines).rstrip() + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="telemetry.jsonl (+ BENCH json) -> markdown run report")
    ap.add_argument("telemetry", help="path to a run's telemetry.jsonl")
    ap.add_argument("--bench", default="",
                    help="optional BENCH_<suite>.json trajectory file")
    ap.add_argument("--out", default="",
                    help="output path (default: report.md next to the input)")
    ap.add_argument("--title", default="Run report")
    args = ap.parse_args(argv)

    events = read_jsonl(args.telemetry)
    bench = load_bench(args.bench) if args.bench else None
    text = render_report(events, bench=bench, title=args.title)

    out = args.out or os.path.join(
        os.path.dirname(os.path.abspath(args.telemetry)), "report.md")
    with open(out, "w") as f:
        f.write(text)
    print(out)
    return 0


__all__ = ["ascii_hist", "bin_labels", "main", "render_report"]


if __name__ == "__main__":
    sys.exit(main())
