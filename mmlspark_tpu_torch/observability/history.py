"""History server: render an event log into one static HTML report — the
port's copy of ``mmlspark_tpu/observability/history.py``. The page is the
reference's for the same events and metrics, except the roofline section's
peaks, which are the card's (``profiler.device_peaks``: Hopper rates)
and are labelled with the card's name.

Spark's History Server replays ``spark.eventLog.dir`` into the full web
UI after the application is gone; the analogue here folds the JSON-lines
event log (rotated segments included) plus an optional metrics snapshot
into one *self-contained* HTML file — no server process, no assets:

    python -m mmlspark_tpu_torch.observability.history /tmp/events.jsonl \
        -o report.html --metrics metrics.json

The report shows what the Spark UI's Jobs/Stages/SQL tabs would: the
stage timeline (relative offsets as CSS bars), per-task attempt history
with speculation markers, process-group losses, breaker trips, model
swaps, streaming epochs, the profiler's roofline attribution table, and
the serving SLO verdict
(:class:`~mmlspark_tpu_torch.observability.slo.SLOReport` folded from the
same events + snapshot).
"""

from __future__ import annotations

import argparse
import html
import json
import sys
from typing import Any, Dict, Iterable, List, Optional

from mmlspark_tpu_torch.observability.events import (
    Event,
    SpanRecorded,
    collect,
    merge,
    replay,
    timeline,
)
from mmlspark_tpu_torch.observability.profiler import FunctionProfile, device_peaks
from mmlspark_tpu_torch.observability.slo import SLOReport

_CSS = """
body { font-family: -apple-system, 'Segoe UI', Helvetica, Arial, sans-serif;
       margin: 2em auto; max-width: 70em; color: #1a1a2e; }
h1 { font-size: 1.5em; border-bottom: 2px solid #2b6cb0; padding-bottom: .3em; }
h2 { font-size: 1.15em; margin-top: 1.8em; color: #2b6cb0; }
table { border-collapse: collapse; margin: .6em 0; font-size: .92em; }
th, td { border: 1px solid #cbd5e0; padding: .3em .7em; text-align: left; }
th { background: #edf2f7; }
.cards { display: flex; flex-wrap: wrap; gap: .8em; margin: 1em 0; }
.card { border: 1px solid #cbd5e0; border-radius: 6px; padding: .6em 1em;
        min-width: 7em; background: #f7fafc; }
.card .num { font-size: 1.4em; font-weight: 600; }
.card .label { font-size: .8em; color: #4a5568; }
.bar-row { display: flex; align-items: center; margin: 2px 0; font-size: .85em; }
.bar-label { width: 22em; overflow: hidden; text-overflow: ellipsis;
             white-space: nowrap; }
.bar-track { flex: 1; background: #edf2f7; height: 14px; position: relative; }
.bar { position: absolute; height: 100%; background: #4299e1; min-width: 2px; }
.bar.failed { background: #e53e3e; }
.bar.p0 { background: #4299e1; } .bar.p1 { background: #48bb78; }
.bar.p2 { background: #ed8936; } .bar.p3 { background: #9f7aea; }
.bar.p4 { background: #38b2ac; } .bar.p5 { background: #d69e2e; }
.lane-label { width: 22em; font-weight: 600; }
.ok { color: #2f855a; font-weight: 600; }
.missed { color: #c53030; font-weight: 600; }
.muted { color: #718096; }
"""


def _esc(v: Any) -> str:
    return html.escape(str(v))


def _card(label: str, value: Any) -> str:
    return (
        f'<div class="card"><div class="num">{_esc(value)}</div>'
        f'<div class="label">{_esc(label)}</div></div>'
    )


def _table(headers: List[str], rows: List[List[Any]]) -> str:
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
        for row in rows
    )
    return f"<table><tr>{head}</tr>{body}</table>"


def _stage_timeline(stages: List[Dict[str, Any]]) -> str:
    """CSS-bar gantt of the stage fold: one row per stage, offset and
    width proportional to the run's wall-clock span."""
    if not stages:
        return '<p class="muted">no stage events</p>'
    t0 = min(s["start"] for s in stages)
    t1 = max(s["start"] + s.get("duration", 0.0) for s in stages)
    span = max(t1 - t0, 1e-9)
    rows = []
    for s in stages:
        dur = s.get("duration", 0.0)
        left = 100.0 * (s["start"] - t0) / span
        width = max(100.0 * dur / span, 0.5)
        cls = "bar failed" if s.get("status", "ok") != "ok" else "bar"
        label = f"[{s['phase']}] {s['name']}"
        rows.append(
            f'<div class="bar-row"><div class="bar-label" '
            f'title="{_esc(label)}">{_esc(label)}</div>'
            f'<div class="bar-track"><div class="{cls}" '
            f'style="left:{left:.2f}%;width:{width:.2f}%"></div></div>'
            f'<div style="width:6em;text-align:right">{dur * 1e3:.1f} ms</div>'
            f"</div>"
        )
    return "".join(rows)


def _attempts_table(tasks: Dict[str, Any]) -> str:
    attempts = tasks.get("attempts") or {}
    if not attempts:
        return '<p class="muted">no failed attempts recorded</p>'
    rows = []
    for task_id in sorted(attempts):
        for a in attempts[task_id]:
            rows.append([
                _esc(task_id),
                _esc(a["attempt"]) + (" (spec)" if a.get("speculative") else ""),
                f"w{_esc(a['worker'])}",
                _esc(a["reason"]),
                f"{a['duration'] * 1e3:.1f} ms",
                '<span class="missed">permanent</span>'
                if a.get("permanent") else "retried",
            ])
    return _table(
        ["task", "attempt", "worker", "reason", "duration", "outcome"], rows
    )


def _roofline_table(profiler: Dict[str, Dict[str, Any]]) -> str:
    if not profiler:
        return '<p class="muted">no profiler events (set MMLSPARK_TPU_PROFILE=1)</p>'
    peaks = device_peaks()
    peak_f, peak_b = peaks
    rows = []
    for name in sorted(profiler):
        p = profiler[name]
        fp = FunctionProfile(
            name=name,
            compiles=int(p.get("compiles", 0)),
            compile_seconds=float(p.get("compile_seconds", 0.0)),
            executions=int(p.get("executions", 0)),
            device_seconds=float(p.get("device_seconds", 0.0)),
            flops=float(p.get("flops", 0.0)),
            bytes_accessed=float(p.get("bytes_accessed", 0.0)),
        )
        r = fp.roofline(peak_f, peak_b, platform=peaks.platform)
        rows.append([
            _esc(name),
            f"{fp.compiles} ({fp.compile_seconds:.3f} s)",
            _esc(fp.executions),
            f"{r['mean_ms']:.3f} ms",
            f"{r['flops']:.3g}",
            f"{r['achieved_flops_per_s']:.3g}",
            f"{r['achieved_bytes_per_s']:.3g}",
            f"{r['mxu_frac']:.1%}" if r["mxu_frac"] is not None else "&mdash;",
            f"{r['hbm_frac']:.1%}" if r["hbm_frac"] is not None else "&mdash;",
            _esc(r["bound"]),
        ])
    provenance = (
        f'<p class="muted">peaks: {_esc(peaks.platform)}'
        + ("" if peaks.known else " &mdash; bound classification skipped")
        + "</p>"
    )
    # the reference's column names: "MXU %" is the share of the card's
    # float32 peak, "HBM %" of its memory rate (FunctionProfile.roofline)
    return provenance + _table(
        ["function", "compiles", "execs", "mean", "flops",
         "FLOP/s", "bytes/s", "MXU %", "HBM %", "bound"],
        rows,
    )


def _span_key(process: str, span_id: str) -> str:
    return f"{process}:{span_id}"


def _parent_key(process: str, parent_id: str) -> str:
    """Wire-crossing parents arrive already qualified (``proc:span``);
    bare parent ids are same-process by construction."""
    return parent_id if ":" in parent_id else f"{process}:{parent_id}"


def _gather_traces(events: Iterable[Event]) -> Dict[str, List[Dict[str, Any]]]:
    """trace_id -> span dicts, each carrying the process stamp the merged
    fleet log attached (empty for a single-process log)."""
    traces: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        if not isinstance(ev, SpanRecorded):
            continue
        process = str(getattr(ev, "process", "") or "")
        traces.setdefault(ev.trace_id, []).append({
            "name": ev.name,
            "process": process,
            "key": _span_key(process, ev.span_id),
            "parent": _parent_key(process, ev.parent_id)
            if ev.parent_id else "",
            "start": float(ev.wall_start),
            "duration": float(ev.duration),
            "status": ev.status,
        })
    return traces


def _walk_trace(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Depth-first tree order with a ``depth`` per span — roots are spans
    whose (qualified) parent never appears in this trace."""
    by_key = {s["key"]: s for s in spans}
    children: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for s in spans:
        parent = s["parent"]
        if parent and parent in by_key:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    ordered: List[Dict[str, Any]] = []

    def visit(span: Dict[str, Any], depth: int) -> None:
        ordered.append(dict(span, depth=depth))
        for child in sorted(
            children.get(span["key"], []), key=lambda c: c["start"]
        ):
            visit(child, depth + 1)

    for root in sorted(roots, key=lambda s: s["start"]):
        visit(root, 0)
    return ordered


def _trace_waterfall(
    events: Iterable[Event], max_traces: int = 5
) -> str:
    """The cross-process trace view: for each of the most interesting
    traces (most processes involved, then most spans), a gantt where every
    span is offset on the shared wall clock and colored by process —
    router hop, replica queue/batch/apply, and gang workers on one axis —
    followed by one collapsed lane per process."""
    traces = _gather_traces(events)
    if not traces:
        return (
            '<p class="muted">no spans in this log '
            "(spans are published when the event bus is active)</p>"
        )
    ranked = sorted(
        traces.items(),
        key=lambda kv: (
            -len({s["process"] for s in kv[1]}),
            -len(kv[1]),
            kv[0],
        ),
    )[:max_traces]
    out: List[str] = []
    for trace_id, spans in ranked:
        ordered = _walk_trace(spans)
        processes = sorted({s["process"] for s in ordered})
        palette = {p: i % 6 for i, p in enumerate(processes)}
        t0 = min(s["start"] for s in ordered)
        t1 = max(s["start"] + s["duration"] for s in ordered)
        span_s = max(t1 - t0, 1e-9)
        out.append(
            f"<h3>trace <code>{_esc(trace_id)}</code> "
            f'<span class="muted">({len(ordered)} spans, '
            f"{len(processes)} processes)</span></h3>"
        )
        for s in ordered:
            left = 100.0 * (s["start"] - t0) / span_s
            width = max(100.0 * s["duration"] / span_s, 0.5)
            cls = f'bar p{palette[s["process"]]}'
            if s["status"] != "ok":
                cls = "bar failed"
            indent = "&nbsp;" * (2 * s["depth"])
            label = f'{s["process"] or "local"} &middot; {_esc(s["name"])}'
            out.append(
                f'<div class="bar-row"><div class="bar-label" '
                f'title="{_esc(s["name"])}">{indent}{label}</div>'
                f'<div class="bar-track"><div class="{cls}" '
                f'style="left:{left:.2f}%;width:{width:.2f}%"></div></div>'
                f'<div style="width:6em;text-align:right">'
                f'{s["duration"] * 1e3:.1f} ms</div></div>'
            )
        if len(processes) > 1:
            # one collapsed lane per process: where each process spent the
            # trace's wall clock, side by side
            for proc in processes:
                bars = []
                for s in ordered:
                    if s["process"] != proc:
                        continue
                    left = 100.0 * (s["start"] - t0) / span_s
                    width = max(100.0 * s["duration"] / span_s, 0.5)
                    bars.append(
                        f'<div class="bar p{palette[proc]}" '
                        f'title="{_esc(s["name"])}" '
                        f'style="left:{left:.2f}%;width:{width:.2f}%"></div>'
                    )
                out.append(
                    f'<div class="bar-row"><div class="lane-label">'
                    f'lane: {_esc(proc or "local")}</div>'
                    f'<div class="bar-track">{"".join(bars)}</div>'
                    f'<div style="width:6em"></div></div>'
                )
    return "".join(out)


def _incidents_table(incidents: List[Dict[str, Any]]) -> str:
    if not incidents:
        return '<p class="muted">no incidents recorded</p>'
    return _table(
        ["incident", "trigger", "trace", "bundle", "detail"],
        [[
            _esc(i.get("incident_id", "")),
            _esc(i.get("trigger", "")),
            f'<code>{_esc(i["trace_id"])}</code>'
            if i.get("trace_id") else "&mdash;",
            f'<code>{_esc(i.get("path", ""))}</code>',
            _esc(i.get("detail", "")),
        ] for i in incidents],
    )


def render_report(
    events: Iterable[Event],
    metrics: Optional[Dict[str, Any]] = None,
    title: str = "mmlspark-tpu run",
) -> str:
    """One self-contained HTML page for an event stream + optional
    ``registry.summary()`` snapshot."""
    events = list(events)
    summary = timeline(events)
    slo = SLOReport.fold(metrics or {}, events=events)
    tasks = summary["tasks"]
    req = summary["requests"]
    procs = summary["processes"]
    streaming = summary["streaming"]

    cards = [
        _card("events", len(events)),
        _card("stages", len(summary["stages"])),
        _card("tasks dispatched", tasks["dispatched"]),
        _card("task failures", tasks["failed"]),
        _card("requests", req["count"]),
        _card("requests shed", req.get("shed", 0)),
        _card("models committed", len(summary["models"])),
    ]
    if procs.get("started"):
        cards.append(_card("processes lost", procs.get("lost", 0)))
    if streaming.get("epochs"):
        cards.append(_card("stream epochs", streaming["epochs"]))
    by_process = summary.get("by_process") or {}
    if by_process:
        cards.append(_card("fleet processes", len(by_process)))
    if summary.get("incidents"):
        cards.append(_card("incidents", len(summary["incidents"])))
    quality = summary.get("quality") or {}
    alerts = summary.get("alerts") or {}
    if quality.get("detected"):
        cards.append(_card("drift onsets", quality["detected"]))
    if alerts.get("fired"):
        cards.append(_card("alerts fired", alerts["fired"]))

    sections = [
        f"<h1>{_esc(title)}</h1>",
        f'<div class="cards">{"".join(cards)}</div>',
        "<h2>Stage timeline</h2>",
        _stage_timeline(summary["stages"]),
        "<h2>Task attempts</h2>",
        "<p>dispatched={d} retried={r} failed={f} permanent={p} "
        "speculated={s} recovered={rec}</p>".format(
            d=tasks["dispatched"], r=tasks["retried"], f=tasks["failed"],
            p=tasks["failed_permanent"], s=tasks["speculated"],
            rec=tasks["recovered"],
        ),
        _attempts_table(tasks),
    ]

    if procs.get("started") or procs.get("lost"):
        reasons = ", ".join(
            f"{_esc(k)} &times;{v}"
            for k, v in sorted((procs.get("loss_reasons") or {}).items())
        )
        sections += [
            "<h2>Process groups</h2>",
            f"<p>started={procs['started']} lost={procs['lost']} "
            f"reformed={procs['reformed']}"
            + (f" ({reasons})" if reasons else "") + "</p>",
        ]

    sections += ["<h2>Serving SLO</h2>"]
    if req["count"] or metrics:
        md = slo.to_markdown()
        sections.append(_markdown_tables(md))
    else:
        sections.append('<p class="muted">no serving traffic in this log</p>')

    fleet = summary.get("fleet") or []
    routing = summary.get("routing") or {}
    if fleet or routing.get("count"):
        sections.append("<h2>Fleet</h2>")
        if routing.get("count"):
            avg = routing["hops"] / routing["count"]
            sections.append(
                f"<p>routed={routing['count']} "
                f"failovers={routing['failovers']} avg_hops={avg:.2f}</p>"
            )
            by_replica = routing.get("by_replica") or {}
            if by_replica:
                sections.append(_table(
                    ["replica", "requests"],
                    [[_esc(k), v] for k, v in sorted(by_replica.items())],
                ))
        if fleet:
            sections.append(_table(
                ["direction", "fleet size", "replica", "reason"],
                [[_esc(f["direction"]), f["replicas"], f.get("replica", -1),
                  _esc(f.get("reason", ""))] for f in fleet],
            ))

    if by_process:
        sections += [
            "<h2>Fleet event log</h2>",
            "<p>merged per-process segments "
            "(<code>events.jsonl@&lt;process&gt;</code>)</p>",
            _table(
                ["process", "events"],
                [[_esc(p), n] for p, n in sorted(by_process.items())],
            ),
        ]

    sections += [
        "<h2>Distributed traces</h2>",
        _trace_waterfall(events),
    ]

    if (
        quality.get("detected") or quality.get("cleared")
        or alerts.get("fired") or alerts.get("resolved")
    ):
        sections += [
            "<h2>Model quality</h2>",
            f"<p>drift detected={quality.get('detected', 0)} "
            f"cleared={quality.get('cleared', 0)} &middot; "
            f"alerts fired={alerts.get('fired', 0)} "
            f"resolved={alerts.get('resolved', 0)}</p>",
        ]
        features = quality.get("features") or {}
        if features:
            sections.append(_table(
                ["feature", "drift onsets", "cleared", "status"],
                [[
                    _esc(feat),
                    rec.get("detected", 0),
                    rec.get("cleared", 0),
                    '<span class="ok">recovered</span>'
                    if rec.get("cleared", 0) >= rec.get("detected", 0)
                    else '<span class="missed">drifting</span>',
                ] for feat, rec in sorted(features.items())],
            ))
        history = alerts.get("history") or []
        if history:
            sections.append(_table(
                ["alert", "slo", "transition", "burn short", "burn long"],
                [[
                    _esc(a.get("alert", "")),
                    _esc(a.get("slo", "")),
                    '<span class="missed">fired</span>'
                    if a.get("state") == "fired"
                    else '<span class="ok">resolved</span>',
                    f"{a.get('burn_short', 0.0):.2f}x",
                    f"{a.get('burn_long', 0.0):.2f}x",
                ] for a in history],
            ))

    if summary.get("incidents"):
        sections += [
            "<h2>Incidents</h2>",
            _incidents_table(summary["incidents"]),
        ]

    breakers = summary["breaker_trips"]
    swaps = summary["swaps"]
    if breakers or swaps:
        sections.append("<h2>Resilience</h2>")
        if breakers:
            sections.append(_table(
                ["breaker", "trips"],
                [[_esc(k), v] for k, v in sorted(breakers.items())],
            ))
        if swaps:
            sections.append(_table(
                ["model", "version", "server"],
                [[_esc(s["name"]), s["version"], _esc(s.get("server", ""))]
                 for s in swaps],
            ))

    if streaming.get("epochs"):
        queries = ", ".join(
            f"{_esc(q)}: epochs {min(eps)}&ndash;{max(eps)}"
            for q, eps in sorted((streaming.get("queries") or {}).items())
        )
        sections += [
            "<h2>Streaming</h2>",
            f"<p>epochs={streaming['epochs']} rows={streaming['rows']} "
            f"source_units={streaming.get('source_units', 0)}"
            + (f" ({queries})" if queries else "") + "</p>",
        ]

    sections += [
        "<h2>Profiler roofline</h2>",
        _roofline_table(summary["profiler"]),
    ]
    if summary["models"]:
        sections += [
            "<h2>Models</h2>",
            "<p>" + ", ".join(_esc(m) for m in summary["models"]) + "</p>",
        ]

    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
        "<body>" + "".join(sections) + "</body></html>"
    )


def _markdown_tables(md: str) -> str:
    """Inline conversion of the SLOReport markdown (pipe tables and bare
    paragraphs only) to HTML — keeps the report dependency-free."""
    out: List[str] = []
    rows: List[List[str]] = []

    def flush():
        if rows:
            out.append(_table(
                rows[0], [[_esc(c) for c in r] for r in rows[1:]]
            ))
            rows.clear()

    for line in md.splitlines():
        line = line.strip()
        if line.startswith("|"):
            cells = [c.strip() for c in line.strip("|").split("|")]
            if all(set(c) <= {"-", ":", " "} and c for c in cells):
                continue  # separator row
            rows.append(cells)
        else:
            flush()
            if line:
                out.append(f"<p>{_esc(line)}</p>")
    flush()
    return "".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mmlspark_tpu_torch.observability.history",
        description="Render an event log into a self-contained HTML report.",
    )
    parser.add_argument("eventlog", help="JSON-lines event log path")
    parser.add_argument(
        "-o", "--output", default=None,
        help="output HTML path (default: <eventlog>.html)",
    )
    parser.add_argument(
        "--metrics", default=None,
        help="optional registry.summary() JSON snapshot to fold in",
    )
    parser.add_argument("--title", default=None, help="report title")
    args = parser.parse_args(argv)

    # a base path with per-process siblings (events.jsonl@replica-0, ...)
    # renders the federated fleet view; a plain log (including an
    # already-merged file, whose records carry process stamps) replays
    segments = collect(args.eventlog)
    if len(segments) > 1:
        events = merge(args.eventlog)
        print(
            f"federating {len(segments)} process logs: "
            + ", ".join(sorted(segments)),
            file=sys.stderr,
        )
    else:
        events = replay(args.eventlog)
    metrics = None
    if args.metrics:
        with open(args.metrics) as fh:
            metrics = json.load(fh)
    out_path = args.output or (args.eventlog + ".html")
    doc = render_report(
        events, metrics=metrics, title=args.title or args.eventlog
    )
    with open(out_path, "w") as fh:
        fh.write(doc)
    print(out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
