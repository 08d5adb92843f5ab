"""Telemetry sinks — counterpart of ``combblas_tpu/obs/sinks.py``: JSONL
export/parse/validate, host-side multi-process merge, and the device sum
of add-monoid counters. The schema strings are the reference's, so a file
written by either package parses in the other.

JSONL schema (``combblas_tpu.obs/v1``): one event per line, every line a
JSON object with

    {"v": 1, "kind": <kind>, ...}

kinds and their required fields:

    meta       schema (str, == SCHEMA), ts (float), process (int),
               nprocs (int)
    span       name (str), path (str), ts (float), wall_s (number >= 0);
               optional attrs (obj), events (list of {"name", "t_s", ...}),
               failed (bool)
    event      name (str), ts (float)  — span-less, process-level
    counter    name (str), value (number), labels (obj)
    gauge      name (str), value (number), labels (obj)
    histogram  name (str), count (int), sum/min/max (number), labels (obj);
               optional samples (list) + p50/p95/p99 (the round-15
               reservoir quantiles, computed by the registry snapshot)
    trace      name (str), rid (int|str), ts (float), wall_s (>= 0),
               stages (list of {"stage", "s"} summing to wall_s),
               labels (obj) — one served request's latency
               decomposition (round 15, ``obs/trace.py``)

Flight-recorder snapshots (round 15, ``obs/recorder.py``) are JSONL
files under ``combblas_tpu.flightrec/v1``: one meta line carrying that
schema plus a ``reason`` field, then ordinary ``event`` records — the
same validator accepts both schemas.

Multihost aggregation: each process dumps its own file (the exporter
stamps ``process``); ``merge_jsonl_files`` merges them host-side —
counters and histograms add across processes, gauges and spans keep a
``process`` qualifier. For counters that must be combined ON DEVICE
(inside a timed section, no readback), ``psum_counters`` reduces a
per-tile counter block over the grid with the add monoid, on the device
(the MPI_Allreduce-on-MPI_SUM analog of the reference's TIMING reduction;
the tiles of a grid live on one device, so it is the tile loop's fold).
"""

from __future__ import annotations

import json
import numbers
import time

SCHEMA = "combblas_tpu.obs/v1"
SCHEMA_VERSION = 1

#: Flight-recorder snapshot schema (round 15, ``obs/recorder.py``): a
#: dump file is one meta line under THIS schema (plus ``reason``)
#: followed by ordinary ``event`` records — parse_jsonl validates both.
FLIGHTREC_SCHEMA = "combblas_tpu.flightrec/v1"

#: Supervision-timeline schema (round 18, ``obs/fleetlog.py``): the
#: process fleet's event log is one meta line under THIS schema
#: followed by ordinary ``event`` records (spawn, heartbeat-miss,
#: quarantine, respawn, promotion, ...) — parse_jsonl validates all
#: three schemas with the same code.
FLEETLOG_SCHEMA = "combblas_tpu.fleetlog/v1"

_KINDS = ("meta", "span", "event", "counter", "gauge", "histogram",
          "trace")
_META_SCHEMAS = (SCHEMA, FLIGHTREC_SCHEMA, FLEETLOG_SCHEMA)

#: Quantiles every histogram summary carries (round 15): computed ONCE
#: here and reused by the Prometheus exporter and the bench sidecars —
#: benches must not re-derive percentiles by hand.
QUANTILES = (0.5, 0.95, 0.99)


def quantiles(values, qs=QUANTILES) -> dict:
    """Linear-interpolation quantiles of a sample list:
    ``{q: value}`` (None-valued when ``values`` is empty).  The one
    percentile implementation the registry snapshot, ``aggregate()``,
    the exporter and every bench share."""
    vs = sorted(float(v) for v in values)
    out: dict = {}
    for q in qs:
        if not vs:
            out[q] = None
            continue
        pos = float(q) * (len(vs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vs) - 1)
        out[q] = vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)
    return out


def quantile_summary(values) -> dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` from a sample list —
    the field names histogram records and aggregate summaries carry."""
    qs = quantiles(values)
    return {f"p{int(q * 100)}": v for q, v in qs.items()}


def validate_record(rec: dict) -> None:
    """Raise ``ValueError`` unless ``rec`` is a valid v1 schema record."""

    def need(field, types):
        if field not in rec:
            raise ValueError(f"{rec.get('kind')}: missing field {field!r}")
        if not isinstance(rec[field], types):
            raise ValueError(
                f"{rec.get('kind')}.{field}: {type(rec[field]).__name__} "
                f"is not {types}"
            )

    if not isinstance(rec, dict):
        raise ValueError(f"record is {type(rec).__name__}, not an object")
    need("v", numbers.Integral)
    if rec["v"] != SCHEMA_VERSION:
        raise ValueError(f"unknown schema version {rec['v']}")
    need("kind", str)
    kind = rec["kind"]
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "meta":
        need("schema", str)
        if rec["schema"] not in _META_SCHEMAS:
            raise ValueError(f"unknown schema {rec['schema']!r}")
        need("ts", numbers.Real)
        need("process", numbers.Integral)
        need("nprocs", numbers.Integral)
        return
    need("name", str)
    if kind == "trace":
        # per-request serve trace (round 15, obs/trace.py): stage
        # durations sum to wall_s — the latency decomposition record
        if "rid" not in rec or not isinstance(
            rec["rid"], (numbers.Integral, str)
        ):
            raise ValueError("trace.rid missing or not int/str")
        need("ts", numbers.Real)
        need("wall_s", numbers.Real)
        if rec["wall_s"] < 0:
            raise ValueError("trace.wall_s < 0")
        need("stages", list)
        for st in rec["stages"]:
            if (
                not isinstance(st, dict)
                or not isinstance(st.get("stage"), str)
                or not isinstance(st.get("s"), numbers.Real)
            ):
                raise ValueError(f"malformed trace stage: {st!r}")
        need("labels", dict)
    elif kind == "span":
        need("path", str)
        need("ts", numbers.Real)
        need("wall_s", numbers.Real)
        if rec["wall_s"] < 0:
            raise ValueError("span.wall_s < 0")
        for ev in rec.get("events", []):
            if not isinstance(ev, dict) or "name" not in ev:
                raise ValueError(f"span event without name: {ev!r}")
    elif kind == "event":
        need("ts", numbers.Real)
    elif kind in ("counter", "gauge"):
        need("value", numbers.Real)
        need("labels", dict)
    elif kind == "histogram":
        need("labels", dict)
        for f in ("count", "sum", "min", "max"):
            need(f, numbers.Real)


def encode_records(metric_records, span_tracker, *, process: int = 0,
                   nprocs: int = 1, traces=()) -> list[dict]:
    """Assemble the full schema record list from a registry snapshot and a
    SpanTracker (one meta line first, then spans, events, per-request
    traces, metrics)."""
    meta = {
        "v": SCHEMA_VERSION, "kind": "meta", "schema": SCHEMA,
        "ts": time.time(), "process": int(process), "nprocs": int(nprocs),
    }
    if span_tracker.dropped:
        meta["dropped_records"] = span_tracker.dropped
    out = [meta]
    for rec in span_tracker.log:
        out.append({"v": SCHEMA_VERSION, "kind": "span", **rec})
    for rec in span_tracker.events:
        out.append({"v": SCHEMA_VERSION, "kind": "event", **rec})
    for rec in traces:
        out.append({"v": SCHEMA_VERSION, "kind": "trace", **rec})
    for rec in metric_records:
        out.append({"v": SCHEMA_VERSION, **rec})
    return out


def write_jsonl(path: str, records) -> str:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    return path


def parse_jsonl(path: str, validate: bool = True) -> list[dict]:
    """Read a JSONL trace back; each line validated against the schema."""
    out = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad JSON: {e}") from e
            if validate:
                try:
                    validate_record(rec)
                except ValueError as e:
                    raise ValueError(f"{path}:{lineno}: {e}") from e
            out.append(rec)
    return out


def aggregate(records) -> dict:
    """Fold a record list (possibly spanning processes) into one summary:
    counters/histograms ADD, gauges keep (process, labels)-qualified last
    values, spans fold into the {name: (seconds, calls)} table."""
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    hist_samples: dict = {}
    span_table: dict = {}
    spans = []
    events = []
    traces = []
    nprocs = set()
    proc = 0
    for rec in records:
        kind = rec.get("kind")
        # per-record process stamps (merge_jsonl_files strips meta lines,
        # so the contributing-process set must come from the records too;
        # -1 is the synthetic merged-meta marker, not a process)
        if "process" in rec and rec["process"] >= 0:
            nprocs.add(rec["process"])
        if kind == "meta":
            proc = rec.get("process", 0)
            if proc >= 0:
                nprocs.add(proc)
        elif kind == "counter":
            key = (rec["name"], tuple(sorted(rec["labels"].items())))
            counters[key] = counters.get(key, 0) + rec["value"]
        elif kind == "gauge":
            key = (
                rec["name"],
                tuple(sorted(rec["labels"].items())),
                rec.get("process", proc),
            )
            gauges[key] = rec["value"]
        elif kind == "histogram":
            key = (rec["name"], tuple(sorted(rec["labels"].items())))
            h = hists.get(key)
            if h is None:
                hists[key] = [rec["count"], rec["sum"], rec["min"],
                              rec["max"]]
            else:
                h[0] += rec["count"]
                h[1] += rec["sum"]
                h[2] = min(h[2], rec["min"])
                h[3] = max(h[3], rec["max"])
            # reservoir samples ride along (metrics.py snapshots them):
            # concatenating across processes lets the quantile summary
            # below be computed ONCE, here, for everyone downstream.
            # The merge buffer is bounded ELEMENT-wise — a block-wise
            # gate would drop late processes' reservoirs wholesale and
            # silently bias the merged quantiles toward early files
            samples = rec.get("samples")
            if samples:
                buf = hist_samples.setdefault(key, [])
                take = 8192 - len(buf)
                if take > 0:
                    buf.extend(samples[:take])
        elif kind == "trace":
            traces.append({**rec, "process": rec.get("process", proc)})
        elif kind == "span":
            a = span_table.setdefault(rec["name"], [0.0, 0])
            a[0] += rec["wall_s"]
            a[1] += 1
            spans.append({**rec, "process": rec.get("process", proc)})
        elif kind == "event":
            events.append({**rec, "process": rec.get("process", proc)})
    return {
        "counters": {k[0] + _label_suffix(k[1]): v
                     for k, v in sorted(counters.items())},
        "gauges": {f"{k[0]}{_label_suffix(k[1])}@p{k[2]}": v
                   for k, v in sorted(gauges.items())},
        "histograms": {
            k[0] + _label_suffix(k[1]): {
                "count": h[0], "sum": h[1], "min": h[2], "max": h[3],
                **(
                    quantile_summary(hist_samples[k])
                    if k in hist_samples else {}
                ),
            }
            for k, h in sorted(hists.items())
        },
        "span_table": {k: (v[0], v[1]) for k, v in sorted(span_table.items())},
        "spans": spans,
        "events": events,
        "traces": traces,
        "processes": sorted(nprocs) or [0],
    }


def _label_suffix(label_items: tuple) -> str:
    if not label_items:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in label_items) + "}"


def merge_jsonl_files(paths, out_path: str | None = None) -> dict:
    """Host-side multi-process merge: parse every per-process file,
    stamp each record with its file's process id, aggregate. When
    ``out_path`` is given, also write the merged record stream (one meta
    line for the merge, then every stamped record)."""
    all_records = []
    for path in paths:
        recs = parse_jsonl(path)
        proc = next(
            (r.get("process", 0) for r in recs if r.get("kind") == "meta"), 0
        )
        for rec in recs:
            if rec.get("kind") != "meta":
                all_records.append({**rec, "process": proc})
    agg = aggregate(all_records)
    if out_path is not None:
        merged_meta = {
            "v": SCHEMA_VERSION, "kind": "meta", "schema": SCHEMA,
            "ts": time.time(), "process": -1,
            "nprocs": len(paths), "merged_from": len(paths),
        }
        write_jsonl(out_path, [merged_meta] + all_records)
        agg["path"] = out_path
    return agg


def psum_counters(grid, local_counts):
    """Add-monoid counter reduction over the 2D grid, on the device.

    ``local_counts``: [pr, pc, k], each tile's counter vector (e.g. per-tile
    drop counts or load tallies accumulated on the device). Returns the [k]
    global totals as a device tensor, with no readback. The reference
    reduces over the mesh's row axis, then its column axis
    (``axis_reduce`` under ``shard_map``); the port's tiles live on one
    device, so the same two folds run as a loop over the tiles, in the
    same order. The NCCL form over several cards comes with the
    multi-card grid.
    """
    import torch

    x = torch.as_tensor(local_counts)
    pr, pc = grid.pr, grid.pc
    if tuple(x.shape[:2]) != (pr, pc):
        raise ValueError(f"local_counts is {tuple(x.shape)}, want [{pr}, {pc}, k]")
    total = None
    for j in range(pc):
        col = x[0, j]
        for i in range(1, pr):
            col = col + x[i, j]
        total = col if total is None else total + col
    return total
