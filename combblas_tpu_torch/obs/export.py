"""Live metrics export — counterpart of ``combblas_tpu/obs/export.py``
(host-only): Prometheus text exposition + HTTP scrape
surface (round 15).

The JSONL sinks are pull-after-the-fact; a serving fleet is operated
through a PULL-based scrape loop (Prometheus/Monarch style).  This
module renders the metrics registry snapshot as Prometheus text
exposition format — counters and gauges verbatim, histograms as
summaries (``_count`` / ``_sum`` / ``_min`` / ``_max`` plus
``{quantile="0.5|0.95|0.99"}`` lines from the round-15 sample
reservoir, ``sinks.quantile_summary`` — ONE quantile implementation
for scrape, JSONL aggregate, and benches) — and serves it from a
stdlib ``ThreadingHTTPServer`` daemon thread attachable to any serve
front end (``Server.serve_metrics`` / ``PoolServer`` /
``FleetRouter``):

    GET /metrics   Prometheus text (the scrape target)
    GET /healthz   the owner's ``health()`` as JSON
    GET /statz     the owner's ``stats()`` as JSON (debug surface)

Nothing here runs unless explicitly started — the zero-cost contract:
no thread, no socket, no rendering until ``serve_scrape()`` (and the
registry itself is only populated when obs is enabled).

One-shot snapshot CLI (renders a recorded JSONL trace as Prometheus
text, e.g. for offline diffing or pushing through a gateway):

    python -m combblas_tpu_torch.obs.export trace.jsonl [--out metrics.prom]
"""

from __future__ import annotations

import json
import re
import threading

#: Every exported series name is prefixed (Prometheus namespacing) and
#: dots become underscores: ``serve.queue.depth`` ->
#: ``combblas_serve_queue_depth``.
PREFIX = "combblas_"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def metric_name(name: str) -> str:
    return PREFIX + _NAME_RE.sub("_", name)


def _esc(v) -> str:
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels(labels: dict, extra: dict | None = None) -> str:
    items = sorted(labels.items())
    if extra:
        items = items + sorted(extra.items())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in items) + "}"


def _num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(records=None) -> str:
    """Prometheus text exposition of a metric-record list (default:
    the live registry snapshot, providers polled).  Counter and gauge
    values are emitted verbatim under their sanitized names;
    histograms become summaries with reservoir quantiles."""
    if records is None:
        from . import metrics_snapshot

        records = metrics_snapshot()
    by_name: dict[tuple, list] = {}
    for rec in records:
        kind = rec.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            continue
        by_name.setdefault((rec["name"], kind), []).append(rec)
    lines: list[str] = []
    for (name, kind), recs in sorted(by_name.items()):
        mname = metric_name(name)
        if kind == "histogram":
            lines.append(f"# TYPE {mname} summary")
            for rec in recs:
                lab = rec.get("labels", {})
                for q in ("p50", "p95", "p99"):
                    if rec.get(q) is not None:
                        lines.append(
                            f"{mname}"
                            f"{_labels(lab, {'quantile': '0.' + q[1:]})}"
                            f" {_num(rec[q])}"
                        )
                lines.append(
                    f"{mname}_count{_labels(lab)} {_num(rec['count'])}"
                )
                lines.append(
                    f"{mname}_sum{_labels(lab)} {_num(rec['sum'])}"
                )
                lines.append(
                    f"{mname}_min{_labels(lab)} {_num(rec['min'])}"
                )
                lines.append(
                    f"{mname}_max{_labels(lab)} {_num(rec['max'])}"
                )
        else:
            lines.append(f"# TYPE {mname} {kind}")
            for rec in recs:
                lines.append(
                    f"{mname}{_labels(rec.get('labels', {}))}"
                    f" {_num(rec['value'])}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def render_from_jsonl(path: str) -> str:
    """One-shot: parse a recorded obs JSONL trace and render its
    metric records as Prometheus text (the snapshot CLI's body)."""
    from .sinks import parse_jsonl

    return render(parse_jsonl(path))


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text back into ``{(name, labelstr): value}`` —
    the parity-test helper (and a convenient programmatic reader)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        body, _, val = line.rpartition(" ")
        m = re.match(r"([a-zA-Z0-9_:]+)(\{.*\})?$", body)
        if not m:
            continue
        out[(m.group(1), m.group(2) or "")] = float(val)
    return out


# -- the scrape thread -------------------------------------------------------


class ScrapeServer:
    """Stdlib HTTP daemon serving /metrics, /healthz, /statz for one
    owner object (anything with optional ``health()``/``stats()``)."""

    def __init__(self, owner=None, host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import (
            BaseHTTPRequestHandler, ThreadingHTTPServer,
        )

        scrape = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # no stderr chatter per scrape
                pass

            def do_GET(self):
                from . import count

                path = self.path.split("?", 1)[0]
                # label by KNOWN endpoint only: counting the raw
                # client-supplied path would let any prober mint
                # unbounded registry series (one per distinct URL)
                count(
                    "obs.scrape.requests",
                    path=(
                        path
                        if path in ("/metrics", "/healthz", "/statz")
                        else "other"
                    ),
                )
                try:
                    if path == "/metrics":
                        # an owner with metrics_records() federates its
                        # own view (the process fleet folds per-replica
                        # child snapshots in); plain owners scrape the
                        # process-local registry
                        fn = getattr(scrape.owner, "metrics_records", None)
                        body = render(
                            fn() if callable(fn) else None
                        ).encode()
                        ctype = "text/plain; version=0.0.4"
                    elif path == "/healthz":
                        body = scrape._json_of("health")
                        ctype = "application/json"
                    elif path == "/statz":
                        body = scrape._json_of("stats")
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # a scrape must never wedge on
                    # a mid-shutdown owner: report, keep listening
                    self.send_error(500, repr(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.owner = owner
        self._stopped = False
        self._stop_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="combblas-obs-scrape", daemon=True,
        )
        self._thread.start()

    def _json_of(self, method: str) -> bytes:
        fn = getattr(self.owner, method, None)
        payload = fn() if callable(fn) else {"error": f"no {method}()"}
        # stats() payloads may hold numpy scalars etc. — stringify
        # anything json cannot express rather than 500 the scrape
        return json.dumps(payload, default=str).encode()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        """Idempotent: repeated stops (owner.close() called twice, or a
        detach racing a close-path teardown) must not shutdown() an
        already-closed ThreadingHTTPServer — that call blocks forever
        waiting for a serve_forever loop that already exited."""
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(5.0)


def serve_scrape(owner=None, port: int = 0, host: str = "127.0.0.1"
                 ) -> ScrapeServer:
    """Start the scrape thread (port 0 = ephemeral; read ``.port``)."""
    return ScrapeServer(owner, host=host, port=port)


#: Serializes owner-registration (attach/detach) across threads: the
#: old check-then-set on ``owner._scrape`` let two concurrent
#: ``serve_metrics()`` calls (a Server and the FleetRouter wrapping
#: it, or two API callers) BOTH start HTTP daemons — the loser's
#: server leaked its port and thread forever (round 20 bugfix).
_ATTACH_LOCK = threading.Lock()


def attach_scrape(owner, port: int = 0, host: str = "127.0.0.1"
                  ) -> int:
    """The ONE serve_metrics implementation behind ``Server`` /
    ``PoolServer`` / ``FleetRouter`` / ``ProcessFleet``: idempotently
    attach a scrape thread to ``owner._scrape`` and return the bound
    port.  Safe to call repeatedly and concurrently; repeated
    attach/close cycles re-attach a FRESH server each time (the
    previous one was stopped and cleared by ``detach_scrape``)."""
    with _ATTACH_LOCK:
        s = getattr(owner, "_scrape", None)
        if s is None or getattr(s, "_stopped", False):
            owner._scrape = serve_scrape(owner, port=port, host=host)
        return owner._scrape.port


def detach_scrape(owner) -> None:
    """Stop and clear an attached scrape thread (close()-path twin of
    ``attach_scrape``; no-op when never attached, idempotent when
    called twice).  The registration flip happens under the attach
    lock; the (blocking) HTTP shutdown happens outside it, so a slow
    teardown can never wedge a concurrent attach on another owner."""
    with _ATTACH_LOCK:
        s = getattr(owner, "_scrape", None)
        owner._scrape = None
    if s is not None:
        s.stop()


# -- one-shot snapshot CLI ---------------------------------------------------


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Render a combblas_tpu_torch obs JSONL trace (or the "
        "live in-process registry) as Prometheus text exposition."
    )
    ap.add_argument("jsonl", nargs="?", help="obs JSONL trace to render"
                    " (omit for the current process registry)")
    ap.add_argument("--out", help="write here instead of stdout")
    args = ap.parse_args(argv)
    text = render_from_jsonl(args.jsonl) if args.jsonl else render()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
