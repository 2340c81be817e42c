"""Prometheus-text export of the port's live metrics plane, a copy of
``accelerate_tpu/telemetry/exporter.py``.

Two consumers, one renderer:

- :func:`prometheus_text` — the plane as Prometheus exposition text
  (version 0.0.4). Counters and gauges render one sample per label set;
  histograms render as SUMMARIES (``{quantile="0.5|0.95|0.99"}`` +
  ``_sum``/``_count`` over the sliding window), because the plane keeps
  exact windows, not pre-bucketed bins — quantiles are what it can state
  honestly, and what the SLO summaries already stamp. Values are rendered
  with ``repr``-fidelity so a scrape equals :meth:`MetricsPlane.stats`
  **to the digit** (tested).
- :class:`MetricsExporter` — a stdlib ``http.server`` endpoint serving
  ``GET /metrics`` (text) and ``GET /healthz`` (JSON liveness). **Off by
  default**: nothing in the stack starts one implicitly; construct and
  :meth:`~MetricsExporter.start` it explicitly. It binds loopback unless
  told otherwise and speaks plaintext HTTP with no authentication — treat
  it as a node-local scrape target behind your scrape infra, never an
  internet-facing service.

No-server alternative: ``python -m accelerate_tpu_torch.commands.metrics_dump``
aggregates a recorded
telemetry JSONL run directory through the same plane and prints the same
text — pull-less scraping for batch jobs and post-hoc analysis.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import M_EXPORTER_SCRAPES_TOTAL, METRIC_REGISTRY, MetricsPlane

__all__ = ["prometheus_text", "MetricsExporter"]

#: The summary quantiles exported per histogram window (matches the p50/p95/
#: p99 blocks ``telemetry.slo.latency_summary`` stamps everywhere else).
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _fmt(value) -> str:
    """One sample value as Prometheus text: floats via ``repr`` (shortest
    round-trip — the scrape-equals-stats()-to-the-digit contract), bools as
    0/1, None as NaN."""
    if value is None:
        return "NaN"
    if isinstance(value, bool):
        return "1" if value else "0"
    return repr(float(value))


def _series_labels(series: str) -> str:
    """The ``{...}`` suffix of a rendered series key ('' when unlabeled)."""
    brace = series.find("{")
    return "" if brace < 0 else series[brace:]


def prometheus_text(plane: MetricsPlane, now: Optional[float] = None) -> str:
    """The whole plane in Prometheus exposition format. Metric families are
    emitted in registry order with ``# HELP``/``# TYPE`` headers; families
    with no samples yet are omitted (Prometheus treats absence as absence —
    a 0 would be a claim)."""
    stats = plane.stats(now=now)
    if not stats.get("enabled"):
        return "# metrics plane disabled\n"
    lines = []
    by_family = {}
    for table in ("counters", "gauges"):
        for series, value in stats[table].items():
            name = series.split("{", 1)[0]
            by_family.setdefault(name, []).append((series, value))
    for name in sorted(METRIC_REGISTRY):
        spec = METRIC_REGISTRY[name]
        if spec.kind in ("counter", "gauge"):
            samples = by_family.get(name)
            if not samples:
                continue
            lines.append(f"# HELP {name} {spec.description}")
            lines.append(f"# TYPE {name} {spec.kind}")
            for series, value in samples:
                lines.append(f"{series} {_fmt(value)}")
        else:  # histogram windows → summary families
            samples = [
                (series, block)
                for series, block in stats["histograms"].items()
                if series.split("{", 1)[0] == name
            ]
            if not any(block.get("count") for _, block in samples):
                continue
            lines.append(f"# HELP {name} {spec.description}")
            lines.append(f"# TYPE {name} summary")
            for series, block in samples:
                if not block.get("count"):
                    continue
                labels = _series_labels(series)
                base = labels[1:-1] if labels else ""
                for q, p in _QUANTILES:
                    qlabels = f'{{{base + "," if base else ""}quantile="{q}"}}'
                    lines.append(f"{name}{qlabels} {_fmt(block[p])}")
                count = block["count"]
                lines.append(f"{name}_sum{labels} "
                             f"{_fmt(block['mean'] * count)}")
                lines.append(f"{name}_count{labels} {count}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "accelerate-tpu-metrics/1"

    def do_GET(self):  # noqa: N802 (http.server API)
        plane = self.server.plane  # type: ignore[attr-defined]
        if self.path.split("?", 1)[0] == "/metrics":
            # Count the scrape BEFORE rendering so the exporter observes its
            # own traffic — a scrape that reads 0 of its own counter would
            # hide a misconfigured double-scraper forever.
            plane.inc(M_EXPORTER_SCRAPES_TOTAL, endpoint="metrics")
            body = prometheus_text(plane).encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path.split("?", 1)[0] == "/healthz":
            plane.inc(M_EXPORTER_SCRAPES_TOTAL, endpoint="healthz")
            body = json.dumps({
                "ok": True,
                "enabled": plane.enabled,
                "records_consumed": plane.records_consumed,
            }).encode("utf-8")
            ctype = "application/json; charset=utf-8"
        else:
            self.send_error(404, "try /metrics or /healthz")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes are not stdout events
        pass


class MetricsExporter:
    """The optional HTTP scrape endpoint over one plane.

    Serves on a daemon thread; ``port=0`` picks a free port (read it back
    from :attr:`port` after :meth:`start` — how the tests run hermetically).
    Never constructed implicitly: exporting is an explicit deployment
    decision (see the module docstring's security note)."""

    def __init__(self, plane: MetricsPlane, host: str = "127.0.0.1",
                 port: int = 0):
        self.plane = plane
        self.host = host
        self._requested_port = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        """The bound port (None before :meth:`start`)."""
        return None if self._server is None else self._server.server_address[1]

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            raise RuntimeError("exporter already started")
        self._server = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler
        )
        self._server.plane = self.plane  # type: ignore[attr-defined]
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        return (f"MetricsExporter(host={self.host!r}, port={self.port}, "
                f"running={self.running})")
