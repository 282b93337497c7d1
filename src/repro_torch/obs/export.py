"""Telemetry egress: OpenMetrics exposition + scrape endpoint + snapshots.

Everything the obs stack records was, until now, reachable only as JSON
files on disk — no scrape-based monitoring stack (Prometheus, Grafana
agent, OpenTelemetry collectors) could consume it.  This module renders
any set of :class:`~repro_torch.obs.metrics.MetricRegistry` instances to
`OpenMetrics <https://openmetrics.io>`_ text:

* **counters** become ``<name>_total`` samples, **gauges** plain samples,
  **histograms** cumulative ``_bucket{le=...}`` series plus ``_count`` /
  ``_sum`` — with per-bucket **exemplars** (``# {trace_id="..."} v``)
  linking outlier buckets straight to request traces; **series** export
  their last value as a ``<name>_last`` gauge (iteration streams have no
  OpenMetrics type);
* registries are **merged**: the same (name, labels) series appearing in
  several live registries (e.g. two serving ``MatrixRegistry`` ledgers)
  sums counters/histograms and last-write-wins gauges, so the exposition
  never emits duplicate series — the aggregate matches what
  ``repro_torch.obs.dump()`` reports;
* metric/label names are sanitized to the OpenMetrics grammar
  (``serving.latency_s`` → ``serving_latency_s``), label values escaped.

Egress paths:

* :func:`serve` — a stdlib ``http.server`` scrape endpoint
  (``repro_torch.obs.export.serve(port)``; ``GET /metrics`` renders live state
  per scrape);
* :func:`write_prom` / :class:`FileExporter` — one-shot and periodic
  atomic file snapshots for air-gapped runs (point a node-exporter
  textfile collector at the output);
* :func:`parse_openmetrics` — a strict-enough parser used by tests and
  the CI scrape smoke to validate that the exposition actually parses.
"""
from __future__ import annotations

import math
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    Series,
    all_registries,
)

__all__ = [
    "CONTENT_TYPE",
    "render_openmetrics",
    "write_prom",
    "parse_openmetrics",
    "serve",
    "MetricsServer",
    "FileExporter",
]

# the content type Prometheus negotiates for OpenMetrics 1.0
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _family_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _label_name(name: str) -> str:
    out = _LABEL_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_val(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels_str(labels: Dict[str, str], extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = [(_label_name(k), str(v)) for k, v in sorted(labels.items())]
    if extra:
        pairs += extra
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


# --- collection: merge live registries into exposition families --------------


class _HistState:
    """Mergeable histogram accumulator (bounds must agree to merge)."""

    __slots__ = ("bounds", "counts", "count", "total", "exemplars")

    def __init__(self, h: Histogram):
        with h._lock:
            self.counts = h.bucket_counts.copy()
            self.count = h.count
            self.total = h.total
        self.bounds = h.bounds
        self.exemplars = {e["le"]: e for e in h.exemplars()}

    def merge(self, h: Histogram) -> bool:
        if not np.array_equal(self.bounds, h.bounds):
            return False
        with h._lock:
            self.counts = self.counts + h.bucket_counts
            self.count += h.count
            self.total += h.total
        for e in h.exemplars():  # later registries win per bucket
            self.exemplars[e["le"]] = e
        return True


def _collect_families(registries: Iterable[MetricRegistry]) -> Tuple[dict, int]:
    """Merge every metric into ``{family: {"type", "samples"}}``.

    ``samples`` maps a sorted-label key to the merged sample state;
    returns the family dict plus a count of metrics dropped because they
    could not merge (type conflict across registries, histogram bucket
    bounds mismatch) — surfaced as ``repro_export_dropped`` in the
    exposition so silent loss is visible to the scraper.
    """
    families: Dict[str, dict] = {}
    dropped = 0
    for reg in registries:
        for m in reg.metrics():
            if isinstance(m, Counter):
                kind = "counter"
            elif isinstance(m, Gauge):
                kind = "gauge"
            elif isinstance(m, Histogram):
                kind = "histogram"
            elif isinstance(m, Series):
                kind = "gauge"
            else:  # pragma: no cover - no other metric types exist
                continue
            fam = _family_name(m.name + ("_last" if isinstance(m, Series) else ""))
            f = families.setdefault(fam, {"type": kind, "samples": {}})
            if f["type"] != kind:
                dropped += 1
                continue
            lk = tuple(sorted((str(k), str(v)) for k, v in m.labels.items()))
            samples = f["samples"]
            if isinstance(m, Counter):
                samples[lk] = samples.get(lk, 0.0) + m.value
            elif isinstance(m, Gauge):
                samples[lk] = m.value
            elif isinstance(m, Series):
                pts = m.points
                if pts:
                    samples[lk] = pts[-1][1]
            else:
                st = samples.get(lk)
                if st is None:
                    samples[lk] = _HistState(m)
                elif not st.merge(m):
                    dropped += 1
    return families, dropped


def render_openmetrics(registries: Optional[Iterable[MetricRegistry]] = None) -> str:
    """Render ``registries`` (default: every live one) as OpenMetrics text.

    Deterministic: families sorted by name, samples by label key — two
    renders of the same state are byte-identical, so CI artifacts diff
    cleanly.
    """
    regs = all_registries() if registries is None else list(registries)
    families, dropped = _collect_families(regs)
    if dropped:
        families.setdefault(
            "repro_export_dropped", {"type": "gauge", "samples": {(): float(dropped)}}
        )
    lines: List[str] = []
    for fam in sorted(families):
        f = families[fam]
        samples = f["samples"]
        if not samples:
            continue
        lines.append(f"# TYPE {fam} {f['type']}")
        for lk in sorted(samples):
            labels = dict(lk)
            st = samples[lk]
            if f["type"] == "counter":
                lines.append(f"{fam}_total{_labels_str(labels)} {_fmt_val(st)}")
            elif f["type"] == "gauge":
                lines.append(f"{fam}{_labels_str(labels)} {_fmt_val(st)}")
            else:  # histogram
                cum = 0
                n_bounds = st.bounds.size
                for i in range(n_bounds + 1):
                    c = int(st.counts[i])
                    cum += c
                    le = float(st.bounds[i]) if i < n_bounds else math.inf
                    ex = st.exemplars.get(le)
                    last = i == n_bounds
                    # sparse exposition: only buckets where the cumulative
                    # count moves, plus exemplar carriers and +Inf (legal —
                    # le values are an arbitrary ascending subset)
                    if c == 0 and ex is None and not last:
                        continue
                    le_str = "+Inf" if last else _fmt_val(le)
                    line = (
                        f"{fam}_bucket"
                        f"{_labels_str(labels, extra=[('le', le_str)])} {cum}"
                    )
                    if ex is not None:
                        line += (
                            f' # {{trace_id="{_escape(ex["trace_id"])}"}}'
                            f" {_fmt_val(ex['value'])}"
                        )
                    lines.append(line)
                lines.append(f"{fam}_count{_labels_str(labels)} {st.count}")
                lines.append(f"{fam}_sum{_labels_str(labels)} {_fmt_val(st.total)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_prom(path, registries: Optional[Iterable[MetricRegistry]] = None) -> str:
    """Atomically write the exposition to ``path``; returns the text.

    Write-then-rename so a scraper of the file (node-exporter textfile
    collector) never reads a torn snapshot.
    """
    text = render_openmetrics(registries)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return text


# --- the scrape endpoint -----------------------------------------------------


class MetricsServer:
    """Stdlib HTTP scrape endpoint serving live OpenMetrics text.

    ``GET /metrics`` (or ``/``) renders the registries at scrape time —
    every scrape sees current state, no background sampling thread.  The
    server runs on a daemon thread; :meth:`close` shuts it down.  Usable
    as a context manager.
    """

    def __init__(
        self,
        port: int = 0,
        addr: str = "127.0.0.1",
        registries: Optional[Iterable[MetricRegistry]] = None,
    ):
        regs = None if registries is None else list(registries)

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler contract)
                if self.path.split("?")[0] not in ("/", "/metrics"):
                    self.send_error(404, "scrape /metrics")
                    return
                body = render_openmetrics(regs).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-scrape stderr noise
                pass

        self._httpd = ThreadingHTTPServer((addr, port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-metrics", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


def serve(
    port: int = 0,
    addr: str = "127.0.0.1",
    registries: Optional[Iterable[MetricRegistry]] = None,
) -> MetricsServer:
    """Start the scrape endpoint; returns the running :class:`MetricsServer`.

    ``port=0`` binds an ephemeral port (read it back from ``.port``) —
    the test/CI-friendly default; a deployment passes its scrape port.
    """
    return MetricsServer(port=port, addr=addr, registries=registries)


# --- periodic file snapshots (air-gapped mode) -------------------------------


class FileExporter:
    """Write the exposition to a file every ``interval_s`` seconds.

    The air-gapped complement to :func:`serve`: no listener, just an
    atomically-replaced ``metrics.prom`` a sidecar can ship.  Writes once
    immediately on start; :meth:`stop` writes a final snapshot and joins
    the thread.
    """

    def __init__(
        self,
        path,
        interval_s: float = 30.0,
        registries: Optional[Iterable[MetricRegistry]] = None,
    ):
        self.path = path
        self.interval_s = interval_s
        self._registries = None if registries is None else list(registries)
        self._stop = threading.Event()
        write_prom(path, self._registries)
        self.writes = 1
        self._thread = threading.Thread(
            target=self._loop, name="repro-metrics-file", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            write_prom(self.path, self._registries)
            self.writes += 1

    def stop(self) -> None:
        """Final snapshot + shutdown (idempotent)."""
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join(timeout=5.0)
            write_prom(self.path, self._registries)
            self.writes += 1

    def __enter__(self) -> "FileExporter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.stop()
        return False


# --- validation parser -------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?"
    r"\s+(?P<value>\S+)"
    r"(?:\s+(?P<ts>[0-9.eE+-]+))?$"
)
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SUFFIXES = {
    "counter": ("_total",),
    "gauge": ("",),
    "histogram": ("_bucket", "_count", "_sum"),
}


_UNESCAPE_RE = re.compile(r'\\(.)')
_UNESCAPE_MAP = {'"': '"', "\\": "\\", "n": "\n"}


def _unescape(s: str) -> str:
    # single pass: sequential str.replace would re-interpret the 'n' after
    # an escaped backslash ("\\n" in the text is backslash + literal n)
    return _UNESCAPE_RE.sub(lambda m: _UNESCAPE_MAP.get(m.group(1), m.group(1)), s)


def _parse_labels(block: Optional[str]) -> Dict[str, str]:
    if not block:
        return {}
    return {k: _unescape(v) for k, v in _LABEL_PAIR_RE.findall(block)}


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)  # raises ValueError on garbage — that's the validation


def parse_openmetrics(text: str) -> Dict[str, dict]:
    """Parse (and thereby validate) OpenMetrics text.

    Returns ``{family: {"type": t, "samples": [{"name", "labels",
    "value", "exemplar"}]}}``.  Raises :class:`ValueError` on structural
    violations: missing ``# EOF``, samples outside a ``# TYPE`` family,
    suffixes illegal for the type, non-monotone histogram buckets, or a
    histogram without a ``+Inf`` bucket.  Deliberately strict — this is
    the CI gate that the exposition a real Prometheus would scrape
    actually parses.
    """
    lines = text.splitlines()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition must end with '# EOF'")
    families: Dict[str, dict] = {}
    current: Optional[str] = None
    for ln, raw in enumerate(lines[:-1], start=1):
        if not raw.strip():
            raise ValueError(f"line {ln}: blank lines are not allowed")
        if raw.startswith("#"):
            parts = raw.split()
            if len(parts) >= 2 and parts[1] in ("TYPE", "HELP", "UNIT"):
                if parts[1] == "TYPE":
                    if len(parts) != 4:
                        raise ValueError(f"line {ln}: malformed TYPE: {raw!r}")
                    _, _, fam, kind = parts
                    if kind not in _SUFFIXES:
                        raise ValueError(f"line {ln}: unknown type {kind!r}")
                    if fam in families:
                        raise ValueError(f"line {ln}: duplicate family {fam!r}")
                    families[fam] = {"type": kind, "samples": []}
                    current = fam
                continue
            raise ValueError(f"line {ln}: stray comment: {raw!r}")
        sample, exemplar = raw, None
        if " # " in raw:
            sample, ex_part = raw.split(" # ", 1)
            m = re.match(r"^(\{[^}]*\})\s+(\S+)(?:\s+(\S+))?$", ex_part)
            if m is None:
                raise ValueError(f"line {ln}: malformed exemplar: {ex_part!r}")
            exemplar = {
                "labels": _parse_labels(m.group(1)),
                "value": _parse_value(m.group(2)),
            }
        m = _SAMPLE_RE.match(sample.rstrip())
        if m is None:
            raise ValueError(f"line {ln}: malformed sample: {raw!r}")
        name = m.group("name")
        if current is None:
            raise ValueError(f"line {ln}: sample {name!r} outside any TYPE family")
        fam, kind = current, families[current]["type"]
        suffixes = _SUFFIXES[kind]
        if not any(name == fam + s for s in suffixes):
            raise ValueError(
                f"line {ln}: sample {name!r} does not belong to family "
                f"{fam!r} (type {kind})"
            )
        if exemplar is not None and not (
            kind == "histogram" and name == fam + "_bucket"
        ):
            raise ValueError(f"line {ln}: exemplar on a non-bucket sample")
        families[fam]["samples"].append(
            {
                "name": name,
                "labels": _parse_labels(m.group("labels")),
                "value": _parse_value(m.group("value")),
                "exemplar": exemplar,
            }
        )
    for fam, f in families.items():
        if f["type"] != "histogram":
            continue
        series: Dict[tuple, list] = {}
        for s in f["samples"]:
            if s["name"] != fam + "_bucket":
                continue
            lk = tuple(sorted((k, v) for k, v in s["labels"].items() if k != "le"))
            series.setdefault(lk, []).append(s)
        for lk, buckets in series.items():
            les = [_parse_value(s["labels"]["le"]) for s in buckets]
            counts = [s["value"] for s in buckets]
            if les != sorted(les):
                raise ValueError(f"{fam}{dict(lk)}: bucket le values not ascending")
            if counts != sorted(counts):
                raise ValueError(f"{fam}{dict(lk)}: bucket counts not cumulative")
            if not les or not math.isinf(les[-1]):
                raise ValueError(f"{fam}{dict(lk)}: missing le=\"+Inf\" bucket")
    return families
