"""Prometheus text exposition (format 0.0.4) over the MeterRegistry
(counterpart of ``ratelimiter_tpu/observability/prometheus.py``).

Mapping (Micrometer-convention names like ``ratelimiter.storage.latency``
sanitize to ``ratelimiter_storage_latency``):

- ``Counter`` -> ``# TYPE <name>_total counter`` + one sample,
- ``Gauge``   -> ``# TYPE <name> gauge`` + one sample,
- ``Timer``   -> ``# TYPE <name>_seconds histogram``: cumulative
  ``_bucket{le="..."}`` lines from the log2 buckets (converted us ->
  seconds, the Prometheus base unit), ``_sum`` and ``_count``.  Bucket
  lines stop at the highest non-empty bucket; the mandatory
  ``le="+Inf"`` line always carries the full count.

``# HELP`` comes from the meter's registered description when one was
given, else from the :data:`METRIC_HELP` description table — so a meter
registered at a call site that omitted the description still documents
itself on the scrape.  HELP text escapes ``\\`` and newlines per the
exposition format.

**Labeled series.**  The registry's meters are unlabeled; per-tenant /
per-key-class series come from *collectors* — objects exposing
``prometheus_samples() -> [(name, kind, help, [(labels, value)])]``
(e.g. ``observability/telemetry.TelemetryPlane``).  Label VALUES are
escaped (``\\`` -> ``\\\\``, ``\"`` -> ``\\\"``, newline -> ``\\n``):
key-class labels arrive off the wire and must not be able to break the
exposition syntax.

The reference's golden test pins the exact output
shape; bucket monotonicity and ``_sum``/``_count`` consistency are
asserted over a live registry scrape.
"""

from __future__ import annotations

import re
from typing import List

from ratelimiter_tpu_torch.metrics.registry import Counter, Gauge, Timer

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: Fallback HELP text by metric name, used when the meter was registered
#: without a description.  Keep entries for names that are (or were)
#: registered description-less somewhere — a missing entry just means
#: the name echoes as its own HELP.
METRIC_HELP = {
    "ratelimiter.requests.allowed": "Sliding-window decisions allowed",
    "ratelimiter.requests.rejected": "Sliding-window decisions rejected",
    "ratelimiter.tokenbucket.allowed": "Token-bucket decisions allowed",
    "ratelimiter.tokenbucket.rejected": "Token-bucket decisions rejected",
    "ratelimiter.cache.hits": "Local TTL-cache hits",
    "ratelimiter.storage.latency":
        "Device dispatch latency (per micro-batch)",
    "ratelimiter.decisions.allowed":
        "Fleet-wide allowed decisions (server + degraded + lease-local)",
    "ratelimiter.decisions.denied": "Fleet-wide denied decisions",
    "ratelimiter.decisions.shed":
        "Decisions refused by admission control",
    "ratelimiter.decisions.lease_local":
        "Fleet decisions decided client-side against token leases",
    "ratelimiter.telemetry.staleness_ms":
        "Age of the oldest client's last telemetry report",
}


def _metric_name(name: str) -> str:
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(value: str) -> str:
    """Exposition-format label-value escaping — label values (key
    classes!) come off the wire and may contain anything."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_metric_name(str(k))}="{_escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _help_for(name: str, description: str) -> str:
    return _escape_help(description or METRIC_HELP.get(name, name))


def _fmt(value: float) -> str:
    # Integral values print without a trailing .0 — bucket counts are
    # counts; +Inf/NaN spellings follow the exposition format.
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _le(bound_us: float) -> str:
    if bound_us == float("inf"):
        return "+Inf"
    return _fmt(bound_us / 1e6)


def render(registry, collectors=()) -> str:
    """The full exposition document for ``GET /actuator/prometheus``.

    ``collectors`` append labeled sample families after the registry's
    meters (see module docstring)."""
    lines: List[str] = []
    meters = registry.meters()
    for name in sorted(meters):
        meter = meters[name]
        base = _metric_name(name)
        help_text = _help_for(name, meter.description)
        if isinstance(meter, Counter):
            lines.append(f"# HELP {base}_total {help_text}")
            lines.append(f"# TYPE {base}_total counter")
            lines.append(f"{base}_total {_fmt(meter.count())}")
        elif isinstance(meter, Gauge):
            lines.append(f"# HELP {base} {help_text}")
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {_fmt(meter.value())}")
        elif isinstance(meter, Timer):
            lines.extend(_render_timer(base, help_text, meter))
    for collector in collectors:
        for name, kind, help_text, samples in collector.prometheus_samples():
            base = _metric_name(name)
            if kind == "counter":
                base += "_total"
            lines.append(f"# HELP {base} {_escape_help(help_text or name)}")
            lines.append(f"# TYPE {base} {kind}")
            for labels, value in samples:
                lines.append(f"{base}{_labels(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def _render_timer(base: str, help_text: str, timer: Timer) -> List[str]:
    name = f"{base}_seconds"
    counts = timer.bucket_counts()
    bounds = timer.bucket_bounds_us()
    total = sum(counts)
    # Highest non-empty bucket bounds the emitted ladder (64 lines of
    # zeros per timer would dominate the document); +Inf always closes.
    top = max((i for i, c in enumerate(counts) if c), default=-1)
    lines = [f"# HELP {name} {help_text}",
             f"# TYPE {name} histogram"]
    cum = 0
    for i in range(min(top + 1, len(bounds) - 1)):
        cum += counts[i]
        lines.append(
            f'{name}_bucket{{le="{_le(bounds[i])}"}} {cum}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {total}')
    lines.append(f"{name}_sum {_fmt(timer.total_us() / 1e6)}")
    lines.append(f"{name}_count {total}")
    return lines
