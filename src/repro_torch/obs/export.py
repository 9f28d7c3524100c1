"""Exporters: JSONL snapshots and Prometheus text exposition.

JSONL snapshot schema (one JSON object per line, append-mode friendly so a
long-running server can snapshot every N flushes into one file)::

    {"schema": "repro.obs/v1", "ts": <unix seconds>, "meta": {...},
     "metrics": [
       {"name": "...", "type": "counter",   "labels": {...}, "value": 12},
       {"name": "...", "type": "gauge",     "labels": {...}, "value": 0.4,
        "min": 0.1, "max": 0.9, "updates": 7},
       {"name": "...", "type": "histogram", "labels": {...}, "count": 5,
        "sum": 0.93, "min": ..., "max": ...,
        "quantiles": {"0.5": ..., "0.9": ..., "0.99": ...}},
     ]}

``load_jsonl`` reads it back; ``missing_families`` is the CI gate
(``python -m repro_torch.obs.export --validate path.jsonl`` exits nonzero when a
required metric family is absent — see ``REQUIRED_SERVE_FAMILIES``).

Prometheus text exposition follows the standard format: family names are
sanitized (dots become underscores), histograms emit cumulative ``_bucket``
series plus ``_sum``/``_count``, gauges and counters emit one sample each.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

from .registry import DEFAULT_BUCKETS

__all__ = [
    "snapshot",
    "write_jsonl",
    "load_jsonl",
    "prometheus_text",
    "write_prometheus",
    "missing_families",
    "REQUIRED_SERVE_FAMILIES",
    "REQUIRED_ASYNC_SERVE_FAMILIES",
    "REQUIRED_RESILIENCE_FAMILIES",
]

SCHEMA = "repro.obs/v1"

# the metric families one instrumented `serve_qr --check` run must emit (the
# same names as the JAX package's, so one validator reads both packages'
# snapshots); `chip_smoke.py` fails when a snapshot is missing any of them.
REQUIRED_SERVE_FAMILIES = (
    "serve.queue_wait_seconds",
    "serve.flush_duration_seconds",
    "serve.dispatch_seconds",
    "serve.queue_depth",
    "serve.padding_waste",
    "serve.batch_size",
    "serve.requests_served",
    "serve.achieved_gflops",
)

# what an instrumented open-loop run must additionally emit: the
# continuous-batching close-reason counter plus both admission outcomes.
REQUIRED_ASYNC_SERVE_FAMILIES = REQUIRED_SERVE_FAMILIES + (
    "serve.batch_close",
    "serve.admission_rejected",
    "serve.requests_shed",
)

# what an instrumented run of the resilient dispatcher must additionally
# emit: the failure-domain, retry/degrade, quarantine and eager-purge
# counters plus the circuit-breaker state gauge.
REQUIRED_RESILIENCE_FAMILIES = (
    "serve.chunk_failures",
    "serve.retries",
    "serve.breaker_state",
    "serve.degraded_dispatches",
    "serve.quarantined",
    "serve.cycles_purged",
)

_PRESETS = {
    "serve": REQUIRED_SERVE_FAMILIES,
    "async": REQUIRED_ASYNC_SERVE_FAMILIES,
    "chaos": REQUIRED_SERVE_FAMILIES + REQUIRED_RESILIENCE_FAMILIES,
}

_QUANTILES = (0.5, 0.9, 0.99)


def _finite(x):
    """JSON has no inf/nan; snapshot them as None."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def _metric_dict(m) -> dict:
    entry = {"name": m.name, "type": m.kind, "labels": dict(m.labels)}
    if m.kind == "counter":
        entry["value"] = m.value
    elif m.kind == "gauge":
        entry.update(value=_finite(m.value), min=_finite(m.min),
                     max=_finite(m.max), updates=m.updates)
    elif m.kind == "histogram":
        entry.update(
            count=m.count, sum=m.sum, min=_finite(m.min), max=_finite(m.max),
            quantiles={str(q): _finite(m.quantile(q)) for q in _QUANTILES},
        )
    else:  # pragma: no cover — registry only holds the three kinds
        raise TypeError(f"cannot export metric kind {m.kind!r}")
    return entry


def snapshot(registry, meta: dict | None = None) -> dict:
    """One schema-versioned snapshot dict of every series in ``registry``."""
    return {
        "schema": SCHEMA,
        "ts": time.time(),
        "meta": dict(meta or {}),
        "metrics": [_metric_dict(m) for m in registry.collect()],
    }


def write_jsonl(path: str, registry, meta: dict | None = None) -> dict:
    """Append one snapshot line to ``path``; returns the snapshot dict."""
    snap = snapshot(registry, meta)
    with open(path, "a") as f:
        f.write(json.dumps(snap, sort_keys=True) + "\n")
    return snap


def load_jsonl(path: str) -> list[dict]:
    """Read snapshots back; raises ValueError on a schema mismatch."""
    snaps = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            snap = json.loads(line)
            if snap.get("schema") != SCHEMA:
                raise ValueError(
                    f"{path}:{i + 1}: schema {snap.get('schema')!r}, "
                    f"expected {SCHEMA!r}")
            snaps.append(snap)
    return snaps


def missing_families(snap: dict, required=REQUIRED_SERVE_FAMILIES) -> list[str]:
    """Required metric families absent from a snapshot dict (CI gate)."""
    present = {m["name"] for m in snap.get("metrics", ())}
    return [fam for fam in required if fam not in present]


# --------------------------------------------------------------- prometheus
def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_labels(labels, extra: dict | None = None) -> str:
    items = list(labels) + sorted((extra or {}).items())
    if not items:
        return ""
    body = ",".join(f'{_prom_name(k)}="{v}"' for k, v in items)
    return "{" + body + "}"


def _prom_value(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


def prometheus_text(registry, buckets=DEFAULT_BUCKETS) -> str:
    """Prometheus text exposition of every series in ``registry``."""
    lines = []
    typed: set[str] = set()
    for m in registry.collect():
        name = _prom_name(m.name)
        if name not in typed:
            prom_kind = m.kind if m.kind != "gauge" else "gauge"
            lines.append(f"# TYPE {name} {prom_kind}")
            typed.add(name)
        if m.kind == "counter":
            lines.append(f"{name}{_prom_labels(m.labels)} {_prom_value(m.value)}")
        elif m.kind == "gauge":
            lines.append(f"{name}{_prom_labels(m.labels)} {_prom_value(m.value)}")
        elif m.kind == "histogram":
            for le, cnt in m.buckets(buckets):
                le_s = "+Inf" if le == math.inf else repr(float(le))
                lines.append(
                    f"{name}_bucket{_prom_labels(m.labels, {'le': le_s})} {cnt}")
            lines.append(f"{name}_sum{_prom_labels(m.labels)} {_prom_value(m.sum)}")
            lines.append(f"{name}_count{_prom_labels(m.labels)} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, registry) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(registry))


def main(argv=None) -> None:
    """Snapshot validation CLI — the CI gate on serving metrics artifacts.

        python -m repro_torch.obs.export --validate serve_metrics.jsonl \\
            [--require fam1,fam2,...] [--preset serve|async]

    Exits nonzero if the file is unreadable, schema-mismatched, or its LAST
    snapshot is missing any required family (default: the serving set;
    ``--preset async`` gates on the continuous-batching superset).
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--validate", required=True, metavar="PATH",
                    help="JSONL snapshot file to validate")
    ap.add_argument("--require", default=None,
                    help="comma-separated metric families that must be "
                         "present (overrides --preset)")
    ap.add_argument("--preset", default="serve", choices=sorted(_PRESETS),
                    help="named required-family set (default: serve)")
    args = ap.parse_args(argv)

    required = (tuple(f for f in args.require.split(",") if f)
                if args.require else _PRESETS[args.preset])
    try:
        snaps = load_jsonl(args.validate)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        sys.exit(f"obs.export: cannot read {args.validate}: {e}")
    if not snaps:
        sys.exit(f"obs.export: {args.validate} holds no snapshots")
    missing = missing_families(snaps[-1], required)
    if missing:
        sys.exit(f"obs.export: {args.validate} missing required metric "
                 f"families: {', '.join(missing)}")
    print(f"obs.export: {args.validate} OK — {len(snaps)} snapshot(s), "
          f"{len(snaps[-1]['metrics'])} series, "
          f"all {len(required)} required families present")


if __name__ == "__main__":
    main()
