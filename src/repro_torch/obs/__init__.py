"""repro_torch.obs — metrics, trace spans, and flop accounting for every layer.

The JAX package's observability layer, ported: a metrics registry
(counters / gauges / exact-quantile histograms), span helpers over
``torch.profiler.record_function`` (+ NVTX on the card), wall-clock timers
that synchronize the device correctly around asynchronous CUDA work, and
exporters (JSONL snapshots + Prometheus text exposition) whose schema and
family names are the JAX package's, so one validator reads both.

The contract with the hot paths: **nothing is recorded unless a collector
is installed.**  The default registry is a shared no-op whose ``enabled``
is False; instrumentation sites guard every non-trivial step (blocking,
flop models, host transfers, spans) on that one attribute read, so serving
and factorization throughput are unchanged when nobody is watching.

Quick tour::

    from repro_torch import obs

    with obs.collecting() as reg:                 # install a collector
        server.flush()                            # instrumented layers record
        reg.histogram("my.latency").observe(0.2)  # or record directly

    line = obs.write_jsonl("metrics.jsonl", reg)  # snapshot (appends)
    text = obs.prometheus_text(reg)               # exposition text
    q99 = reg.find("serve.queue_wait_seconds", kind="append").quantile(0.99)

    with obs.span("repro/serve/flush/append"):    # profiler span
        out = dispatch(batch)
    with obs.device_timer() as t:                 # honest dispatch timing
        out = kernel(x)
        t.stop(out)                               # synchronize first
    obs.record_dispatch("serve", flops, t.seconds, kind="append")

Snapshot gate: ``python -m repro_torch.obs.export --validate
<snapshot.jsonl>``.
"""
from ._state import _active, collecting, install, uninstall
from .export import (
    REQUIRED_ASYNC_SERVE_FAMILIES,
    REQUIRED_RESILIENCE_FAMILIES,
    REQUIRED_SERVE_FAMILIES,
    load_jsonl,
    missing_families,
    prometheus_text,
    snapshot,
    write_jsonl,
    write_prometheus,
)
from .flops import (
    flops_by_dtype,
    ggr_append_flops,
    ggr_sweep_flops,
    lstsq_flops,
    record_dispatch,
)
from .health import (condition_estimate, factor_health,
                     maybe_sample_orthogonality, ortho_tolerance,
                     orthogonality_loss)
from .registry import (
    DEFAULT_BUCKETS,
    NULL,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
)
from .timing import block_ready, device_timer, time_dispatch
from .tracing import annotate_fn, named_span, span

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL",
    "NullRegistry",
    "REQUIRED_ASYNC_SERVE_FAMILIES",
    "REQUIRED_RESILIENCE_FAMILIES",
    "REQUIRED_SERVE_FAMILIES",
    "annotate_fn",
    "block_ready",
    "collecting",
    "condition_estimate",
    "counter",
    "device_timer",
    "enabled",
    "factor_health",
    "gauge",
    "flops_by_dtype",
    "ggr_append_flops",
    "ggr_sweep_flops",
    "histogram",
    "install",
    "load_jsonl",
    "lstsq_flops",
    "maybe_sample_orthogonality",
    "ortho_tolerance",
    "missing_families",
    "named_span",
    "orthogonality_loss",
    "prometheus_text",
    "record_dispatch",
    "registry",
    "snapshot",
    "span",
    "time_dispatch",
    "uninstall",
    "write_jsonl",
    "write_prometheus",
]


def registry():
    """The active registry (the no-op ``NULL`` unless one was installed)."""
    return _active()


def enabled() -> bool:
    """True iff a collecting registry is installed — THE hot-path guard."""
    return _active().enabled


def counter(name: str, /, **labels):
    """Counter series on the active registry (no-op handle when disabled)."""
    return _active().counter(name, **labels)


def gauge(name: str, /, **labels):
    """Gauge series on the active registry (no-op handle when disabled)."""
    return _active().gauge(name, **labels)


def histogram(name: str, /, **labels):
    """Histogram series on the active registry (no-op handle when disabled)."""
    return _active().histogram(name, **labels)
