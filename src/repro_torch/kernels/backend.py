"""Shared kernel policy: precision policies and the degraded-mode schedule.

In the port **the tensor's device decides** how a kernel entry point runs: a
CPU tensor takes the kernel's plain PyTorch version, a CUDA tensor takes the
hand-written CUDA kernel or raises.  There is no interpret switch and no
override that puts the plain version on the card.  With an ``obs``
collector installed, each decision is counted as
``kernels.interpret_resolutions`` under the JAX package's mode names:
``"compiled"`` for the CUDA kernel, ``"interpret"`` for the plain version.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs import _state as _obs_state

__all__ = ["degraded_mode", "forced_schedule", "Precision", "resolve_precision",
           "DEFAULT_PRECISION", "count_resolution", "dtype_name", "torch_dtype"]

# Programmatic degraded-mode overrides (see ``degraded_mode``).
_DEGRADED: dict = {}


@contextlib.contextmanager
def degraded_mode(schedule: str | None = None):
    """Force a slower-but-safer kernel configuration for the enclosed calls.

    ``schedule="tree"`` — blocked drivers ignore their ``schedule`` argument
    and run the requested schedule; the lever reaches code paths whose
    kernel knobs are not threaded through the caller's signature (e.g. the
    blocked driver inside ``ggr_lstsq`` under a batched executor).

    Re-entrant; inner contexts shadow outer ones and the previous state is
    restored on exit.  Not thread-safe by design — the serving engine is a
    single-threaded loop.
    """
    saved = dict(_DEGRADED)
    if schedule is not None:
        if schedule not in ("tree", "fused"):
            raise ValueError(f"unknown degraded schedule {schedule!r}")
        _DEGRADED["schedule"] = schedule
    try:
        yield
    finally:
        _DEGRADED.clear()
        _DEGRADED.update(saved)


def forced_schedule() -> str | None:
    """The ``degraded_mode`` schedule override, or None outside one."""
    return _DEGRADED.get("schedule")


def count_resolution(x: torch.Tensor) -> None:
    """Count one kernel entry point's device decision for ``x`` when an
    ``obs`` collector is installed (``kernels.interpret_resolutions``,
    ``mode="compiled"`` on a CUDA tensor, ``"interpret"`` on a CPU one)."""
    reg = _obs_state._active()
    if reg.enabled:
        reg.counter("kernels.interpret_resolutions",
                    mode="interpret" if x.device.type == "cpu" else "compiled").inc()


_CANON = {
    "f64": "float64", "float64": "float64", "double": "float64",
    "f32": "float32", "float32": "float32", "single": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "float16": "float16", "half": "float16",
}


def dtype_name(dtype) -> str:
    """Canonical dtype name (``"float32"``) of a torch/numpy dtype or name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        name = dtype.removeprefix("torch.")
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            raise TypeError(f"unrecognized dtype {dtype!r}") from None
    if name not in _CANON:
        raise TypeError(f"unrecognized dtype {dtype!r}")
    return _CANON[name]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a torch/numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype_name(dtype))


class Precision(NamedTuple):
    """Mixed-precision policy for the GGR kernels and drivers.

    Dtypes are stored as canonical *names* (``"float32"``, ``"bfloat16"``,
    ...) so a ``Precision`` is hashable.

    - ``compute_dtype``: tile element dtype — the DET2 grid multiplies and
      trailing GEMMs run at this width.
    - ``accum_dtype``: suffix-norm / rotation-coefficient accumulation dtype
      inside kernel bodies.  Must be at least as wide as ``compute_dtype``.
    - ``store_dtype``: at-rest dtype for serving-side ``(R, d)`` states.
    """

    compute_dtype: str = "float32"
    accum_dtype: str = "float32"
    store_dtype: str = "float32"

    @property
    def compute(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def accum(self) -> torch.dtype:
        return torch_dtype(self.accum_dtype)

    @property
    def store(self) -> torch.dtype:
        return torch_dtype(self.store_dtype)

    @property
    def is_mixed(self) -> bool:
        return self.compute_dtype != self.accum_dtype


# Named policies: low-precision tiles always accumulate in float32, full
# precision policies are uniform.
_ALIASES = {
    "float64": Precision("float64", "float64", "float64"),
    "float32": Precision("float32", "float32", "float32"),
    "bfloat16": Precision("bfloat16", "float32", "bfloat16"),
    "float16": Precision("float16", "float32", "float16"),
}
_ALIASES["mixed_bf16"] = _ALIASES["bfloat16"]
_ALIASES["mixed_f16"] = _ALIASES["float16"]

DEFAULT_PRECISION = _ALIASES["float32"]


def resolve_precision(precision: "Precision | str | None") -> Precision:
    """Resolve a ``precision`` argument to a validated :class:`Precision`.

    ``None`` means the uniform float32 policy.  Strings name a policy:
    ``"f32"``/``"f64"`` are uniform; ``"bf16"``/``"f16"`` (and the explicit
    ``"mixed_bf16"`` / ``"mixed_f16"`` spellings) select low-precision tiles
    with float32 accumulation.  A ``Precision`` passes through after
    canonicalization.

    Raises ``ValueError`` for unknown names or an ``accum_dtype`` narrower
    than ``compute_dtype``.
    """
    if precision is None:
        prec = DEFAULT_PRECISION
    elif isinstance(precision, str):
        key = _CANON.get(precision, precision)
        try:
            prec = _ALIASES[key]
        except KeyError:
            raise ValueError(
                f"unknown precision policy {precision!r}; expected one of "
                f"{sorted(set(_CANON) | {'mixed_bf16', 'mixed_f16'})} "
                "or a Precision instance") from None
    elif isinstance(precision, Precision):
        try:
            prec = Precision(*(dtype_name(f) for f in precision))
        except TypeError:
            raise ValueError(f"unrecognized dtype in {precision}") from None
    else:
        raise TypeError(
            f"precision must be None, str, or Precision; got {precision!r}")
    if torch.promote_types(prec.compute, prec.accum) != prec.accum:
        raise ValueError(
            f"accum_dtype {prec.accum_dtype!r} is narrower than "
            f"compute_dtype {prec.compute_dtype!r}")
    reg = _obs_state._active()
    if reg.enabled:
        reg.counter("kernels.precision_resolutions",
                    compute=prec.compute_dtype, accum=prec.accum_dtype).inc()
    return prec
