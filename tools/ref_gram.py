#!/usr/bin/env python3
"""The JAX package's own reading of the tree QR summed at a bf16 / f16
tile's width, on the CPU: the witness for the port's trend in
``mixed_gram.py --accum tile``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/ref_gram.py [--sizes 1024,2048]

For each size n it factors an n x n f32 Gaussian matrix (numpy, seed 0)
with the JAX package's ``ggr_qr_blocked(schedule="tree")`` at
``Precision(t, t, t)`` and at ``Precision(t, "float32", t)``, t = bf16 and
f16, its Pallas kernels in interpret mode as its own tests run them, and
prints ``||A^T A - R^T R||_F / ||A^T A||_F`` (in f64) of each and their
ratio: ``tests/test_precision.py::test_mixed_accumulation_beats_all_bf16``
asks 1.5x of it on a 96 x 80 graded matrix.  Runs on the CPU only and
imports nothing of the port.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="1024,2048")
    args = ap.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax.numpy as jnp
    import numpy as np

    from repro.core.blocked import ggr_qr_blocked
    from repro.kernels.backend import Precision

    for n in (int(v) for v in args.sizes.split(",")):
        A = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
        A64 = A.astype(np.float64)
        AtA = A64.T @ A64
        for t in ("bfloat16", "float16"):
            res = {}
            for acc in (t, "float32"):
                t0 = time.perf_counter()
                R = ggr_qr_blocked(jnp.asarray(A), schedule="tree",
                                   precision=Precision(t, acc, t))
                R = np.triu(np.asarray(R.astype(jnp.float32), np.float64))
                res[acc] = float(np.linalg.norm(AtA - R.T @ R) / np.linalg.norm(AtA))
                print(f"  {n}x{n} tree ({t}, {acc}): gram residual {res[acc]:.4e} "
                      f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
            print(f"  {n}x{n} ({t}, {t}) over ({t}, float32): "
                  f"{res[t] / res['float32']:.3f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
