#!/usr/bin/env python3
"""Sweep the fused panel kernel's (B3, ``csrc/ggr_panel_factor.cu``) threads
per block and slab height on one CUDA card.

    python3 tools/panel_sweep.py 256x128 256x64 512x128   # THREADSxROWS ...

Each variant is a copy of ``src/repro_torch`` under ``build/tune/`` with
``kThreads`` / ``_PANEL_THREADS`` and ``_SLAB_ROWS`` set; all are built in
parallel, then each runs in its own process, one after another: B3 at the
fused frames of the 4096^2 QR (4096 down to 128 rows), the lstsq frame
(8192 rows), f64 and the ``ggr_qr_pallas`` frame, each checked against the
plain version (worst error of R, V, T over its rms) and timed with CUDA
events over 20 launches, then the fused 4096^2 f32 QR over 3 calls.  Each
line names the threads, slab rows and slab count its variant ran with, and
a variant whose constants are not found exactly once in the sources stops
the sweep.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRAMES = [(4096, 64, 0, "float32"), (8192, 64, 0, "float32"), (4096, 64, 0, "float64"),
          (4096, 32, 1024, "float32"), (2048, 64, 0, "float32"), (1024, 64, 0, "float32"),
          (512, 64, 0, "float32"), (256, 64, 0, "float32"), (128, 64, 0, "float32")]


def variant(threads: int, rows: int) -> Path:
    d = ROOT / "build" / "tune" / f"t{threads}_r{rows}"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT / "src" / "repro_torch", d / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    kern = d / "src/repro_torch/kernels"
    for path, pattern, value in [
            (kern / "csrc/ggr_panel_factor.cu", r"constexpr int kThreads = \d+;",
             f"constexpr int kThreads = {threads};"),
            (kern / "ggr_panel.py", r"_PANEL_THREADS = \d+", f"_PANEL_THREADS = {threads}"),
            (kern / "ggr_panel.py", r"_SLAB_ROWS = \d+", f"_SLAB_ROWS = {rows}")]:
        text, n = re.subn(pattern, value, path.read_text())
        if n != 1:  # a variant that kept the sources' value would be mislabeled
            raise SystemExit(f"{path.name}: {pattern!r} matched {n} times, not once")
        path.write_text(text)
    return d / "src"


def measure(src: str) -> None:
    sys.path.insert(0, src)
    import torch

    from repro_torch.core import ggr_qr_blocked
    from repro_torch.kernels import ggr_panel

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, b, p0, dt in FRAMES:
        X = torch.randn((1, m, b), generator=gen, device="cuda", dtype=getattr(torch, dt))
        got = ggr_panel.panel_factor(X, p0)
        want = ggr_panel.panel_factor_plain(X, p0)
        err = max(float((g - w).abs().max()) / float(w.double().square().mean().sqrt())
                  for g, w in zip(got, want))
        nblk, _ = ggr_panel._panel_blocks(m, b, X.element_size(),
                                          lambda smem: ggr_panel._panel_capacity(X, smem))
        t = ms(lambda: ggr_panel.panel_factor(X, p0), 20)
        print(f"({m},{b}) p0={p0} {dt} threads={ggr_panel._PANEL_THREADS} "
              f"slab_rows={ggr_panel._SLAB_ROWS} nblk={nblk} {t:.4f} ms "
              f"max|err|/rms {err:.1e}", flush=True)
    M = torch.randn((4096, 4096), generator=gen, device="cuda")
    print(f"fused qr 4096^2: {ms(lambda: ggr_qr_blocked(M, schedule='fused'), 3):.2f} ms",
          flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2])
        return 0
    variants = [tuple(map(int, v.split("x"))) for v in sys.argv[1:]] or [(256, 128)]
    srcs = {v: variant(*v) for v in dict.fromkeys(variants)}
    builds = [subprocess.Popen([sys.executable, "-c",
                                f"import sys; sys.path.insert(0, {str(s)!r}); "
                                "from repro_torch.kernels import _cuda; "
                                "_cuda.build(('ggr_panel_factor', 'ggr_apply'))"])
              for s in srcs.values()]
    if any([p.wait() for p in builds]):
        return 1
    for (threads, rows), src in srcs.items():
        print(f"=== threads {threads}, slab rows {rows}", flush=True)
        subprocess.run([sys.executable, __file__, "--measure", str(src)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
