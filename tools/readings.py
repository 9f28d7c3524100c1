#!/usr/bin/env python3
"""How far each CUDA kernel lands from its plain version over many random
inputs, on the card: the readings behind ``chip_smoke.rel_bound``.

    python3 tools/readings.py [--draws N]      # from the root of a checkout

For every phase-3 case of ``chip_smoke.py`` (kernel, shape, dtype) it draws
N fresh inputs (generator seeds 1..N) and prints the worst and the median of
max|err| / rms(out) over the draws, beside the case's bound.  For
batched_update and batched_geqrt in f32 it also prints how far the kernel
and the f32 plain version each land from the plain version run in f64 on
the same inputs (whether a reading is the kernel's rounding or both's).
Imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import ggr_panel, ggr_update

    plain = {"batched_update": ggr_update.batched_update_plain,
             "batched_geqrt": ggr_panel.batched_geqrt_plain}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    for name, shape, param, dname in chip_smoke.PHASE3:
        dtype = getattr(torch, dname)
        rels, own, own_plain = [], [], []
        for seed in range(1, args.draws + 1):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            case = chip_smoke.KernelCase(name, shape, param, dtype, gen)
            case.compare(quiet=True)
            rels.append(case.rel)
            if name in plain and dtype == torch.float32:
                ref64 = plain[name](case.x.double(), param)
                rms64 = float(ref64.square().mean().sqrt())
                own.append(float((case.kernel().double() - ref64).abs().max()) / rms64)
                own_plain.append(
                    float((case.plain().double() - ref64).abs().max()) / rms64)
        f64 = (f"; vs f64: kernel worst {max(own):.2e}, plain f32 worst "
               f"{max(own_plain):.2e}" if own else "")
        print(f"  {name} {shape} {dname} param={param}: "
              f"max|err| / rms(out) worst {max(rels):.2e}, median "
              f"{statistics.median(rels):.2e} over {args.draws} draws; bound "
              f"{case.rel_tol:.1e}{f64}", flush=True)
    chip_smoke.FAILURES.clear()  # a reading over its bound is printed, not failed
    return 0


if __name__ == "__main__":
    sys.exit(main())
