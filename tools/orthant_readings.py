#!/usr/bin/env python3
"""The readings behind ``chip_smoke.py`` phase 9 (c)'s direction rule, with
those of two faulty directions: where the rule's factor sits between them.

    python3 tools/orthant_readings.py [--draws N]   # from the root of a checkout

For every matrix of the momentum of one Orthant step over olmo-1b's tree at
full width (seeded as phase 9 (c) seeds it), then N Gaussian 2048^2
matrices a condition number (cond 1e3 ... 1e6) whose smallest singular value
is moved to sigma_max / cond, it prints cond (float32 singular values of R) and
the two readings of ``repro_torch.testing.orthant_check.direction_readings``
— max|QᵀQ - I| and max|Q - Q_lib·D| — for the kernels' direction, the plain
versions', cuSOLVER's R in the same formula, and the two faulty directions
("flipped": the last column's sign flipped; "half": R of the matrix rounded
to float16).  Then, per group and over all (with each group's wall): the largest ratio of the kernels'
reading to the plain versions' and to cuSOLVER's (the sound side), and the
least ratio a faulty direction reaches over the plain versions' (the larger
of its two readings' ratios: the side a rule must catch).  Imports nothing
of the JAX package.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OLMO_SEED, OLMO_DEPTH = 92, 16  # chip_smoke.py phase 9 (c)'s draws


def ratios(rd: dict, name: str, ref: str):
    """Per matrix, the larger of the two readings' ratios name / ref."""
    import torch

    return torch.maximum(rd[name][0] / rd[ref][0], rd[name][1] / rd[ref][1])


def report(label: str, M, totals: dict) -> None:
    import torch

    from repro_torch.testing.orthant_check import direction_readings

    t0 = time.perf_counter()
    rd = direction_readings(M, faults=True)
    wall = time.perf_counter() - t0
    s = torch.linalg.svdvals(torch.linalg.qr(M if M.shape[-2] >= M.shape[-1] else M.mT,
                                             mode="r").R)
    cond = s[:, 0] / s[:, -1]
    for i in range(M.shape[0]):
        cells = ", ".join(f"{k} {float(v[0][i]):.3e} / {float(v[1][i]):.3e}"
                          for k, v in rd.items())
        print(f"    {label} {i}: cond {float(cond[i]):.3e}; {cells}")
    got = {"kernels/plain": float(ratios(rd, "kernels", "plain").max()),
           "kernels/cusolver": float(ratios(rd, "kernels", "cusolver").max()),
           "flipped/plain": float(ratios(rd, "flipped", "plain").min()),
           "half/plain": float(ratios(rd, "half", "plain").min())}
    for k, v in got.items():
        pick = min if k.split("/")[0] in ("flipped", "half") else max
        totals[k] = pick(totals.get(k, v), v)
    print(f"  {label}: worst kernels/plain {got['kernels/plain']:.2f}, "
          f"kernels/cuSOLVER {got['kernels/cusolver']:.2f}; least flipped/plain "
          f"{got['flipped/plain']:.3g}, half/plain {got['half/plain']:.3g} "
          f"({wall:.1f} s)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=4)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("orthant_readings.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.optim import orthant
    from repro_torch.testing.orthant_check import olmo_leaves, olmo_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    g = torch.Generator(device="cuda").manual_seed(OLMO_SEED)
    params = olmo_tree(g, OLMO_DEPTH, scale=True)
    grads = olmo_tree(g, OLMO_DEPTH, scale=False)
    _, state = orthant.update(grads, orthant.init(params), params, lr=0.02)
    del params, grads
    totals: dict = {}
    for key, mom in olmo_leaves(state.momentum).items():
        report(f"olmo-1b {key}", mom.reshape(-1, *mom.shape[-2:]), totals)
    del state
    n = 2048
    for cond in (1e3, 1e4, 1e5, 1e6):
        mats = []
        for seed in range(1, args.draws + 1):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            G = torch.randn((n, n), generator=gen, device="cuda", dtype=torch.float64)
            U, s, Vh = torch.linalg.svd(G)
            s[-1] = s[0] / cond
            mats.append(((U * s) @ Vh).float())
        report(f"cond {cond:.0e}", torch.stack(mats), totals)
    print("over all: " + ", ".join(f"{k} {'least' if k[0] in 'fh' else 'worst'} "
                                   f"{v:.3g}" for k, v in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
