"""40-cell x 2-mesh dry-run driver.

Runs each cell in a SUBPROCESS (``python -m repro_torch.launch.dryrun``: a
fresh fake process group, bounded memory, a per-cell timeout) and caches
JSON results under experiments/dryrun_torch/.  Re-runs only missing cells,
so the sweep is resumable.

    PYTHONPATH=src python -m repro_torch.launch.sweep [--multi-pod] [--both-meshes] \\
        [--only arch1,arch2] [--shapes train_4k,...] [--timeout 3600] [--jobs 2]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
RESULTS_DIR = os.path.join(_SRC, "..", "experiments", "dryrun_torch")


def cell_path(arch, shape, multi_pod, tag=""):
    pod = "pod2" if multi_pod else "pod1"
    suffix = f".{tag}" if tag else ""
    return os.path.abspath(os.path.join(RESULTS_DIR, f"{arch}__{shape}__{pod}{suffix}.json"))


def run_cell(arch, shape, multi_pod, probe=True, timeout=3600, extra=()):
    """(result, cached): a cell's result, read from its file when there is
    one, else run in a subprocess and written there; a timeout or a non-zero
    exit writes and returns ``{"error": ...}``."""
    out = cell_path(arch, shape, multi_pod)
    if os.path.exists(out):
        with open(out) as f:
            return json.load(f), True
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    if not probe:
        cmd.append("--no-probe")
    cmd.extend(extra)
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        result = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                  "error": f"timeout after {timeout}s"}
        with open(out, "w") as f:
            json.dump(result, f)
        return result, False
    if proc.returncode != 0:
        result = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                  "error": proc.stderr[-3000:]}
        with open(out, "w") as f:
            json.dump(result, f)
        return result, False
    with open(out) as f:
        return json.load(f), False


def main(argv=None):
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import list_archs
    from repro_torch.models.config import SHAPES

    ap = argparse.ArgumentParser(prog="repro_torch.launch.sweep")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip depth-probe correction (multi-pod pass)")
    ap.add_argument("--only", default=None)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=2)
    args = ap.parse_args(argv)

    archs = args.only.split(",") if args.only else list_archs()
    shapes = args.shapes.split(",") if args.shapes else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    cells = [(m, a, s) for m in meshes for a in archs for s in shapes]
    stats = {"ok": 0, "skip": 0, "err": 0}

    def work(cell):
        multi_pod, arch, shape = cell
        t0 = time.time()
        # roofline table is single-pod only: probe there, skip on multi-pod
        probe = (not args.no_probe) and (not multi_pod)
        res, cached = run_cell(arch, shape, multi_pod, probe=probe, timeout=args.timeout)
        dt = time.time() - t0
        status = ("CACHED" if cached else
                  "SKIP" if "skipped" in res else
                  "ERR" if "error" in res else "OK")
        dom = res.get("roofline_seconds_corrected",
                      res.get("roofline_seconds", {})).get("dominant", "-")
        print(f"[{status:6s}] {arch:24s} {shape:12s} "
              f"{'pod2' if multi_pod else 'pod1'} dom={dom:10s} ({dt:.0f}s)",
              flush=True)
        stats["ok" if status in ("OK", "CACHED") else
              "skip" if status == "SKIP" else "err"] += 1

    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        list(ex.map(work, cells))
    print(f"\ndone: {stats['ok']} ok, {stats['skip']} skipped-by-design, "
          f"{stats['err']} errors")
    return 1 if stats["err"] else 0


if __name__ == "__main__":
    sys.exit(main())
