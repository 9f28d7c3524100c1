#!/usr/bin/env python3
"""Registers and spills of every CUDA kernel instance, this checkout's
against another's, from ``nvcc -Xptxas -v`` with the port's own flags.

    python3 tools/ptxas_compare.py --base DIR      # from the root of a checkout

DIR is the root of another checkout (a parent unpacked with ``git archive``
under ``build/``).  Each source of both trees is compiled with
``repro_torch.kernels._cuda``'s flags, one ``nvcc`` a source, all at once,
into a temporary directory; every kernel instance is named by its demangled
signature (``cu++filt``), with a storage type that equals the compute type
dropped (``kernel<float, float>`` is the uniform instance that an older tree
names ``kernel<float>``) and a narrow flag that is off dropped
(``kernel<float, float, (bool)0>`` is an older tree's ``kernel<float,
float>``).  Prints each instance's registers, spill stores and loads and
stack frame in both trees, and exits non-zero when an
instance present in both differs.  Needs nvcc; runs on the machine with the
card.  Imports nothing of the JAX package.

Run it with any change to ``kernels/csrc`` that should leave some
instances as they were (a new instance, a new storage type): it is the
check that the f32 / f64 instances compile to the parent's code.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = Path("src/repro_torch/kernels/csrc")

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise SystemExit(f"ptxas_compare.py: {name} not found")
    return found


def reports(tree: Path, flags, tmp: Path) -> dict[str, str]:
    """{source: its ptxas report} for every .cu of ``tree``, built in parallel."""
    nvcc = _tool("nvcc")
    procs = {}
    for src in sorted((tree / CSRC).glob("*.cu")):
        out = tmp / f"{tree.name}-{src.stem}.so"
        procs[src.stem] = subprocess.Popen([nvcc, *flags, "-o", str(out), str(src)],
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {tree / CSRC / name}.cu:\n{logs[name]}")
    return logs


def _key(demangled: str) -> str:
    """``kernel<S, T, ...>`` with S dropped where S == T and a last ``(bool)0``
    (the narrow flag of B1's and B2's kernels, off) dropped, without its
    namespace, return type and parameters (template arguments such as
    ``(int)8`` hold parentheses, so the arguments end at the matching '>')."""
    s = demangled.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    s = s.removeprefix("void ").strip()
    lt = s.find("<")
    if lt < 0 or lt > s.find("(") >= 0:
        return s.split("(")[0]
    depth = 0
    for end in range(lt, len(s)):
        depth += {"<": 1, ">": -1}.get(s[end], 0)
        if depth == 0:
            break
    args = [a.strip() for a in s[lt + 1:end].split(",")]
    if len(args) > 1 and args[-1] in ("false", "(bool)0"):  # B1's / B2's narrow flag, off
        args = args[:-1]
    if len(args) > 1 and args[0] == args[1]:
        args = args[1:]
    return f"{s[:lt]}<{', '.join(args)}>"


def instances(logs: dict[str, str]) -> dict[str, tuple]:
    """{kernel instance: (registers, spill stores, spill loads, stack frame)}."""
    found, names = {}, []
    for log in logs.values():
        entry = None
        for line in log.splitlines():
            if (m := _ENTRY.search(line)):
                entry = m.group(1)
                names.append(entry)
                found[entry] = [None, None, None, None]
            elif entry and (m := _FRAME.search(line)):
                frame, stores, loads = (int(v) for v in m.groups())
                found[entry][1:] = [stores, loads, frame]
            elif entry and (m := _REGS.search(line)):
                found[entry][0] = int(m.group(1))
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                               capture_output=True, text=True, check=True).stdout.split("\n")
    return {_key(d): tuple(found[n]) for n, d in zip(names, demangled)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout to compare with")
    args = ap.parse_args()
    from repro_torch.kernels import _cuda

    base = Path(args.base).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        new = instances(reports(ROOT, _cuda._FLAGS, Path(tmp)))
        old = instances(reports(base, _cuda._FLAGS, Path(tmp)))
    print("instance: registers, spill stores / loads (bytes), stack frame (bytes); "
          f"this tree vs {base}")
    differ = []
    for key in sorted(set(new) | set(old)):
        a, b = new.get(key), old.get(key)
        mark = "same" if a == b else ("only here" if b is None else
                                      "only there" if a is None else "DIFFERS")
        if a is not None and b is not None and a != b:
            differ.append(key)
        print(f"  {key}: {a} vs {b} ({mark})")
    print(f"{len(differ)} instance(s) in both trees differ" + (f": {differ}" if differ else ""))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
