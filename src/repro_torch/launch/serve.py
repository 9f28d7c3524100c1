"""Batched LM serving loop: prefill stub + token-by-token decode with KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
        --batch 8 --tokens 32 --cache-len 2048            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --smoke \\
        --device cpu --batch 2 --tokens 4

Runs on the card unless ``--device cpu`` is given; with no CUDA device the
default raises.  Weights are random, drawn from a generator seeded with 0 on
the serving device.  The matmul weights are cast to the compute dtype once
at load (``transformer.compute_copy``: the bits of the reference's per-step
casts), and the embedding rows are gathered before they are cast.  Greedy
decoding; the first step is a warm-up and the rest are timed.  Prints
``<arch>: <tok/s> tok/s (batch B, <device>)`` and, on the card, the peak
memory allocated while loading and while decoding.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import serve as serve_mod
from repro_torch.models import transformer as tmod
from repro_torch.serve.dispatch import resolve_device


def load(cfg, batch: int, cache_len: int, device) -> tuple:
    """(params, cache) of a freshly drawn model on ``device``, the params
    as ``compute_copy`` gives them; an enc-dec's cache holds the cross-
    attention K/V of 16 zero frames."""
    gen = torch.Generator(device=device).manual_seed(0)
    if cfg.family == "encdec":
        params = tmod.compute_copy(encdec_mod.init_encdec(cfg, gen), cfg)
        frames = torch.zeros((batch, 16, cfg.d_model), dtype=torch.float32, device=device)
        xk, xv = encdec_mod.precompute_cross_kv(
            params, encdec_mod.encode(params, frames, cfg), cfg)
        cache = serve_mod.init_cache(cfg, batch, cache_len, device=device)
        cache["xk"], cache["xv"] = xk.to(cache["xk"].dtype), xv.to(cache["xv"].dtype)
    else:
        params = tmod.compute_copy(tmod.init_lm(cfg, gen), cfg)
        cache = serve_mod.init_cache(cfg, batch, cache_len, device=device)
    return params, cache


def greedy_decode(params, cache, cfg, tok, steps: int) -> tuple:
    """``steps`` greedy decode steps from the (B,) tokens ``tok`` at
    positions 0, 1, ...: (the (steps, B) int32 tokens produced, the seconds
    of every step after the first, read after the device has finished)."""
    on_card = tok.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(tok.device)

    out = []
    t0 = None
    for i in range(steps):
        if i == 1:  # the first step is a warm-up
            sync()
            t0 = time.perf_counter()
        logits, _ = serve_mod.decode_step(params, cache, tok, i, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    sync()
    return torch.stack(out), (time.perf_counter() - t0 if t0 is not None else 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serving device (default: the card)")
    args = ap.parse_args(argv)
    if args.tokens < 2:
        ap.error("--tokens must be at least 2 (the first step is a warm-up)")

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"repro_torch.launch.serve: {e}")
    on_card = device.type == "cuda"
    cfg = get_config(args.arch, smoke=args.smoke)
    peak = {}
    with torch.inference_mode():
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        params, cache = load(cfg, args.batch, args.cache_len, device)
        if on_card:
            peak["load"] = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        tok = torch.zeros((args.batch,), dtype=torch.int32, device=device)
        _, dt = greedy_decode(params, cache, cfg, tok, args.tokens)
    name = torch.cuda.get_device_name(device) if on_card else "CPU"
    print(f"{args.arch}: {(args.tokens - 1) * args.batch / dt:.1f} tok/s "
          f"(batch {args.batch}, {name})")
    if on_card:
        peak["decode"] = torch.cuda.max_memory_allocated(device)
        print(f"{args.arch}: peak memory allocated " + ", ".join(
            f"{k} {v / 2**30:.2f} GiB" for k, v in peak.items()))


if __name__ == "__main__":
    main()
