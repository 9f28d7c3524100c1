"""Deterministic, restartable synthetic token pipeline.

Every batch is a pure function of (seed, step), so a restarted job resumes
the exact stream from the checkpointed step with no data-loader state
beyond one integer.  Structure in the stream (a noisy integer random walk
wrapped to the vocab) gives the LM something learnable, so training curves
descend.

The JAX package's ``data/synthetic.py`` formula, drawn from a CPU
``torch.Generator`` seeded with a fixed 64-bit mix of (seed, step) — not
threefry's values — then moved to the caller's device, so every device sees
the same bits.
"""
from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, step: int) -> int:
    """The generator seed of batch ``step`` of stream ``seed``."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (step & _MASK64))


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def draws(self, step: int) -> tuple:
        """(steps, jumps), each (B, S + 1) int64 on the CPU: the walk's
        increments, uniform in [-3, 3], and its jumps, Bernoulli(0.05) x
        uniform in [0, vocab)."""
        g = torch.Generator().manual_seed(stream_seed(self.seed, int(step)))
        shape = (self.global_batch, self.seq_len + 1)
        steps = torch.randint(-3, 4, shape, generator=g)
        hit = torch.rand(shape, generator=g) < 0.05
        jumps = hit * torch.randint(0, self.vocab, shape, generator=g)
        return steps, jumps

    def batch_at(self, step: int, device="cuda") -> dict:
        """{tokens, labels} (B, S) int32 on ``device``: next-token prediction
        over a structured stream (``labels`` is ``tokens`` shifted by one)."""
        steps, jumps = self.draws(step)
        toks = (torch.cumsum(steps, dim=1) + jumps).abs() % self.vocab
        toks = toks.to(torch.int32)
        return {"tokens": toks[:, :-1].to(device), "labels": toks[:, 1:].to(device)}

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": int(step)}
