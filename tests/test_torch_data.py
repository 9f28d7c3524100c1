"""The port's synthetic token stream (``repro_torch.data``) against the JAX
package's ``data/synthetic.py``: the same formula over the port's own
draws, and the reference's stream properties (the counterpart of
``test_data_pipeline_deterministic_and_restartable``)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro_torch.data import SyntheticTokens
from repro_torch.data.synthetic import stream_seed


def test_deterministic_and_restartable():
    d1, d2 = SyntheticTokens(512, 16, 2, seed=9), SyntheticTokens(512, 16, 2, seed=9)
    b1, b2 = d1.batch_at(41, device="cpu"), d2.batch_at(41, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["labels"], b2["labels"])
    assert b1["tokens"].dtype == b1["labels"].dtype == torch.int32
    assert b1["tokens"].shape == b1["labels"].shape == (2, 16)
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 512
    # labels are the next-token shift of the same stream
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert not torch.equal(b1["tokens"], d1.batch_at(42, device="cpu")["tokens"])
    assert not torch.equal(b1["tokens"], SyntheticTokens(512, 16, 2, seed=10)
                           .batch_at(41, device="cpu")["tokens"])
    assert d1.state(41) == {"seed": 9, "step": 41}


def test_the_reference_stream_has_the_same_properties():
    ref = JaxSyntheticTokens(512, 16, 2, seed=9)
    b = {k: np.asarray(v) for k, v in ref.batch_at(41).items()}
    assert b["tokens"].dtype == np.int32 and b["tokens"].shape == (2, 16)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert ref.state(41) == SyntheticTokens(512, 16, 2, seed=9).state(41)


@pytest.mark.parametrize("seed,step", [(0, 0), (9, 41), (2**40 + 3, 123456789)])
def test_the_reference_formula_over_the_drawn_steps_and_jumps(seed, step):
    data = SyntheticTokens(97, 64, 3, seed=seed)
    steps, jumps = data.draws(step)
    assert int(steps.min()) >= -3 and int(steps.max()) <= 3
    assert int(jumps.min()) >= 0 and int(jumps.max()) < 97
    # the reference's lines, on these draws
    walk = jnp.cumsum(jnp.asarray(steps.numpy()), axis=1) + jnp.asarray(jumps.numpy())
    toks = np.asarray(jnp.abs(walk) % 97)
    got = data.batch_at(step, device="cpu")
    assert np.array_equal(got["tokens"].numpy(), toks[:, :-1].astype(np.int32))
    assert np.array_equal(got["labels"].numpy(), toks[:, 1:].astype(np.int32))


def test_draw_rates():
    """Increments uniform over [-3, 3], jumps at rate 0.05."""
    steps, jumps = SyntheticTokens(50_000, 4095, 8, seed=3).draws(5)
    counts = torch.bincount((steps + 3).flatten(), minlength=7).double() / steps.numel()
    assert torch.allclose(counts, torch.full((7,), 1 / 7, dtype=torch.float64), atol=3e-3)
    assert abs(float((jumps > 0).double().mean()) - 0.05) < 3e-3


def test_stream_seeds_differ():
    seeds = {stream_seed(s, k) for s in range(8) for k in range(256)}
    assert len(seeds) == 8 * 256
    assert all(0 <= x < 2**64 for x in seeds)


def test_the_default_device_is_the_card():
    assert inspect.signature(SyntheticTokens.batch_at).parameters["device"].default == "cuda"
