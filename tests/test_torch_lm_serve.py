"""The port's LM serving CLI (``python -m repro_torch.launch.serve``) and its
greedy loop against the JAX package's ``launch/serve.py`` loop."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import serve as jserve
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import LM

_REPO = Path(__file__).resolve().parents[1]
FAMILY_ARCH = {"dense": "olmo-1b", "moe": "mixtral-8x22b", "vlm": "phi-3-vision-4.2b",
               "hybrid": "zamba2-1.2b", "ssm": "xlstm-125m",
               "encdec": "seamless-m4t-large-v2"}


def _cli(*args):
    env = {"PYTHONPATH": str(_REPO / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, timeout=240)


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_cli_serves_each_family_on_the_cpu(family):
    arch = FAMILY_ARCH[family]
    r = _cli("--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--tokens", "4")
    assert r.returncode == 0, r.stderr
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith(f"{arch}: ") and line.endswith("tok/s (batch 2, CPU)"), line
    assert get_config(arch, smoke=True).family == family


def test_cli_without_a_card_fails_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default serves on it")
    r = _cli("--arch", "olmo-1b", "--smoke", "--batch", "2", "--tokens", "4")
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "tok/s" not in r.stdout


def test_greedy_tokens_equal_the_reference_loop():
    """olmo-1b smoke at float32 compute, the reference's PRNGKey(0)
    parameters carried across: the port's loop and the reference
    launcher's (``decode_step`` + argmax, jitted) pick the same 8 tokens."""
    jcfg = jax_get_config("olmo-1b", smoke=True).scaled(compute_dtype="float32")
    cfg = get_config("olmo-1b", smoke=True).scaled(compute_dtype="float32")
    params = jt.init_lm(jcfg, jax.random.PRNGKey(0))
    B, steps = 2, 8

    @jax.jit
    def step(params, cache, tok, pos):
        logits, cache = jserve.decode_step(params, cache, tok, pos, jcfg)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), cache

    cache = jserve.init_cache(jcfg, B, 16)
    tok, want = jnp.zeros((B,), jnp.int32), []
    for i in range(steps):
        tok, cache = step(params, cache, tok, jnp.int32(i))
        want.append(np.asarray(tok))

    model = LM.from_tree(cfg, jax.tree.map(np.asarray, params), device="cpu")
    got, _ = tlaunch.greedy_decode(model.tree(), model.init_cache(B, 16), cfg,
                                   torch.zeros((B,), dtype=torch.int32), steps)
    assert np.array_equal(got.numpy(), np.stack(want))
