"""The port's arch registry (``repro_torch.configs``) and ``ArchConfig``
against the JAX package's: every field of every arch, full and smoke, the
parameter counts, the shapes and which cells run."""
import dataclasses

import pytest
import torch

from repro import configs as jax_configs
from repro.models.config import SHAPES as JAX_SHAPES
from repro_torch import configs
from repro_torch.models.config import SHAPES, ArchConfig


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_arch_config_equals_reference(arch, smoke):
    want = jax_configs.get_config(arch, smoke=smoke)
    got = configs.get_config(arch, smoke=smoke)
    assert isinstance(got, ArchConfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pdt.__repr__() == f"torch.{want.pdt.name}"
    assert got.cdt.__repr__() == f"torch.{want.cdt.name}"
    assert isinstance(got.pdt, torch.dtype) and isinstance(got.cdt, torch.dtype)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_registry_and_shapes():
    assert configs.list_archs() == jax_configs.list_archs()
    assert configs.ARCHS == jax_configs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for name in SHAPES:
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(jax_configs.get_shape(name))


def test_cell_is_runnable_agrees_on_every_cell():
    cells = [(a, s) for a in jax_configs.list_archs() for s in JAX_SHAPES]
    assert len(cells) == 40
    for arch, shape in cells:
        assert configs.cell_is_runnable(arch, shape) == \
            jax_configs.cell_is_runnable(arch, shape), (arch, shape)


def test_olmo_full_width_counts():
    """olmo-1b at its published widths: about 1.18 B parameters, 4.7 GB at
    float32 (tied embeddings)."""
    cfg = configs.get_config("olmo-1b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (16, 2048, 8192, 50304)
    assert cfg.param_count() == 16 * (4 * 2048 ** 2 + 3 * 2048 * 8192) + 50304 * 2048
    assert 1.17e9 < cfg.param_count() < 1.19e9


def test_orthant_olmo_tree_is_init_lm_s_layout():
    """The Orthant check's olmo-1b tree has exactly the paths, shapes and
    dtypes of the port's ``init_lm`` tree at full width (on ``meta``: no
    memory)."""
    from repro_torch.models import transformer
    from repro_torch.testing.orthant_check import OLMO, olmo_tree

    def layout(tree, path=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[f"{path}{k}/"] = None
                out.update(layout(v, f"{path}{k}/"))
            else:
                out[path + k] = (tuple(v.shape), v.dtype)
        return out

    cfg = configs.get_config("olmo-1b")
    assert OLMO == cfg
    gen = torch.Generator().manual_seed(0)
    want = layout(transformer.init_lm(cfg, gen, device="meta"))
    got = layout(olmo_tree(gen, depth=cfg.n_layers, scale=True, device="meta"))
    assert got == want
    assert want["layers/mlp/w2"] == ((16, 8192, 2048), torch.float32)
