"""Arch registry: ``--arch <id>`` resolution for all 10 assigned archs."""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig

ARCHS = {
    "nemotron-4-15b": "nemotron_4_15b",
    "granite-34b": "granite_34b",
    "olmo-1b": "olmo_1b",
    "stablelm-3b": "stablelm_3b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "arctic-480b": "arctic_480b",
    "mixtral-8x22b": "mixtral_8x22b",
    "zamba2-1.2b": "zamba2_1_2b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.make_smoke_config() if smoke else mod.make_config()


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]


def list_archs():
    return list(ARCHS)


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs; long_500k needs sub-quadratic attn."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "skipped: pure full-attention arch at 524k decode (see DESIGN.md)"
    return True, ""
