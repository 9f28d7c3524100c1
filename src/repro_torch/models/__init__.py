"""Model zoo: dense GQA transformers, MoE, xLSTM, Mamba2 hybrids, enc-dec.

The core is plain functions over the JAX package's parameter tree in its
stacked layout (``transformer``, ``encdec``, ``serve``).  ``LM`` and
``EncDec`` register the same tensors as ``nn.Module`` parameters named by
their tree paths (``layers.attn.wq``); ``tree()`` gives the nested dict
back without copying.
"""
from __future__ import annotations

import torch
from torch import nn

from . import encdec, serve, transformer
from .config import SHAPES, ArchConfig, ShapeConfig

__all__ = ["ArchConfig", "EncDec", "LM", "SHAPES", "ShapeConfig"]


class _Node(nn.Module):
    """One dict of the tree: sub-dicts as child modules, tensors as
    parameters.  They are registered without ``requires_grad``: training
    takes gradients over detached views of the tree's leaves
    (``train.step.value_and_grad``, every leaf), so a module serves
    without building a graph."""

    def __init__(self, tree: dict):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Node(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        return {k: (getattr(self, k).tree() if k in self._modules else getattr(self, k))
                for k in self._keys}


class _Model(nn.Module):
    def __init__(self, cfg: ArchConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.params = _Node(tree)

    def tree(self) -> dict:
        """The parameter tree the functions take; its leaves are this
        module's parameters themselves."""
        return self.params.tree()

    @classmethod
    def from_tree(cls, cfg: ArchConfig, tree: dict, device="cuda"):
        """Wrap a parameter tree whose leaves are tensors or numpy arrays
        (the JAX package's parameters, as numpy): tensors stay where they
        are, arrays go to ``device`` through ``repro_torch.convert``."""
        from repro_torch.convert import from_numpy

        def leaves_to_tensors(t):
            if isinstance(t, dict):
                return {k: leaves_to_tensors(v) for k, v in t.items()}
            return t if isinstance(t, torch.Tensor) else from_numpy(t, device=device)

        return cls(cfg, leaves_to_tensors(tree))

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """A zero decode cache on the parameters' device."""
        dev = next(self.parameters()).device
        return serve.init_cache(self.cfg, batch, seq_len, device=dev)

    def decode_step(self, cache, token, pos):
        return serve.decode_step(self.tree(), cache, token, pos, self.cfg)


class LM(_Model):
    """Decoder-only LM (dense / moe / vlm / hybrid / ssm)."""

    def forward(self, tokens, patch_embs=None):
        """Logits (B, S, vocab) of a prefill; with ``patch_embs`` (vlm) the
        image positions come first."""
        p, cfg = self.tree(), self.cfg
        if patch_embs is not None:
            embeds = transformer.forward_vlm_embeds(p, tokens, patch_embs, cfg)
        else:
            embeds = transformer.embed_tokens(p, tokens, cfg)
        return transformer.lm_head(p, transformer.forward_hidden(p, embeds, cfg), cfg)


class EncDec(_Model):
    """Encoder-decoder (seamless-m4t)."""

    def forward(self, frames, tokens):
        """Decoder logits (B, S, vocab) over ``tokens`` given encoder frames."""
        p, cfg = self.tree(), self.cfg
        h = encdec.decode_train(p, tokens, encdec.encode(p, frames, cfg), cfg)
        return transformer.lm_head(p, h, cfg)
