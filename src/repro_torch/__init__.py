"""repro_torch — the GGR QR engine ported to PyTorch and CUDA for the H100.

Mirrors the JAX package ``repro`` module by module (``repro/X.py`` maps to
``repro_torch/X.py``) and never imports it, nor ``jax``.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU; a CPU tensor
takes each kernel's plain PyTorch version, a CUDA tensor the hand-written
kernel.
"""
