"""PyTorch/CUDA port of ``transformer_quantization_tpu``.

The package mirrors the JAX package's layout (``quant/``, ``ops/``,
``ops/kernels/``, ``models/``, ``training/``) so every module has a named
counterpart. It imports torch and numpy only. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; they
raise when a card is asked for and none is present.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no card is available (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev
