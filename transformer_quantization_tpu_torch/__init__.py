"""PyTorch/CUDA port of ``transformer_quantization_tpu``.

The package mirrors the JAX package's layout (``quant/``, ``ops/``,
``ops/kernels/``, ``models/``, ``training/``) so every module has a named
counterpart. It imports torch and numpy only. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; they
raise when a card is asked for and none is present.

Importing any module of the package first runs :func:`settle_vml`, so
every plain version on the CPU runs after it.
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


def settle_vml() -> None:
    """Call each MKL VML function that the plain versions use (``torch.tanh``,
    ``exp``, ``sqrt``, ``erfc`` on CPU tensors) once on one element, on
    the calling thread.

    The first VML call of a process can race between ATen's OpenMP
    threads: under load one thread's chunk of that first call came out of
    a low-accuracy path (tanh off by up to 9e-5 on ~68,000 of 136,000
    elements, 7 of 64 processes running 8 at a time at 2 threads each),
    while every later call repeats the accurate bits. One serial call
    first leaves every later call on the accurate path (0 of 128
    processes)."""
    one = torch.ones(1)
    for fn in (torch.tanh, torch.exp, torch.sqrt, torch.special.erfc):
        fn(one)


settle_vml()
