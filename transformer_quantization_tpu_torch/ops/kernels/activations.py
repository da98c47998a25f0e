"""Activation functions of the engine kernels' epilogues.

A copy of ``_erf`` / ``_gelu_exact`` / ``_gelu_new`` / ``_gelu_poly`` /
``_ACTS`` from ``transformer_quantization_tpu/ops/pallas/int_matmul.py``,
with the operations in the same order, so the plain engine versions match
the JAX oracles. ``gelu_new`` is ``0.5 * x * (1 + tanh(c * (x + 0.044715
* x * x * x)))`` with ``c = float32(sqrt(2/pi))``, which is not the
expression of ``jax.nn.gelu(approximate=True)``; the engine runs
``hidden_act='gelu'`` as this form. The CUDA matmul epilogue
(``csrc/int8_matmul.cu``) repeats the same order.
"""

from __future__ import annotations

import numpy as np
import torch

GELU_NEW_C = float(np.float32(np.sqrt(2.0 / np.pi)))


def _erf(x):
    # Abramowitz-Stegun 7.1.26 rational approximation (max abs err 1.5e-7)
    a1, a2, a3 = 0.254829592, -0.284496736, 1.421413741
    a4, a5, p = -1.453152027, 1.061405429, 0.3275911
    s = torch.sign(x)
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_exact(x):
    return 0.5 * x * (1.0 + _erf(x * float(np.float32(1.0 / np.sqrt(2.0)))))


def _gelu_new(x):
    # tanh-approximate gelu (ALBERT's gelu_new)
    return 0.5 * x * (1.0 + torch.tanh(
        GELU_NEW_C * (x + 0.044715 * x * x * x)))


# Even-part degree-10 polynomial GELU (see the JAX module for the fit)
_GELU_P10 = np.array(
    [1.7670614, 0.8885467, -0.23558326, 0.13436185, -0.10342609,
     0.12484333, -0.11978161, 0.01713814, -0.00230207, 0.08504884,
     -0.05600321], dtype=np.float32)
_GELU_UMAX = float(np.float32(25.0))


def _gelu_poly(x):
    u = torch.clamp(x * x, max=_GELU_UMAX)
    t = u * float(np.float32(2.0 / _GELU_UMAX)) - 1.0
    acc = torch.full_like(x, float(_GELU_P10[-1]))
    for c in _GELU_P10[-2::-1]:
        acc = acc * t + float(c)
    h = torch.where(x * x > _GELU_UMAX, 0.5 * torch.abs(x), acc)
    return 0.5 * x + h


ACTS = {
    None: None,
    "gelu": _gelu_exact,
    "gelu_new": _gelu_new,
    "gelu_poly10": _gelu_poly,
    "tanh": torch.tanh,
    "relu": torch.relu,
}
