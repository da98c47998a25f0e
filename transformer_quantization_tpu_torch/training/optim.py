"""optax's arithmetic, as the JAX package's trainer composes it, on lists
of tensors.

The JAX trainer (``transformer_quantization_tpu/training/trainer.py``
``make_optimizer``, ``training/qat.py`` ``make_optimizer``) builds
``optax.chain(clip_by_global_norm, adamw)`` (AdamW per label through
``optax.multi_transform``), wrapped in ``optax.MultiSteps`` for gradient
accumulation, over ``{"params": ..., "ranges": flat}``. :class:`Optimizer`
repeats those operations in the same order, element by element:

- ``clip_by_global_norm``: ``g * max / ||g||`` (as ``(g / ||g||) * max``)
  when ``||g|| >= max``, the norm over every leaf, params and ranges
  together;
- Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, each
  bias-corrected by ``1 - b^count``, the direction ``mu_hat / (sqrt(nu_hat)
  + eps)`` (eps outside the root); decoupled weight decay ``+ wd * p``;
  then ``-lr(count) *`` that, the schedule read at the update count before
  it is incremented (the first update uses ``lr(0)``);
- ``MultiSteps``: micro-batch gradients averaged as ``acc + (g - acc) /
  (n + 1)``, the inner update applied (and its counts advanced) once every
  ``accum`` micro-batches, no change to the leaves in between.

Schedules are optax's ``linear_schedule``, ``cosine_decay_schedule``,
``constant_schedule`` and ``join_schedules`` in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor
Schedule = Callable[[int], np.float32]

F32 = np.float32


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: ``(init - end) * (1 - c / steps) + end``
    with ``c`` the count clipped to ``[0, steps]``."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> np.float32:
        c = min(max(count, 0), transition_steps)
        frac = F32(1) - F32(c) / F32(transition_steps)
        return F32(init_value - end_value) * frac + F32(end_value)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule`` (alpha 0, exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int) -> np.float32:
        c = F32(min(count, decay_steps))
        cos = np.cos(F32(np.pi) * c / F32(decay_steps), dtype=np.float32)
        return F32(init_value) * (F32(0.5) * (F32(1) + cos))
    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: F32(value)


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: past a boundary the next schedule, read
    at the count less that boundary."""
    def schedule(count: int) -> np.float32:
        out = schedules[0](count)
        for boundary, sch in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sch(count - boundary)
        return out
    return schedule


@dataclasses.dataclass(frozen=True)
class Group:
    """One ``multi_transform`` label's AdamW: its learning-rate schedule
    and its decoupled weight decay (0: Adam)."""

    schedule: Schedule
    weight_decay: float = 0.0


@dataclasses.dataclass
class Optimizer:
    """Clip, AdamW per group, gradient accumulation; see the module
    docstring. ``labels[i]`` names leaf ``i``'s group."""

    groups: Dict[str, Group]
    labels: List[str]
    max_grad_norm: Optional[float] = None
    accum: int = 1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, leaves: Sequence[Tensor]) -> Dict:
        """The optimizer state: the update count, Adam's moments, and with
        accumulation the micro-step, the optimizer-step count and the
        gradient average."""
        zeros = [torch.zeros_like(p) for p in leaves]
        state = {"count": 0, "mu": zeros,
                 "nu": [torch.zeros_like(p) for p in leaves]}
        if self.accum > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc=[torch.zeros_like(p) for p in leaves])
        return state

    def update(self, grads: Sequence[Tensor], state: Dict,
               leaves: Sequence[Tensor]):
        """``(new leaves, new state)`` after one micro-batch's gradients."""
        grads = list(grads)
        if self.accum > 1:
            n = state["mini_step"]
            acc = [a + (g - a) / F32(n + 1)
                   for g, a in zip(grads, state["acc"])]
            if n < self.accum - 1:
                return list(leaves), dict(state, mini_step=n + 1, acc=acc)
            new_leaves, inner = self._step(acc, state, leaves)
            return new_leaves, dict(
                inner, mini_step=0, gradient_step=state["gradient_step"] + 1,
                acc=[torch.zeros_like(a) for a in acc])
        return self._step(grads, state, leaves)

    def _step(self, grads: List[Tensor], state: Dict,
              leaves: Sequence[Tensor]):
        if self.max_grad_norm is not None:
            sq = torch.stack([torch.sum(g * g) for g in grads]).sum()
            g_norm = torch.sqrt(sq)
            if not bool(g_norm < self.max_grad_norm):
                grads = [(g / g_norm) * self.max_grad_norm for g in grads]
        count = state["count"] + 1
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - self.b1),
                                torch._foreach_mul(state["mu"], self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads),
                               1 - self.b2),
            torch._foreach_mul(state["nu"], self.b2))
        bc1 = float(F32(1) - np.power(F32(self.b1), F32(count)))
        bc2 = float(F32(1) - np.power(F32(self.b2), F32(count)))
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        new_leaves = []
        for u, p, label in zip(upd, leaves, self.labels):
            grp = self.groups[label]
            if grp.weight_decay:
                u = u + grp.weight_decay * p
            new_leaves.append(p + float(-grp.schedule(state["count"])) * u)
        return new_leaves, dict(state, count=count, mu=list(mu), nu=list(nu))


def state_arrays(state: Dict) -> Dict[str, np.ndarray]:
    """An optimizer state as flat numpy arrays (for an ``.npz``)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, list):
            for i, t in enumerate(v):
                out[f"{k}/{i}"] = t.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def state_from_arrays(arrays: Dict[str, np.ndarray], template: Dict,
                      device) -> Dict:
    """Inverse of :func:`state_arrays`, shaped as ``template`` (a fresh
    :meth:`Optimizer.init`)."""
    out = {}
    for k, v in template.items():
        if isinstance(v, list):
            out[k] = [torch.from_numpy(np.array(arrays[f"{k}/{i}"])).to(device)
                      for i in range(len(v))]
        else:
            out[k] = int(arrays[k])
    return out
