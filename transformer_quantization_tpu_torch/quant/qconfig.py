"""Site-addressable quantization configuration.

Counterpart of ``transformer_quantization_tpu/quant/qconfig.py``: a model
declares its quantization sites by name, and a hashable
:class:`QuantModelConfig` maps each name to a :class:`QuantSiteConfig`
(bits, method, estimator, axis). The ``quant_dict`` language
(``apply_quant_dict``) is not yet ported.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from transformer_quantization_tpu_torch.quant.quantizers import (
    QMethod,
    QuantizerSpec,
)
from transformer_quantization_tpu_torch.quant.ranges import (
    OptMethod,
    RangeEstimatorConfig,
    RangeMethod,
    ReduceSpec,
)


class Phase(enum.Enum):
    """Quantizer phase: ``estimate`` updates ranges from data then
    quantizes, ``fix`` quantizes with stored params. ``learn`` and
    ``record_ranges`` belong to the training and PEG slices."""

    estimate = "estimate"
    fix = "fix"
    learn = "learn"
    record_ranges = "record_ranges"


@dataclasses.dataclass(frozen=True)
class QuantMode:
    """Whole-model quantization state for one forward."""

    weight_quant: bool = True
    act_quant: bool = True
    weight_phase: Phase = Phase.fix
    act_phase: Phase = Phase.fix


@dataclasses.dataclass(frozen=True)
class QuantSiteConfig:
    """Static per-site configuration (one per weight or act quantizer)."""

    kind: str  # 'weight' | 'act'
    spec: QuantizerSpec = QuantizerSpec()
    range_cfg: RangeEstimatorConfig = RangeEstimatorConfig()
    enabled: bool = True
    per_channel: bool = False
    axis: Optional[int] = None
    n_groups: Optional[int] = None
    permute: bool = False

    @property
    def reduce_spec(self) -> ReduceSpec:
        return ReduceSpec(per_channel=self.per_channel, axis=self.axis,
                          n_groups=self.n_groups, permute=self.permute)

    def ranges_shape(self, x_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Reduced range/param shape for data of shape ``x_shape``."""
        if self.axis is not None:
            return (x_shape[self.axis],)
        if self.per_channel:
            return (x_shape[0],)
        return ()


@dataclasses.dataclass(frozen=True)
class QuantModelConfig:
    """Hashable mapping site-name -> :class:`QuantSiteConfig`."""

    sites: Tuple[Tuple[str, QuantSiteConfig], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "_by_name", dict(self.sites))

    def __getitem__(self, name: str) -> QuantSiteConfig:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def items(self):
        return self.sites

    def replace_site(self, name: str, **changes) -> "QuantModelConfig":
        if name not in self._by_name:
            raise KeyError(name)
        return QuantModelConfig(tuple(
            (n, dataclasses.replace(c, **changes) if n == name else c)
            for n, c in self.sites))


@dataclasses.dataclass(frozen=True)
class QuantDefaults:
    """Global quantization options (the CLI layer's defaults)."""

    method: QMethod = QMethod.asymmetric_uniform
    act_method: Optional[QMethod] = None  # None -> same as method
    n_bits: int = 8
    n_bits_act: Optional[int] = None
    per_channel_weights: bool = False
    percentile: Optional[float] = None
    weight_range_method: RangeMethod = RangeMethod.current_minmax
    weight_range_opt: OptMethod = OptMethod.grid
    weight_num_candidates: int = 100
    act_range_method: RangeMethod = RangeMethod.running_minmax
    act_range_opt: OptMethod = OptMethod.golden_section
    act_momentum: float = 0.9
    act_num_candidates: int = 100
    scale_domain: str = "linear"

    def weight_site(self, **over) -> QuantSiteConfig:
        spec = QuantizerSpec(n_bits=over.pop("n_bits", self.n_bits),
                             method=over.pop("method", self.method),
                             scale_domain=self.scale_domain)
        range_cfg = RangeEstimatorConfig(
            method=over.pop("range_method", self.weight_range_method),
            percentile=self.percentile,
            opt_method=over.pop("opt_method", self.weight_range_opt),
            num_candidates=self.weight_num_candidates)
        return QuantSiteConfig(kind="weight", spec=spec, range_cfg=range_cfg,
                               per_channel=over.pop("per_channel",
                                                    self.per_channel_weights),
                               **over)

    def act_site(self, **over) -> QuantSiteConfig:
        spec = QuantizerSpec(
            n_bits=over.pop("n_bits", self.n_bits_act or self.n_bits),
            method=over.pop("method", self.act_method or self.method),
            scale_domain=self.scale_domain)
        range_cfg = RangeEstimatorConfig(
            method=over.pop("range_method", self.act_range_method),
            momentum=self.act_momentum,
            opt_method=over.pop("opt_method", self.act_range_opt),
            num_candidates=self.act_num_candidates)
        return QuantSiteConfig(kind="act", spec=spec, range_cfg=range_cfg,
                               **over)


class QuantConfigBuilder:
    """Collects site declarations from a model definition."""

    def __init__(self, defaults: QuantDefaults):
        self.defaults = defaults
        self._sites = []

    def weight(self, name: str, **over) -> str:
        self._sites.append((name, self.defaults.weight_site(**over)))
        return name

    def act(self, name: str, **over) -> str:
        self._sites.append((name, self.defaults.act_site(**over)))
        return name

    def build(self) -> QuantModelConfig:
        names = [n for n, _ in self._sites]
        if len(names) != len(set(names)):
            raise ValueError("duplicate quant site names")
        return QuantModelConfig(tuple(self._sites))
