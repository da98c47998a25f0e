"""Site-addressable quantization configuration.

Counterpart of ``transformer_quantization_tpu/quant/qconfig.py``: a model
declares its quantization sites by name, and a hashable
:class:`QuantModelConfig` maps each name to a :class:`QuantSiteConfig`
(bits, method, estimator, axis), and :func:`apply_quant_value` applies
one value of the reference's ``quant_dict`` language to a site (the keys
are the model's: ``models/bert.py``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Mapping, Optional, Tuple

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
    quantizes, ``fix`` quantizes with stored params, ``record_ranges``
    records per-channel dynamic ranges for the PEG permutation and passes
    activations through, ``learn`` quantizes with stored params whose
    ``delta`` / ``zero_float`` are trained (QAT with learned ranges)."""

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

    def names(self):
        return [n for n, _ in self.sites]

    def items(self):
        return self.sites

    def replace_site(self, name: str, **changes) -> "QuantModelConfig":
        if name not in self._by_name:
            raise KeyError(name)
        return QuantModelConfig(tuple(
            (n, dataclasses.replace(c, **changes) if n == name else c)
            for n, c in self.sites))

    def replace_sites(self, changes: Mapping[str, Dict]) -> "QuantModelConfig":
        unknown = set(changes) - set(self._by_name)
        if unknown:
            raise KeyError(f"unknown quant sites: {sorted(unknown)}")
        return QuantModelConfig(tuple(
            (n, dataclasses.replace(c, **changes[n]) if n in changes else c)
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


# ---------------------------------------------------------------------------
# quant_dict value language
# ---------------------------------------------------------------------------


def parse_quant_dict_value(value) -> Optional[Dict]:
    """One ``quant_dict`` value as :class:`QuantSiteConfig` field changes:
    int bits, ``'fp32'`` (disabled), ``'per_embd'``, ``'ngN'`` (N groups
    along the embedding axis) or ``'ngpN'`` (the same, permuted)."""
    if value is None:
        return None
    if isinstance(value, int):
        return {"__n_bits__": value}
    if value == "fp32":
        return {"enabled": False}
    if value == "per_embd":
        return {"axis": 2, "n_groups": None}
    if isinstance(value, str) and value.startswith("ngp"):
        return {"axis": 2, "n_groups": int(value[3:]), "permute": True}
    if isinstance(value, str) and value.startswith("ng"):
        return {"axis": 2, "n_groups": int(value[2:]), "permute": False}
    raise NotImplementedError(f'Unknown value "{value}" in quant_dict')


def apply_quant_value(cfg: QuantModelConfig, site: str,
                      value) -> QuantModelConfig:
    """Apply one ``quant_dict`` value to ``site`` (a site the config does
    not hold, or a ``None`` value, leaves it unchanged)."""
    changes = parse_quant_dict_value(value)
    if changes is None or site not in cfg:
        return cfg
    if "__n_bits__" in changes:
        changes["spec"] = dataclasses.replace(
            cfg[site].spec, n_bits=changes.pop("__n_bits__"))
    return cfg.replace_site(site, **changes)
