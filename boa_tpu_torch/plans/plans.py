"""plans.json / dataset.json parsing — the per-model configuration.

Counterpart of `boa_tpu/plans/plans.py` (`ModelPlans`, `synthetic_plans`).
nnU-Net stores patch_size/spacing in its internal axis order, the reverse
of the (x, y, z) order used on the host; `patch_size_xyz` / `spacing_xyz`
expose the reversed views.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

from boa_tpu_torch.models.unet import ArchConfig, arch_config_from_plans


@dataclass
class ModelPlans:
    """Parsed view of one (plans.json, dataset.json, configuration) triple."""

    plans: dict
    dataset: dict
    configuration_name: str = "3d_fullres"

    def __post_init__(self) -> None:
        conf = dict(self.plans["configurations"][self.configuration_name])
        seen = {self.configuration_name}
        while conf.get("inherits_from"):
            base_name = conf.pop("inherits_from")
            if base_name in seen:
                raise ValueError("circular configuration inheritance")
            seen.add(base_name)
            base = dict(self.plans["configurations"][base_name])
            base.update(conf)
            conf = base
        if "architecture" not in conf:
            raise ValueError("plans without an 'architecture' entry (pre-2.2 "
                             "nnU-Net plans) are not supported by the port yet")
        self.conf = conf

    @property
    def transpose_forward(self) -> list[int]:
        return list(self.plans.get("transpose_forward", [0, 1, 2]))

    @property
    def transpose_backward(self) -> list[int]:
        return list(self.plans.get("transpose_backward", [0, 1, 2]))

    @property
    def intensity_properties(self) -> dict:
        return self.channel_intensity_properties(0)

    def channel_intensity_properties(self, c: int) -> dict:
        props = self.plans.get("foreground_intensity_properties_per_channel", {})
        return props.get(str(c), props.get(c, {}))

    @property
    def labels(self) -> dict[str, int]:
        """dataset.json's plain (non-region) labels, name -> value."""
        return {k: int(v) for k, v in self.dataset.get("labels", {}).items()
                if not isinstance(v, (list, tuple))}

    @property
    def has_regions(self) -> bool:
        return any(isinstance(v, (list, tuple)) for v in
                   self.dataset.get("labels", {}).values())

    @property
    def regions_class_order(self) -> list[int] | None:
        rco = self.dataset.get("regions_class_order")
        return [int(v) for v in rco] if rco is not None else None

    @property
    def foreground_labels(self) -> list[int]:
        """Sorted non-background label values: the one-hot channel order of
        a cascade stage's input."""
        if not self.has_regions:
            return sorted(v for v in self.labels.values() if v != 0)
        vals = set()
        for v in self.dataset.get("labels", {}).values():
            vals.update(int(x) for x in (v if isinstance(v, (list, tuple)) else [v]))
        return sorted(x for x in vals if x != 0)

    @property
    def num_segmentation_heads(self) -> int:
        labels = self.dataset.get("labels", {"background": 0})
        if self.has_regions:
            return sum(1 for k, v in labels.items()
                       if not (k == "background"
                               or (not isinstance(v, (list, tuple))
                                   and int(v) == 0)))
        return len({int(v) for v in labels.values()})

    @property
    def previous_stage(self) -> str | None:
        return self.conf.get("previous_stage")

    @property
    def num_input_channels(self) -> int:
        """Image channels, plus one one-hot channel per foreground label for
        a cascade stage."""
        n = max(1, len(self.dataset.get("channel_names",
                                        self.dataset.get("modality", {"0": "CT"}))))
        if self.previous_stage is not None:
            n += len(self.foreground_labels)
        return n

    @property
    def patch_size(self) -> list[int]:
        return list(self.conf["patch_size"])

    @property
    def spacing(self) -> list[float]:
        return list(self.conf["spacing"])

    @property
    def patch_size_xyz(self) -> tuple[int, ...]:
        return tuple(reversed(self.patch_size))

    @property
    def spacing_xyz(self) -> tuple[float, ...]:
        return tuple(reversed(self.spacing))

    @property
    def normalization_schemes(self) -> list[str]:
        return list(self.conf.get("normalization_schemes", ["CTNormalization"]))

    @property
    def use_mask_for_norm(self) -> list[bool]:
        return list(self.conf.get("use_mask_for_norm", [False]))

    def arch_config(self) -> ArchConfig:
        return arch_config_from_plans(
            self.conf["architecture"],
            num_classes=self.num_segmentation_heads,
            input_channels=self.num_input_channels)

    @classmethod
    def from_model_folder(cls, folder: str | Path,
                          configuration: str = "3d_fullres") -> "ModelPlans":
        folder = Path(folder)
        plans = json.loads((folder / "plans.json").read_text())
        dataset = json.loads((folder / "dataset.json").read_text())
        return cls(plans=plans, dataset=dataset,
                   configuration_name=configuration)


def synthetic_plans(
    num_classes: int = 5,
    patch_size: tuple[int, ...] = (32, 32, 32),
    spacing: tuple[float, ...] = (3.0, 3.0, 3.0),
    features: tuple[int, ...] = (8, 16, 32),
    intensity_mean: float = 100.0,
    intensity_std: float = 300.0,
    clip_lo: float = -1000.0,
    clip_hi: float = 1500.0,
    label_names: list[str] | None = None,
    channels: int = 1,
    normalization: str = "CTNormalization",
) -> ModelPlans:
    """A small in-memory plans set (tests / synthetic model zoo); the same
    dictionaries as `boa_tpu.plans.plans.synthetic_plans`."""
    n_stages = len(features)
    strides = [[1, 1, 1]] + [[2, 2, 2]] * (n_stages - 1)
    conf: dict[str, Any] = {
        "architecture": {
            "network_class_name":
                "dynamic_network_architectures.architectures.unet.PlainConvUNet",
            "arch_kwargs": {
                "n_stages": n_stages,
                "features_per_stage": list(features),
                "kernel_sizes": [[3, 3, 3]] * n_stages,
                "strides": strides,
                "n_conv_per_stage": [2] * n_stages,
                "n_conv_per_stage_decoder": [2] * (n_stages - 1),
                "conv_bias": True,
                "norm_op_kwargs": {"eps": 1e-05, "affine": True},
            },
        },
        "patch_size": list(patch_size),
        "spacing": list(spacing),
        "normalization_schemes": [normalization] * channels,
        "use_mask_for_norm": [False] * channels,
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": {
            "is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None},
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": {
            "is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None},
        "batch_size": 2,
        "batch_dice": True,
    }
    labels = {"background": 0}
    names = label_names or [f"class_{i}" for i in range(1, num_classes)]
    for i, n in enumerate(names, start=1):
        labels[n] = i
    plans = {
        "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "configurations": {"3d_fullres": conf},
        "foreground_intensity_properties_per_channel": {
            str(c): {
                "mean": intensity_mean + 10.0 * c,
                "std": intensity_std,
                "percentile_00_5": clip_lo,
                "percentile_99_5": clip_hi,
                "min": clip_lo - 100,
                "max": clip_hi + 100,
                "median": intensity_mean,
            } for c in range(channels)
        },
    }
    dataset = {"labels": labels,
               "channel_names": {str(c): ("CT" if c == 0 else f"MR{c}")
                                 for c in range(channels)},
               "file_ending": ".nii.gz"}
    return ModelPlans(plans=plans, dataset=dataset)
