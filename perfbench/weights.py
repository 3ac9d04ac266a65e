"""Seeded weights of a configuration, made on the device, and the plans that
a store holds beside them. The network family (`nets/<family>.py`) gives the
leaves and the architecture block; the front (`fronts/<front>.py`) writes
them in the layout its entry point reads.

Frozen copies, each from the file it names:
- the draw: every uniform leaf of the family's `leaf_specs` from one call of
  one `torch.Generator` on the device (the bounds of
  `boa_tpu_torch/weights/store.py:init_params_numpy`; the values differ
  from that function's numpy draws);
- the head-bias rule (the last head's bias, the last leaf of `leaf_specs`,
  plus N(0, sd) drawn from a fixed seed, `seed + task id`, whatever the
  run's seed, so that random weights label organ-sized regions ranked alike
  in every run) and the background lead (background's bias above the
  largest other by `lead`, so that a sub-model of `total` leaves room to
  the ones merged before it): `chip_smoke.py:_synthetic`;
- the model folder (`plans.json`, `dataset.json`, `fold_0/checkpoint_final.npz`
  holding '/'-joined leaf paths): `boa_tpu_torch/weights/store.py:_write_store_entry`
  and `boa_tpu_torch/weights/convert.py:_flatten`, written uncompressed;
- the plans and dataset dictionaries: `boa_tpu_torch/plans/plans.py:synthetic_plans`,
  with the configuration file's values.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch


def _tree_set(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            if len(node) == key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        node.append(value)
    else:
        node[path[-1]] = value


def make_params(specs: list, gen: torch.Generator, device, head_bias: dict,
                task_id: int) -> dict:
    """The parameter tree of a family's `leaf_specs` as float32 tensors on
    `device`: every uniform leaf from one draw of `gen`, then the head-bias
    rule of `head_bias` (`sd`, `seed`, `background_lead`) on the last leaf."""
    total = sum(int(np.prod(shape)) for _, shape, _ in specs)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    leaves = []
    off = 0
    for _, shape, bound in specs:
        n = int(np.prod(shape))
        if bound > 0:
            leaves.append((flat[off:off + n] * (2 * bound) - bound).view(shape))
        else:
            leaves.append(torch.full(shape, 1.0 if bound < 0 else 0.0, device=device))
        off += n
    bias_gen = torch.Generator(device=device)
    bias_gen.manual_seed(int(head_bias["seed"]) + task_id)
    head = leaves[-1] + float(head_bias["sd"]) * torch.randn(
        leaves[-1].shape, generator=bias_gen, device=device)
    if head_bias.get("background_lead") is not None:
        head[0] = head[1:].max() + float(head_bias["background_lead"])
    leaves[-1] = head
    tree: dict = {}
    for (path, _, _), leaf in zip(specs, leaves):
        _tree_set(tree, path, leaf)
    return tree


def flatten(node, prefix: str = "", out: dict | None = None) -> dict:
    """'/'-joined leaf paths -> host float32 arrays (dict keys sorted)."""
    out = {} if out is None else out
    if isinstance(node, dict):
        for k in sorted(node):
            flatten(node[k], f"{prefix}{k}/", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = node.detach().float().cpu().numpy()
    return out


def plans_dicts(cfg: dict, num_classes: int, arch: dict) -> tuple[dict, dict]:
    """(plans.json, dataset.json) of one model of the configuration, with the
    family's architecture block `arch`."""
    conf = {
        "architecture": arch,
        "patch_size": list(cfg["patch_size"]),
        "spacing": list(cfg["spacing"]),
        "normalization_schemes": ["CTNormalization"],
        "use_mask_for_norm": [False],
        "resampling_fn_data": "resample_data_or_seg_to_shape",
        "resampling_fn_data_kwargs": {
            "is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None},
        "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
        "resampling_fn_probabilities_kwargs": {
            "is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None},
        "batch_size": 2,
        "batch_dice": True,
    }
    ip = cfg["intensity"]
    plans = {
        "plans_name": "nnUNetPlans",
        "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2],
        "configurations": {"3d_fullres": conf},
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": ip["mean"], "std": ip["std"],
            "percentile_00_5": ip["percentile_00_5"],
            "percentile_99_5": ip["percentile_99_5"],
            "min": ip["percentile_00_5"] - 100, "max": ip["percentile_99_5"] + 100,
            "median": ip["mean"]}},
    }
    labels = {"background": 0}
    labels.update({f"class_{i}": i for i in range(1, num_classes)})
    dataset = {"labels": labels, "channel_names": {"0": "CT"}, "file_ending": ".nii.gz"}
    return plans, dataset


def write_model_folder(mdir: Path, cfg: dict, num_classes: int, arch: dict,
                       flat: dict) -> None:
    """One model's nnU-Net model folder: `plans.json`, `dataset.json` and
    `fold_0/checkpoint_final.npz` holding the leaves `flat` (`flatten`'s)."""
    (mdir / "fold_0").mkdir(parents=True, exist_ok=True)
    plans, dataset = plans_dicts(cfg, num_classes, arch)
    (mdir / "plans.json").write_text(json.dumps(plans))
    (mdir / "dataset.json").write_text(json.dumps(dataset))
    np.savez(mdir / "fold_0" / "checkpoint_final.npz", **flat)
