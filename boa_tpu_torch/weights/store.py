"""Model weight store: on-disk layout and the synthetic zoo.

Counterpart of `boa_tpu/weights/store.py` (`ModelStore`,
`create_synthetic_model`). The layout is nnU-Net's results-folder
convention, ``DatasetXXX_name/trainer__nnUNetPlans__3d_fullres/`` with
``plans.json``, ``dataset.json`` and ``fold_k/checkpoint_final.npz``, so
the two packages read each other's folders. Synthetic weights are drawn
with numpy from a seed, with torch's default init bounds (kaiming-uniform
a=sqrt(5) for conv weights, 1/sqrt(fan_in) for biases) like the reference;
the values differ from the reference's, which uses JAX's generator.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np

from boa_tpu_torch.models.unet import ArchConfig
from boa_tpu_torch.plans.plans import ModelPlans, synthetic_plans
from boa_tpu_torch.weights import convert as cv

DEFAULT_WEIGHTS_ENV = "BOA_WEIGHTS_PATH"


def weights_root() -> Path:
    """`$BOA_WEIGHTS_PATH`, else ``~/.boa_tpu/weights``."""
    root = os.environ.get(DEFAULT_WEIGHTS_ENV)
    if root:
        return Path(root)
    return Path.home() / ".boa_tpu" / "weights"


class ModelStore:
    """Resolves (task_id, trainer, configuration) -> (plans, fold params).
    With no `root`, the folder of `weights_root()`."""

    def __init__(self, root: str | Path | None = None):
        self.root = Path(root) if root else weights_root()

    def model_dir(self, task_id: int, trainer: str = "nnUNetTrainer",
                  plans_name: str = "nnUNetPlans",
                  model: str = "3d_fullres") -> Path:
        matches = sorted(self.root.glob(f"Dataset{task_id:03d}_*"))
        if not matches:
            raise FileNotFoundError(
                f"No weights for task {task_id} under {self.root}: put the "
                f"converted weights there or point {DEFAULT_WEIGHTS_ENV} at "
                f"their folder (nothing is downloaded)")
        return matches[0] / f"{trainer}__{plans_name}__{model}"

    def load(self, task_id: int, trainer: str = "nnUNetTrainer",
             model: str = "3d_fullres", folds=(0,)) -> tuple[ModelPlans, list]:
        """(plans, [numpy parameter pytree per fold])."""
        mdir = self.model_dir(task_id, trainer, model=model)
        confs = json.loads((mdir / "plans.json").read_text())["configurations"]
        plans = ModelPlans.from_model_folder(
            mdir, configuration=model if model in confs else "3d_fullres")
        if folds is None:
            folds = sorted(int(p.name.split("_")[1]) for p in mdir.glob("fold_*"))
        params = []
        for f in folds:
            npz = mdir / f"fold_{f}" / "checkpoint_final.npz"
            if not npz.exists() and npz.with_suffix(".pth").exists():
                raise NotImplementedError(
                    f".pth checkpoints ({npz.with_suffix('.pth')}) wait for M1 "
                    f"(the torch state-dict loader)")
            if not npz.exists():
                raise FileNotFoundError(f"missing checkpoint for fold {f} in "
                                        f"{mdir}")
            params.append(cv.load_params_npz(npz))
        return plans, params


def _uniform(rng, shape, bound) -> np.ndarray:
    return rng.uniform(-bound, bound, size=shape).astype(np.float32)


def _init_conv(rng, kernel, c_in, c_out, bias: bool) -> dict:
    fan_in = c_in * int(np.prod(kernel))
    bound = math.sqrt(2.0 / (1 + 5.0)) * math.sqrt(3.0 / fan_in)
    p = {"w": _uniform(rng, (*kernel, c_in, c_out), bound)}
    if bias:
        p["b"] = _uniform(rng, (c_out,), 1.0 / math.sqrt(fan_in))
    return p


def _init_block(rng, kernel, c_in, c_out, cfg: ArchConfig) -> dict:
    p = _init_conv(rng, kernel, c_in, c_out, cfg.conv_bias)
    if cfg.norm_affine:
        p["norm_scale"] = np.ones((c_out,), np.float32)
        p["norm_bias"] = np.zeros((c_out,), np.float32)
    return p


def init_params_numpy(cfg: ArchConfig, seed: int) -> dict:
    """A PlainConvUNet parameter pytree in the reference's layout."""
    rng = np.random.default_rng(seed)
    params: dict = {"encoder": [], "decoder": [], "seg_heads": []}
    c_in = cfg.input_channels
    for s in range(cfg.n_stages):
        stage = []
        for _ in range(cfg.n_conv_per_stage[s]):
            stage.append(_init_block(rng, cfg.kernel_sizes[s], c_in,
                                     cfg.features_per_stage[s], cfg))
            c_in = cfg.features_per_stage[s]
        params["encoder"].append(stage)
    for s in range(cfg.n_stages - 1, 0, -1):
        c_below = cfg.features_per_stage[s]
        c_skip = cfg.features_per_stage[s - 1]
        # XYZOI transposed-conv weight (kx, ky, kz, c_skip, c_below)
        up = _init_conv(rng, cfg.strides[s], c_skip, c_below, False)
        fan_in = c_below * int(np.prod(cfg.strides[s]))
        up["b"] = _uniform(rng, (c_skip,), 1.0 / math.sqrt(fan_in))
        stage = {"transp": up, "convs": []}
        c = 2 * c_skip
        for _ in range(cfg.n_conv_per_stage_decoder[cfg.n_stages - 1 - s]):
            stage["convs"].append(_init_block(rng, cfg.kernel_sizes[s - 1], c,
                                              c_skip, cfg))
            c = c_skip
        params["decoder"].append(stage)
        params["seg_heads"].append(_init_conv(rng, (1, 1, 1), c_skip,
                                              cfg.num_classes, True))
    return params


def create_synthetic_model(
    root: str | Path,
    task_id: int,
    name: str,
    num_classes: int,
    trainer: str = "nnUNetTrainer",
    patch_size=(32, 32, 32),
    spacing=(3.0, 3.0, 3.0),
    features=(8, 16, 32),
    n_folds: int = 1,
    label_names: list[str] | None = None,
    seed: int = 0,
) -> Path:
    """Materialize a synthetic model into the store layout (tests/bench)."""
    plans = synthetic_plans(num_classes=num_classes, patch_size=patch_size,
                            spacing=spacing, features=features,
                            label_names=label_names)
    cfg = plans.arch_config()
    mdir = Path(root) / f"Dataset{task_id:03d}_{name}" / \
        f"{trainer}__nnUNetPlans__3d_fullres"
    mdir.mkdir(parents=True, exist_ok=True)
    (mdir / "plans.json").write_text(json.dumps(plans.plans))
    (mdir / "dataset.json").write_text(json.dumps(plans.dataset))
    for f in range(n_folds):
        fdir = mdir / f"fold_{f}"
        fdir.mkdir(exist_ok=True)
        cv.save_params_npz(init_params_numpy(cfg, seed + task_id * 10 + f),
                           fdir / "checkpoint_final.npz")
    return mdir
