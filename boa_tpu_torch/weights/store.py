"""Model weight store: on-disk layout and the synthetic zoo.

Counterpart of `boa_tpu/weights/store.py` (`ModelStore`,
`import_torch_model_folder`, `export_trained_model`, `create_synthetic_model`).
The layout is
nnU-Net's results-folder convention,
``DatasetXXX_name/trainer__nnUNetPlans__3d_fullres/`` with ``plans.json``,
``dataset.json`` and ``fold_k/checkpoint_final.npz``, so the two packages
read each other's folders. A fold that holds only nnU-Net's
``checkpoint_final.pth`` is converted at its first load and the ``.npz``
cached beside it (a `.pth` is trusted code: `convert.py`). Synthetic
weights are drawn with numpy from a seed, with torch's default init bounds
(kaiming-uniform a=sqrt(5) for conv weights, 1/sqrt(fan_in) for biases)
like the reference; the values differ from the reference's, which uses
JAX's generator.
"""

from __future__ import annotations

import json
import logging
import math
import os
import pickle
from pathlib import Path

import numpy as np

from boa_tpu_torch.models.unet import ArchConfig
from boa_tpu_torch.plans.plans import ModelPlans, synthetic_plans
from boa_tpu_torch.weights import convert as cv

DEFAULT_WEIGHTS_ENV = "BOA_WEIGHTS_PATH"

logger = logging.getLogger(__name__)


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
        """(plans, [numpy parameter pytree per fold]); a fold with only a
        `checkpoint_final.pth` is converted and its `.npz` cached."""
        mdir = self.model_dir(task_id, trainer, model=model)
        confs = json.loads((mdir / "plans.json").read_text())["configurations"]
        plans = ModelPlans.from_model_folder(
            mdir, configuration=model if model in confs else "3d_fullres")
        if folds is None:
            folds = sorted(int(p.name.split("_")[1]) for p in mdir.glob("fold_*"))
        cfg = plans.arch_config()
        return plans, [load_fold(mdir / f"fold_{f}", cfg) for f in folds]


def load_fold(fold_dir: Path, cfg: ArchConfig,
              chk: str = "checkpoint_final") -> dict:
    """One fold's parameter pytree: `<chk>.npz`, else `<chk>.pth` converted
    (strict) with the `.npz` written beside it for the next load. The
    `.npz` appears whole or not at all (`io/npz.py` renames a finished
    temporary file onto it), so processes that share a model folder, as
    `-num_parts` runs do, never read a partial one."""
    npz = Path(fold_dir) / f"{chk}.npz"
    if npz.exists():
        return cv.load_params_npz(npz)
    pth = npz.with_suffix(".pth")
    if not pth.exists():
        raise FileNotFoundError(f"missing {chk}[.npz|.pth] in {fold_dir}")
    params = cv.convert_checkpoint(pth, cfg)
    cv.save_params_npz(params, npz)
    return params


def import_torch_model_folder(src: str | Path,
                              dst_root: str | Path | None = None) -> Path:
    """Convert an nnU-Net results folder (``.../DatasetXXX_name/
    trainer__plans__conf`` with torch checkpoints) into the store under
    `dst_root` (default `weights_root()`), at the same relative path. The
    configuration is the folder name's last ``__`` part when plans.json
    has it (the reference always reads 3d_fullres), else 3d_fullres."""
    src = Path(src)
    root = Path(dst_root) if dst_root else weights_root()
    conf = src.name.rsplit("__", 1)[-1]
    if conf not in json.loads((src / "plans.json").read_text())["configurations"]:
        conf = "3d_fullres"
    cfg = ModelPlans.from_model_folder(src, configuration=conf).arch_config()
    dst = root / src.relative_to(src.parents[1])
    dst.mkdir(parents=True, exist_ok=True)
    for name in ("plans.json", "dataset.json"):
        (dst / name).write_bytes((src / name).read_bytes())
    for fold_dir in sorted(src.glob("fold_*")):
        out = dst / fold_dir.name
        out.mkdir(exist_ok=True)
        cv.save_params_npz(cv.convert_checkpoint(fold_dir / "checkpoint_final.pth",
                                                 cfg),
                           out / "checkpoint_final.npz")
    return dst


def export_trained_model(training_dir: str | Path, task_id: int, name: str,
                         root: str | Path | None = None,
                         trainer: str = "nnUNetTrainer", fold: int = 0,
                         checkpoint: str = "checkpoint_final.pkl") -> Path:
    """A `train/run_training.py` output (of either package) -> a servable
    store entry, ``DatasetXXX_name/trainer__nnUNetPlans__3d_fullres/
    fold_N/checkpoint_final.npz`` with plans.json and dataset.json, which
    `ModelStore.load` and `predict_image` read. The plans take the patch,
    classes and widths from export_meta.json, and the spacing, the intensity
    properties and the label names from the preprocessing plans and
    dataset.json beside the case store, when they are there."""
    training_dir = Path(training_dir)
    meta = json.loads((training_dir / "export_meta.json").read_text())
    with open(training_dir / checkpoint, "rb") as f:
        params = pickle.load(f)["params"]
    spacing = (1.0, 1.0, 1.0)
    label_names = None
    intensity = None
    prep_dir = Path(meta.get("cases_dir", training_dir)).parent
    prep_plans_path = prep_dir / "plans.json"
    if prep_plans_path.exists():
        prep_plans = json.loads(prep_plans_path.read_text())
        cfg3d = prep_plans.get("configurations", {}).get("3d_fullres", {})
        spacing = tuple(cfg3d.get("spacing", spacing))
        intensity = prep_plans.get("foreground_intensity_properties_per_channel")
    else:
        logger.warning(
            "Preprocessing plans not found at %s: exporting with 1 mm spacing and "
            "synthetic intensity normalization; serving will NOT resample and "
            "normalize as training did. Re-export with the case store available.",
            prep_plans_path)
    for cand in (prep_dir / "dataset.json", prep_dir.parent / "dataset.json"):
        if cand.exists():
            labels = json.loads(cand.read_text()).get("labels")
            if labels:
                # synthetic_plans adds background itself: classes 1..N
                label_names = [n for n, v in sorted(
                    ((n, v) for n, v in labels.items()
                     if not isinstance(v, (list, tuple)) and int(v) != 0),
                    key=lambda kv: int(kv[1]))]
            break
    if label_names is not None and len(label_names) != meta["num_classes"] - 1:
        logger.warning("dataset.json lists %d foreground labels but the checkpoint "
                       "has %d classes; using generic class names",
                       len(label_names), meta["num_classes"] - 1)
        label_names = None
    plans = synthetic_plans(num_classes=meta["num_classes"],
                            patch_size=tuple(meta["patch_size"]), spacing=spacing,
                            features=tuple(meta["features_per_stage"]),
                            label_names=label_names)
    if intensity:
        plans.plans["foreground_intensity_properties_per_channel"] = intensity
    return _write_store_entry(Path(root) if root else weights_root(), task_id, name,
                              trainer, plans, {fold: params})


def _write_store_entry(root: Path, task_id: int, name: str, trainer: str,
                       plans: ModelPlans, fold_params: dict) -> Path:
    """Plans, dataset and each fold's numpy pytree in the store layout."""
    mdir = Path(root) / f"Dataset{task_id:03d}_{name}" / f"{trainer}__nnUNetPlans__3d_fullres"
    mdir.mkdir(parents=True, exist_ok=True)
    (mdir / "plans.json").write_text(json.dumps(plans.plans))
    (mdir / "dataset.json").write_text(json.dumps(plans.dataset))
    for fold, params in fold_params.items():
        fdir = mdir / f"fold_{fold}"
        fdir.mkdir(exist_ok=True)
        cv.save_params_npz(params, fdir / "checkpoint_final.npz")
    return mdir


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
    """A parameter pytree in the reference's layout, for either encoder
    family (`init_unet`'s structure)."""
    rng = np.random.default_rng(seed)
    params: dict = {"encoder": [], "decoder": [], "seg_heads": []}
    c_in = cfg.input_channels
    if cfg.residual_encoder:
        params["stem"] = _init_block(rng, cfg.kernel_sizes[0], c_in,
                                     cfg.features_per_stage[0], cfg)
        c_in = cfg.features_per_stage[0]
    for s in range(cfg.n_stages):
        stage = []
        c_out = cfg.features_per_stage[s]
        if not cfg.residual_encoder:
            for _ in range(cfg.n_conv_per_stage[s]):
                stage.append(_init_block(rng, cfg.kernel_sizes[s], c_in, c_out, cfg))
                c_in = c_out
            params["encoder"].append(stage)
            continue
        for b in range((cfg.n_blocks_per_stage or cfg.n_conv_per_stage)[s]):
            stride = cfg.strides[s] if b == 0 else (1, 1, 1)
            block = {"conv1": _init_block(rng, cfg.kernel_sizes[s], c_in, c_out, cfg),
                     "conv2": _init_block(rng, cfg.kernel_sizes[s], c_out, c_out, cfg)}
            if any(st != 1 for st in stride) or c_in != c_out:
                block["skip"] = _init_block(rng, (1, 1, 1), c_in, c_out, cfg)
            stage.append(block)
            c_in = c_out
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
    return _write_store_entry(Path(root), task_id, name, trainer, plans,
                              {f: init_params_numpy(cfg, seed + task_id * 10 + f)
                               for f in range(n_folds)})
