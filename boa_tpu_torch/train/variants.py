"""Trainer-variant table: trainer names -> hyperparameter deltas.

Counterpart of `boa_tpu/train/variants.py` (`VariantSpec`, `VARIANTS`,
`get_variant`, `apply_variant`), a copy of its table. nnU-Net encodes
hyperparameter variants as trainer subclasses whose names are stored in
checkpoints and model folders (`nnunetv2/training/nnUNetTrainer/variants/`);
the model-folder predictor reads `mirror_axes` from here and the trainer
(`run_training.py`) the rest. `primus_train_config` builds a Primus
trainer's network (`models/primus.py`) and recipe.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class VariantSpec:
    num_epochs: int = 1000
    mirror_axes: tuple[int, ...] = (0, 1, 2)
    loss: str = "dice_ce"              # a loss name of the trainer
    initial_lr: float = 1e-2
    optimizer: str = "sgd"             # sgd | adamw_amsgrad | adamw | adam
    lr_schedule: str = "poly"          # poly | cos | warmup_poly
    aggressive_da: bool = False        # DA5 augmentation preset
    seg_resample_order0: bool = False  # DASegOrd0: order-0 seg augmentation
    no_da: bool = False                # nnUNetTrainerNoDA: augmentation off
    no_dummy_2d: bool = False          # nnUNetTrainer_noDummy2DDA
    deep_supervision: bool = True      # nnUNetTrainerNoDeepSupervision
    batch_norm: bool = False           # nnUNetTrainerBN (not trainable here)
    probabilistic_oversampling: bool = False  # per-sample Bernoulli draw
    oversample_percent: float | None = None   # None = plan default 0.33
    # Primus ViT trainers (`primus/primus_trainers.py:18-260`): network
    # family key (S/B/M/L), AdamW betas (0.9, 0.98), wd 5e-2, grad clip 1,
    # 50-epoch warmup then PolyLR-offset, no deep supervision
    primus: str | None = None
    weight_decay: float | None = None  # None = trainer default 3e-5
    grad_clip: float | None = None     # None = trainer default 12
    adam_betas: tuple[float, float] | None = None
    batch_size: int | None = None      # plan batch override (BS8 trainers)


VARIANTS: dict[str, VariantSpec] = {
    "nnUNetTrainer": VariantSpec(),
    "nnUNetTrainerNoMirroring": VariantSpec(mirror_axes=()),
    "nnUNetTrainer_4000epochs_NoMirroring": VariantSpec(
        num_epochs=4000, mirror_axes=()),
    "nnUNetTrainer_2000epochs_NoMirroring": VariantSpec(
        num_epochs=2000, mirror_axes=()),
    "nnUNetTrainer_1500epochs_NoMirroring": VariantSpec(
        num_epochs=1500, mirror_axes=()),
    "nnUNetTrainer_DASegOrd0": VariantSpec(seg_resample_order0=True),
    "nnUNetTrainer_DASegOrd0_NoMirroring": VariantSpec(
        mirror_axes=(), seg_resample_order0=True),
    "nnUNetTrainer_onlyMirror01": VariantSpec(mirror_axes=(0, 1)),
    # custom_trainers.py shim classes (checkpoint deserialization only in
    # the reference; real hyperparams here)
    "nnUNetTrainer_MOSAIC_1k_QuarterLR_NoMirroring": VariantSpec(
        num_epochs=1000, mirror_axes=(), initial_lr=1e-2 / 4),
    "nnUNetTrainerDiceTopK10Loss_2000epochs": VariantSpec(
        num_epochs=2000, loss="dice_topk10"),
    # loss family (`variants/loss/*.py`)
    "nnUNetTrainerCELoss": VariantSpec(loss="ce"),
    "nnUNetTrainerCELoss_5epochs": VariantSpec(loss="ce", num_epochs=5),
    "nnUNetTrainerDiceLoss": VariantSpec(loss="dice"),
    "nnUNetTrainerDiceCELoss_noSmooth": VariantSpec(loss="dice_ce_nosmooth"),
    "nnUNetTrainerTopk10Loss": VariantSpec(loss="topk10"),
    "nnUNetTrainerTopk10LossLS01": VariantSpec(loss="topk10_ls01"),
    "nnUNetTrainerDiceTopK10Loss": VariantSpec(loss="dice_topk10"),
    # optimizer family (nnUNetTrainerAdam.py: AdamW amsgrad / vanilla Adam,
    # all under PolyLR; the 1en3/3en4 subclasses change only initial_lr)
    "nnUNetTrainerAdam": VariantSpec(optimizer="adamw_amsgrad"),
    "nnUNetTrainerAdam1en3": VariantSpec(optimizer="adamw_amsgrad",
                                         initial_lr=1e-3),
    "nnUNetTrainerAdam3en4": VariantSpec(optimizer="adamw_amsgrad",
                                         initial_lr=3e-4),
    "nnUNetTrainerVanillaAdam": VariantSpec(optimizer="adam"),
    "nnUNetTrainerVanillaAdam1en3": VariantSpec(optimizer="adam",
                                                initial_lr=1e-3),
    "nnUNetTrainerVanillaAdam3en4": VariantSpec(optimizer="adam",
                                                initial_lr=3e-4),
    # lr_schedule family
    "nnUNetTrainerCosAnneal": VariantSpec(lr_schedule="cos"),
    "nnUNetTrainer_warmup": VariantSpec(lr_schedule="warmup_poly"),
    # data-augmentation family
    "nnUNetTrainerDA5": VariantSpec(aggressive_da=True),
    "nnUNetTrainerNoDA": VariantSpec(no_da=True, mirror_axes=()),
    "nnUNetTrainer_noDummy2DDA": VariantSpec(no_dummy_2d=True),
    # network-architecture family
    "nnUNetTrainerNoDeepSupervision": VariantSpec(deep_supervision=False),
    "nnUNetTrainerBN": VariantSpec(batch_norm=True),
    # sampling family: the base class recomputes the oversample percent as
    # the MEAN of the positional round-rule flags (so the Bernoulli draw
    # matches the deterministic batch composition in expectation); _033 and
    # _010 pin it explicitly
    "nnUNetTrainer_probabilisticOversampling": VariantSpec(
        probabilistic_oversampling=True),
    "nnUNetTrainer_probabilisticOversampling_033": VariantSpec(
        probabilistic_oversampling=True, oversample_percent=0.33),
    "nnUNetTrainer_probabilisticOversampling_010": VariantSpec(
        probabilistic_oversampling=True, oversample_percent=0.10),
}

# Primus family (`primus/primus_trainers.py:18-260`): AbstractPrimus sets
# lr 3e-4, AdamW(betas=(0.9, 0.98), amsgrad=False), wd 5e-2, no deep
# supervision, warmup(50)->PolyLR-offset, grad clip 1; S/B/M/L pick the
# ViT size; the BS8 trainers pin plan batch size 8 (and _2e4 lr 2e-4).
_PRIMUS_BASE = dict(initial_lr=3e-4, optimizer="adamw",
                    lr_schedule="warmup_poly", weight_decay=5e-2,
                    grad_clip=1.0, adam_betas=(0.9, 0.98),
                    deep_supervision=False)
VARIANTS.update({
    "nnUNet_Primus_S_Trainer": VariantSpec(primus="S", **_PRIMUS_BASE),
    "nnUNet_Primus_B_Trainer": VariantSpec(primus="B", **_PRIMUS_BASE),
    "nnUNet_Primus_M_Trainer": VariantSpec(primus="M", **_PRIMUS_BASE),
    "nnUNet_Primus_L_Trainer": VariantSpec(primus="L", **_PRIMUS_BASE),
    "nnUNet_Primus_M_Trainer_BS8": VariantSpec(
        primus="M", batch_size=8, **_PRIMUS_BASE),
    "nnUNet_Primus_M_Trainer_BS8_2e4": VariantSpec(
        primus="M", batch_size=8,
        **{**_PRIMUS_BASE, "initial_lr": 2e-4}),
    "nnUNet_Trainer_BS8": VariantSpec(batch_size=8),
})


def get_variant(trainer_name: str) -> VariantSpec:
    """Resolve a trainer name; unknown names parse `_NNNNepochs` and
    `NoMirroring` markers (recursive_find_python_class fallback)."""
    if trainer_name in VARIANTS:
        return VARIANTS[trainer_name]
    spec = VariantSpec()
    for part in trainer_name.split("_"):
        if part.endswith("epochs") and part[:-6].isdigit():
            spec = replace(spec, num_epochs=int(part[:-6]))
    if "NoMirroring" in trainer_name:
        spec = replace(spec, mirror_axes=())
    return spec


def apply_variant(cfg, trainer_name: str, batch_size: int = 2):
    """TrainConfig + trainer name -> (adjusted TrainConfig, spec): epochs,
    lr, loss, optimizer, schedule, weight decay, clip, betas, oversampling
    and deep supervision. The spec's augmentation and sampling markers (DA5,
    NoDA, order-0 seg, probabilistic oversampling) are read by
    `run_training`; `batch_size` is the plan batch the probabilistic
    variant recomputes its percent against."""
    import dataclasses

    spec = get_variant(trainer_name)
    if spec.batch_norm:
        raise ValueError(
            "nnUNetTrainerBN (BatchNorm U-Net) is recognised for checkpoint "
            "deserialization only: the network trains with InstanceNorm")
    kw = dict(num_epochs=spec.num_epochs, initial_lr=spec.initial_lr,
              loss=spec.loss, optimizer=spec.optimizer,
              lr_schedule=spec.lr_schedule)
    if spec.weight_decay is not None:
        kw["weight_decay"] = spec.weight_decay
    if spec.grad_clip is not None:
        kw["grad_clip"] = spec.grad_clip
    if spec.adam_betas is not None:
        kw["adam_betas"] = spec.adam_betas
    if spec.oversample_percent is not None:
        kw["oversample_foreground_percent"] = spec.oversample_percent
    elif spec.probabilistic_oversampling:
        # the realised fraction of round-rule-forced positions (batch 2 at
        # 0.33 -> 0.5), `nnUNetTrainer_probabilisticOversampling.py:20-23`
        from boa_tpu_torch.train.dataloader import oversample_flags

        flags = oversample_flags(batch_size, cfg.oversample_foreground_percent)
        kw["oversample_foreground_percent"] = float(sum(flags) / max(len(flags), 1))
    if not spec.deep_supervision and getattr(cfg.arch, "deep_supervision", False):
        kw["arch"] = dataclasses.replace(cfg.arch, deep_supervision=False)
    return replace(cfg, **kw), spec


def primus_train_config(trainer_name: str, num_classes: int, input_channels: int = 1,
                        num_epochs: int = 1000, iters_per_epoch: int = 250,
                        batch_size: int = 2, compute_dtype: str = "bfloat16"):
    """(TrainConfig, spec) of a Primus trainer name: the ViT of its size
    (S/B/M/L, `models/primus.py:PRIMUS_VARIANTS`) under the AbstractPrimus
    recipe; spec.batch_size (the BS8 trainers) overrides `batch_size` for
    the oversampling percent."""
    from boa_tpu_torch.models.primus import primus_config
    from boa_tpu_torch.train.trainer import TrainConfig

    spec = get_variant(trainer_name)
    if spec.primus is None:
        raise ValueError(f"{trainer_name!r} is not a Primus trainer")
    arch = primus_config(spec.primus, num_classes=num_classes,
                         input_channels=input_channels)
    cfg = TrainConfig(arch=arch, num_epochs=num_epochs, iters_per_epoch=iters_per_epoch,
                      compute_dtype=compute_dtype)
    return apply_variant(cfg, trainer_name, batch_size=spec.batch_size or batch_size)
