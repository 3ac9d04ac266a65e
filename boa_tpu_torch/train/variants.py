"""Trainer-variant table: trainer names -> hyperparameter deltas.

Counterpart of `boa_tpu/train/variants.py` (`VariantSpec`, `VARIANTS`,
`get_variant`), a copy of its table. nnU-Net encodes hyperparameter
variants as trainer subclasses whose names are stored in checkpoints and
model folders (`nnunetv2/training/nnUNetTrainer/variants/`); the
model-folder predictor reads `mirror_axes` from here. The reference's
`apply_variant` and `primus_train_config` build training configurations
and wait for the port's trainer (ROADMAP M11).
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
