"""Training entry point, on the card by default.

Counterpart of `boa_tpu/train/run_training.py` (nnU-Net's `nnUNetv2_train`,
`run/run_training.py:137-190`): `build_trainer` derives the network from
the patch and the class count (or a Primus trainer's ViT), on one device or
over a dp x sp x tp mesh of ranks, and `run_training` runs the folds
(splits_final.json), `--pretrained_weights`, `--tr` trainer variants,
cascade stages and the final validation
(`perform_actual_validation`, nnUNetTrainer.py:1212, on the port's sliding
window: bf16, the K1-K3 composite at qualifying geometries), and writes
`export_meta.json` for `weights.manager export`. Batches come from the
prefetching loader through pinned memory and are augmented on the device.
With `--dp/--sp/--tp`, `main` starts dp * sp * tp ranks (one a card, NCCL;
gloo with `-d cpu`) and waits for them at most `--timeout` seconds. Each
rank loads and augments only its dp rows of every global batch (the draws
of the whole batch, so the run is the one-process run) and trains on its sp
slab of them and its shard of the network (`parallel/spmd.py`); rank 0
writes the files.

A Primus trainer name trains through `build_trainer` and
`Trainer.train_epoch` with its checkpoints, as in the reference, whose
`run_training` cannot take one: it writes `export_meta.json` from
`arch.features_per_stage`, which a `PrimusConfig` lacks, and validates with
the U-Net sliding window (ROADMAP Queue 3). `run_training` raises
ValueError for one before any work.

Usage:
    python -m boa_tpu_torch.train.run_training CASES_DIR OUT_DIR \
        --patch 128 128 128 --batch 2 --epochs 1000 [--resume] [-d cpu] \
        [--dp 2 --sp 1 --tp 1 [--timeout SECONDS]]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from boa_tpu_torch.device import named_device

logger = logging.getLogger(__name__)


def build_trainer(out_dir: Path, patch, num_classes: int,
                  features=(32, 64, 128, 256, 320, 320), epochs: int = 1000,
                  iters: int = 250, mesh_shape=None, compute_dtype: str = "bfloat16",
                  trainer_name: str | None = None, batch_size: int = 2,
                  in_channels: int = 1, device="gpu", seed: int = 0):
    """(Trainer, mesh or None, variant spec) for the network of `patch` and
    `num_classes`: pooling per axis while the axis allows, a singleton z
    axis (the 2d configuration) never pooled or convolved through-plane; a
    Primus trainer name builds its ViT and recipe instead
    (`primus_train_config`). `mesh_shape` (dp, sp, tp) shards the trainer
    over the process group's ranks (`parallel/mesh.py:
    initialize_distributed` first). `device` takes `run_training`'s names
    ("gpu", "gpu:N", "cpu")."""
    from boa_tpu_torch.models.unet import ArchConfig
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer
    from boa_tpu_torch.train.variants import (VariantSpec, apply_variant, get_variant,
                                              primus_train_config)

    depths = [int(np.log2(p)) for p in patch]
    n = min(len(features), max(depths) + 1)
    two_d = patch[2] == 1
    kz = 1 if two_d else 3
    arch = ArchConfig(
        n_stages=n, features_per_stage=tuple(features[:n]),
        kernel_sizes=((3, 3, kz),) * n,
        strides=((1, 1, 1),) + tuple(
            tuple(2 if s <= depths[i] else 1 for i in range(3)) for s in range(1, n)),
        n_conv_per_stage=(2,) * n, n_conv_per_stage_decoder=(2,) * (n - 1),
        num_classes=num_classes, input_channels=in_channels,
        deep_supervision=True, two_d=two_d)
    cfg = TrainConfig(arch=arch, num_epochs=epochs, iters_per_epoch=iters,
                      compute_dtype=compute_dtype)
    spec = VariantSpec()
    if trainer_name and get_variant(trainer_name).primus is not None:
        # the whole network family changes: the ViT and the AbstractPrimus recipe
        cfg, spec = primus_train_config(trainer_name, num_classes,
                                        input_channels=in_channels, num_epochs=epochs,
                                        iters_per_epoch=iters, batch_size=batch_size,
                                        compute_dtype=compute_dtype)
    elif trainer_name:
        cfg, spec = apply_variant(cfg, trainer_name, batch_size=batch_size)
    # the caller's epochs and iterations keep the loop
    cfg = dataclasses.replace(cfg, num_epochs=epochs, iters_per_epoch=iters)
    mesh = None
    if mesh_shape is not None:
        from boa_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(int(np.prod(mesh_shape)), ("dp", "sp", "tp"), tuple(mesh_shape))
    trainer = Trainer(cfg, out_dir, seed=seed, device=named_device(device), mesh=mesh)
    return trainer, mesh, spec


def _num_classes(store) -> int:
    # the largest label over every case (the first may lack the highest)
    mx = 0
    for cid in store.case_ids():
        case = store.load_case(cid)
        if case.class_locations:
            mx = max(mx, max(int(k) for k in case.class_locations))
        else:
            mx = max(mx, int(np.max(np.asarray(case.seg))))
    return mx + 1


def run_training(cases_dir: str | Path, out_dir: str | Path,
                 patch=(128, 128, 128), batch_size: int = 2,
                 num_classes: int | None = None, epochs: int = 1000,
                 iters: int = 250, resume: bool = False, mesh_shape=None,
                 augment: bool = True, mirror_axes: "tuple[int, ...] | None" = None,
                 seed: int = 0, fold: "int | str" = "all", validate: bool = False,
                 pretrained_weights: "str | Path | None" = None,
                 trainer_name: str | None = None, cascade: bool = False,
                 device="gpu", features=(32, 64, 128, 256, 320, 320),
                 compute_dtype: str = "bfloat16") -> dict:
    """Train on a case store; returns the last epoch's log, with the seconds
    of the set-up and the final checkpoint, and "validation" (and its
    seconds) when `validate` ran. `fold` picks the 5-fold split
    ("all": every case); `trainer_name` applies a variant's recipe (loss,
    optimizer, schedule, DA5 / NoDA, probabilistic oversampling, mirror
    axes), explicit epochs, iterations and mirror axes winning; `cascade`
    trains a 3d_cascade_fullres stage on the cases' previous-stage labels.
    `device` is a user-facing name ("gpu", "gpu:N", "cpu")."""
    from boa_tpu_torch.train.augment import augment_batch, augment_batch_cascade
    from boa_tpu_torch.train.dataloader import DataLoader, to_device
    from boa_tpu_torch.train.dataset import CaseStore, load_or_create_splits
    from boa_tpu_torch.train.variants import get_variant

    if trainer_name and get_variant(trainer_name).primus is not None:
        raise ValueError(
            f"{trainer_name!r} trains the Primus ViT, which run_training cannot "
            "export or validate (no features_per_stage, no U-Net sliding window; "
            "the reference fails alike): drive it with build_trainer and "
            "Trainer.train_epoch")
    dev = named_device(device)
    t_setup = time.perf_counter()
    cases_dir, out_dir = Path(cases_dir), Path(out_dir)
    store = CaseStore(cases_dir)
    if num_classes is None:
        num_classes = _num_classes(store)
    split = None
    if fold != "all":
        split = load_or_create_splits(store)[int(fold)]
        logger.info("fold %s: %d train / %d val cases", fold, len(split["train"]),
                    len(split["val"]))
    n_data_ch = store.load_case(store.case_ids()[0]).data.shape[0]
    fg_labels = tuple(range(1, num_classes))
    in_channels = n_data_ch + (len(fg_labels) if cascade else 0)
    trainer, _, spec = build_trainer(out_dir, patch, num_classes, features=features,
                                     epochs=epochs, iters=iters, mesh_shape=mesh_shape,
                                     compute_dtype=compute_dtype,
                                     trainer_name=trainer_name, batch_size=batch_size,
                                     in_channels=in_channels, device=dev, seed=seed)
    if trainer_name:
        if spec.no_da:
            augment = False
        if mirror_axes is None:
            mirror_axes = spec.mirror_axes
        if spec.batch_size:
            batch_size = spec.batch_size
        if spec.aggressive_da and cascade:
            logger.warning("%s: DA5 is not implemented for cascade augmentations; "
                           "using the default cascade stack", trainer_name)
    if mirror_axes is None:
        mirror_axes = (0, 1, 2)
    if patch[2] == 1 and tuple(mirror_axes) == (0, 1, 2):
        mirror_axes = (0, 1)  # the 2d configuration mirrors in-plane only
    out_dir.mkdir(parents=True, exist_ok=True)
    arch = trainer.cfg.arch
    if trainer.writer:
        (out_dir / "export_meta.json").write_text(json.dumps({
            "patch_size": list(patch),
            "num_classes": int(num_classes),
            "features_per_stage": list(arch.features_per_stage),
            "cases_dir": str(cases_dir.resolve()),
        }))
    ckpt = out_dir / "checkpoint_latest.pkl"
    if resume and ckpt.exists():
        trainer.load_checkpoint(ckpt)
        logger.info("Resumed from epoch %d", trainer.state.epoch)
    elif pretrained_weights is not None:
        trainer.load_pretrained_weights(pretrained_weights, verbose=True)

    # on a mesh each dp rank loads and augments its rows of the global batch
    part = None
    if trainer.spmd is not None and trainer.spmd.dp > 1:
        part = (trainer.spmd.d, trainer.spmd.dp)
    loader = DataLoader(
        store, patch, batch_size, seed=seed,
        case_ids=split["train"] if split else None,
        oversample_percent=trainer.cfg.oversample_foreground_percent,
        probabilistic_oversampling=spec.probabilistic_oversampling,
        cascade=cascade, cascade_cc_dropout_p=0.2 if augment else 0.0, part=part)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    aug_fn = augment_batch
    if spec.aggressive_da:
        from boa_tpu_torch.train.augment import augment_batch_da5 as aug_fn

    def batches():
        for batch in loader.prefetched(pin=dev.type == "cuda"):
            if cascade:
                x, y, prev = to_device(batch, dev)
                if augment:
                    yield augment_batch_cascade(gen, x, y, prev, fg_labels,
                                                mirror_axes=tuple(mirror_axes), part=part)
                else:
                    onehot = torch.stack([(prev == lb) for lb in fg_labels],
                                         dim=-1).float()
                    yield torch.cat([x, onehot], dim=-1), y
            elif augment:
                x, y = to_device(batch, dev)
                yield aug_fn(gen, x, y, mirror_axes=tuple(mirror_axes), part=part)
            else:
                yield to_device(batch, dev)

    gen_batches = batches()
    last: dict = {}
    setup_s = time.perf_counter() - t_setup
    while trainer.state.epoch < epochs:
        last = trainer.train_epoch(gen_batches, local_rows=part is not None)
        logger.info("epoch %d: loss=%.4f dice=%.4f ema=%.4f (%.1fs)", last["epoch"],
                    last["loss"], last["dice"], last["ema_dice"], last["epoch_time"])
    gen_batches.close()
    t0 = time.perf_counter()
    trainer.final_checkpoint()
    last.update(setup_s=setup_s, final_checkpoint_s=time.perf_counter() - t0)
    if validate and split:
        t0 = time.perf_counter()
        model = trainer.serving_model()   # on a mesh every rank gathers
        if trainer.writer:
            last["validation"] = perform_actual_validation(trainer, store, split["val"],
                                                           out_dir, patch, model)
            last["validation_s"] = time.perf_counter() - t0
    return last


def load_pretrained_weights(model, fname: str | Path, verbose: bool = False) -> None:
    """Transfer-learning init (`run/load_pretrained_weights.py:7-62`): every
    encoder and decoder parameter from a checkpoint of either package (its
    ``params`` tree, or the tree itself), shapes checked, the segmentation
    heads kept fresh. Copies into `model` in place."""
    import pickle

    from boa_tpu_torch.weights.convert import kernel_from_numpy, param_leaves, tree_get

    with open(fname, "rb") as f:
        blob = pickle.load(f)
    pre = blob["params"] if isinstance(blob, dict) and "params" in blob else blob
    for key in ("encoder", "decoder"):
        if key not in pre:
            raise KeyError(f"pretrained checkpoint has no '{key}' weights")
    moved = []
    for path, p in param_leaves(model):
        if path[0] not in ("encoder", "decoder"):
            continue
        try:
            src = tree_get(pre, path)
        except (KeyError, IndexError) as exc:
            raise ValueError(f"incompatible '{path[0]}' weights: no {path}") from exc
        try:
            moved.append((p, kernel_from_numpy(src, p)))
        except ValueError as exc:
            raise ValueError(
                f"incompatible '{path[0]}' weights: pretrained parameter {path} "
                f"{exc}; the pretrained model is not compatible with this network"
            ) from exc
    with torch.no_grad():
        for p, v in moved:
            p.copy_(v)
    if verbose:
        logger.info("transferred %d pretrained parameters (segmentation heads kept "
                    "fresh)", sum(v.numel() for _, v in moved))


@torch.no_grad()
def perform_actual_validation(trainer, store, val_ids, out_dir: Path, patch,
                              model=None) -> dict:
    """Predict each validation case with the final weights and evaluate
    (`nnUNetTrainer.perform_actual_validation:1212`): the Gaussian sliding
    window at step 0.5 in the trainer's compute dtype on the stored
    (preprocessed) arrays, labels to `validation/{case}.nii.gz`, Dice/IoU
    to `validation/summary.json`. `model` is the trainer's whole network in
    the compute dtype (default `trainer.serving_model()`). The returned
    summary also holds the seconds of the predictions and of the
    evaluation."""
    from boa_tpu_torch.engine.evaluation import evaluate_folder_arrays
    from boa_tpu_torch.inference.sliding_window import sliding_window_logits
    from boa_tpu_torch.io import nifti
    from boa_tpu_torch.ops import preprocess as pp
    from boa_tpu_torch.train.trainer import compute_dtype

    val_dir = Path(out_dir) / "validation"
    val_dir.mkdir(parents=True, exist_ok=True)
    cfg = trainer.cfg.arch
    model = trainer.serving_model() if model is None else model
    dev = trainer.device
    gauss = pp.gaussian_importance_map(tuple(patch))
    refs, preds = {}, {}
    predict_s = 0.0
    for cid in val_ids:
        case = store.load_case(cid, memmap=False)
        data = np.asarray(case.data, np.float32)
        if data.shape[0] < cfg.input_channels and case.prev_seg is not None:
            onehot = np.stack([(np.asarray(case.prev_seg) == lb)
                               for lb in range(1, cfg.num_classes)]).astype(np.float32)
            data = np.concatenate([data, onehot], axis=0)
        padded, revert = pp.pad_to_patch(data, tuple(patch))
        starts = pp.tile_starts(padded.shape[-3:], tuple(patch), 0.5)
        t0 = time.perf_counter()
        logits = sliding_window_logits([model], torch.from_numpy(padded).to(dev), starts,
                                       gauss, cfg.num_classes,
                                       compute_dtype=compute_dtype(trainer.cfg),
                                       accum_dtype=torch.float32)
        seg = torch.argmax(logits, dim=0).cpu().numpy()[revert].astype(np.uint8)
        predict_s += time.perf_counter() - t0
        logger.info("validation %s: %d tiles in %.2fs", cid, len(starts),
                    time.perf_counter() - t0)
        sp = list(case.properties.get("spacing", (1.0, 1.0, 1.0)))[:3]
        nifti.save(nifti.NiftiImage(data=seg, affine=np.diag(list(sp) + [1.0])),
                   val_dir / f"{cid}.nii.gz")
        refs[cid] = np.asarray(case.seg)
        preds[cid] = seg
    labels = sorted({int(v) for s in refs.values() for v in np.unique(s) if v > 0})
    t0 = time.perf_counter()
    summary = evaluate_folder_arrays(refs, preds, labels, out_file=val_dir / "summary.json")
    # the seconds ride on the returned summary only, not on summary.json
    summary["seconds"] = {"predict": predict_s, "evaluate": time.perf_counter() - t0}
    logger.info("validation: %d cases, foreground mean Dice %.4f", len(refs),
                summary.get("foreground_mean", {}).get("Dice", float("nan")))
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("boa_tpu_torch-train")
    ap.add_argument("cases_dir", type=Path)
    ap.add_argument("out_dir", type=Path)
    ap.add_argument("--patch", type=int, nargs=3, default=[128, 128, 128])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--num-classes", type=int, default=None)
    ap.add_argument("--resume", "--c", action="store_true")
    ap.add_argument("--fold", default="all",
                    help="nnU-Net 5-fold split index, or 'all' (default)")
    ap.add_argument("--validate", action="store_true", default=False,
                    help="run the final validation pass over the fold's val split")
    ap.add_argument("--pretrained_weights", type=Path, default=None,
                    help="checkpoint to transfer encoder/decoder weights from "
                         "(segmentation heads stay fresh)")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=259200.0,
                    help="with --dp/--sp/--tp: seconds to wait for the ranks, after "
                         "which every rank is stopped and the run fails (default "
                         "three days; a longer run passes more)")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--no-mirroring", action="store_true",
                    help="disable mirror augmentation (the NoMirroring variants)")
    ap.add_argument("--tr", "-tr", dest="trainer_name", default=None,
                    help="trainer-variant name (nnUNetTrainerDA5, "
                         "nnUNetTrainer_probabilisticOversampling, ...)")
    ap.add_argument("--cascade", action="store_true", default=False,
                    help="train a 3d_cascade_fullres stage on *_prevseg.npy labels")
    ap.add_argument("-d", "--device", default="gpu",
                    help="gpu (default: the card), gpu:N, or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    kw = dict(cases_dir=args.cases_dir, out_dir=args.out_dir, patch=tuple(args.patch),
              batch_size=args.batch, num_classes=args.num_classes, epochs=args.epochs,
              iters=args.iters, resume=args.resume, augment=not args.no_augment,
              mirror_axes=() if args.no_mirroring else None, fold=args.fold,
              validate=args.validate, pretrained_weights=args.pretrained_weights,
              trainer_name=args.trainer_name, cascade=args.cascade, device=args.device)
    world = args.dp * args.sp * args.tp
    if world == 1:
        run_training(**kw)
        return
    from boa_tpu_torch.parallel.mesh import spawn_ranks

    dev = named_device(args.device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"--dp/--sp/--tp make {world} ranks, one a card, but "
                         f"{torch.cuda.device_count()} cards are visible")
    kw["mesh_shape"] = (args.dp, args.sp, args.tp)
    spawn_ranks(_rank_training, world, (kw,), device=dev.type, timeout=args.timeout)


def _rank_training(rank: int, kw: dict) -> None:
    """One rank of `main`'s mesh: the rank's card (or the host), the run."""
    if rank:
        logging.getLogger().setLevel(logging.WARNING)
    dev = named_device(kw["device"])
    run_training(**{**kw, "device": f"cuda:{torch.cuda.current_device()}"
                    if dev.type == "cuda" else "cpu"})


if __name__ == "__main__":
    main()
