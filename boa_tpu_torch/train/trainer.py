"""nnU-Net trainer: the train step, the eval step and the epoch loop.

Counterpart of `boa_tpu/train/trainer.py` (nnU-Net's
`nnUNetTrainer.py`: `train_step:973-1003`, PolyLR per epoch `:960`,
checkpoints `:1149-1210`, the EMA pseudo dice `:1087-1095`).

The master weights are the float32 parameters of the network: a U-Net
(`PlainConvUNet` or `ResidualEncoderUNet`) or, for a `PrimusConfig`, the
Primus ViT (`models/primus.py`: one head, no deep supervision, its position
embedding made for the (4, 4, 4) token grid and resized at the forward, as
the reference's `_init_model`). The step casts them to the compute dtype inside the forward, as the
reference's `loss_fn` casts its pytree (`boa_tpu/train/trainer.py:194-200`):
`torch.func.functional_call` runs the module on bf16 copies made by
differentiable casts, so the gradients land on the float32 masters.
(`torch.autocast` is not used: it keeps another set of ops in float32 than
the reference; `models/unet.py:cast_model` deep-copies, which would stop
the gradients.) The forward asks for every head (`all_heads=True`), so it
is the eager path under autograd — the reference trains on XLA's
convolutions, its kernels serve inference only. Loss and gradients are
float32; the clip and the update follow (`train/optim.py`), with no host
sync inside the step.

The eval step (the pseudo dice of each epoch's last batch) runs a copy of
the network in the compute dtype, refreshed in place from the masters
before each use: in bf16 at a qualifying geometry that forward is the
K1-K3 composite, whose packed weights (`models/unet.py:_row_packs`) are
keyed on each parameter's `_version`, so the in-place refresh repacks them.

On a device mesh (`mesh=`, `parallel/mesh.py:make_mesh`) each rank holds
its shards (`parallel/spmd.py:Spmd`) and runs the same step, with the
mesh's collectives, on its part of every global batch; checkpoints gather
the shards and rank 0 writes them, so a mesh run's files are one device's.

Checkpoints are the reference's pickle (`params`, `momentum_buf` — SGD's
momentum tree or Adam's ``{"m", "v", "step"[, "vmax"]}`` — `epoch`,
`best_ema`, `ema_dice`, `logs`), numpy trees in the reference's layout, so
either package resumes the other's.
"""

from __future__ import annotations

import copy
import json
import pickle
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch
from torch.func import functional_call

from boa_tpu_torch.device import resolve_device
from boa_tpu_torch.models.unet import ArchConfig
from boa_tpu_torch.train.dataloader import to_device
from boa_tpu_torch.train.losses import (deep_supervision_loss, make_loss,
                                        pseudo_dice)
from boa_tpu_torch.train.optim import (clip_by_global_norm, cosine_anneal_lr,
                                       lin_incr_lr, make_optimizer,
                                       opt_state_from_numpy, opt_state_to_numpy,
                                       poly_lr, poly_lr_offset, set_lr)
from boa_tpu_torch.weights.convert import (load_params_into, params_from_numpy,
                                           params_to_numpy)

CHECKPOINT_EVERY = 50  # nnUNetTrainer.py:158 save_every


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (nnUNetTrainer.py:145-158) and the
    trainer-variant knobs: loss (a `make_loss` name), optimizer (sgd |
    adamw_amsgrad | adamw | adam), lr_schedule (poly | cos | warmup_poly),
    regions (one label tuple per output channel for region training)."""

    arch: ArchConfig
    initial_lr: float = 1e-2
    weight_decay: float = 3e-5
    momentum: float = 0.99
    grad_clip: float = 12.0
    num_epochs: int = 1000
    iters_per_epoch: int = 250
    batch_dice: bool = True
    oversample_foreground_percent: float = 0.33
    compute_dtype: str = "bfloat16"
    loss: str = "dice_ce"
    optimizer: str = "sgd"
    lr_schedule: str = "poly"
    warmup_epochs: int = 50
    adam_betas: tuple[float, float] = (0.9, 0.999)
    regions: tuple | None = None


@dataclass
class TrainState:
    """The network (float32 masters), its optimizer, and the loop's state."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0
    best_ema: float = -1.0
    ema_dice: float | None = None
    logs: list = field(default_factory=list)


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def init_opt_state(cfg: TrainConfig, model: torch.nn.Module) -> torch.optim.Optimizer:
    """The optimizer of cfg.optimizer over the network's parameters."""
    return make_optimizer(cfg.optimizer, model.parameters(), cfg.initial_lr,
                          momentum=cfg.momentum, weight_decay=cfg.weight_decay,
                          betas=cfg.adam_betas)


def schedule_lr(cfg: TrainConfig, epoch: int) -> float:
    """The epoch's learning rate under cfg.lr_schedule."""
    if cfg.lr_schedule == "poly":
        return float(poly_lr(cfg.initial_lr, epoch, cfg.num_epochs))
    if cfg.lr_schedule == "cos":
        return float(cosine_anneal_lr(cfg.initial_lr, epoch, cfg.num_epochs))
    if cfg.lr_schedule == "warmup_poly":
        if epoch < cfg.warmup_epochs:
            return float(lin_incr_lr(cfg.initial_lr, epoch, cfg.warmup_epochs))
        return float(poly_lr_offset(cfg.initial_lr, epoch, cfg.num_epochs,
                                    offset=cfg.warmup_epochs))
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def init_model(arch, seed: int, device) -> torch.nn.Module:
    """The network of `arch` from numpy draws of `seed`, float32, in train
    mode: a U-Net for an `ArchConfig` (torch's default bounds,
    `weights/store.py:init_params_numpy`), the Primus ViT for a
    `PrimusConfig` (its position embedding on the (4, 4, 4) token grid; any
    grid trains, the forward resizes it)."""
    from boa_tpu_torch.models.primus import (PrimusConfig, init_primus,
                                             primus_params_from_numpy)
    from boa_tpu_torch.weights.store import init_params_numpy

    if isinstance(arch, PrimusConfig):
        model = primus_params_from_numpy(init_primus(seed, arch, (4, 4, 4)), arch,
                                         device=device)
    elif isinstance(arch, ArchConfig):
        model = params_from_numpy(init_params_numpy(arch, seed), arch, device=device)
    else:
        raise TypeError(f"no network for {type(arch).__name__}")
    return model.train()


def opt_state_shardings(cfg: TrainConfig, params_sharding: dict) -> dict | object:
    """The placements of the optimizer state of `params_sharding` (name ->
    placements, `parallel/mesh.py:param_shardings`), in the layout of the
    reference's checkpoint tree: SGD's momentum as the parameters; the Adam
    family's {m, v, step[, vmax]} with m, v and vmax as the parameters and
    the step replicated."""
    from torch.distributed.tensor import Replicate

    if cfg.optimizer == "sgd":
        return params_sharding
    if cfg.optimizer not in ("adamw_amsgrad", "adamw", "adam"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    ndim = len(next(iter(params_sharding.values())))
    sh = {"m": params_sharding, "v": params_sharding, "step": (Replicate(),) * ndim}
    if cfg.optimizer == "adamw_amsgrad":
        sh["vmax"] = params_sharding
    return sh


def _loss_of(cfg: TrainConfig, outs: list[torch.Tensor], y: torch.Tensor,
             reduce=None) -> torch.Tensor:
    """The training loss of `outs` (every head). `reduce`, a sum over the
    ranks of a device mesh, makes its sums global (`train/losses.py`)."""
    if cfg.regions is not None and reduce is not None:
        raise ValueError("region training does not run over a device mesh")
    if cfg.regions is not None:
        from boa_tpu_torch.train.losses import (deep_supervision_loss_regions,
                                                dice_bce_loss,
                                                regions_to_multihot)

        if len(outs) > 1:
            return deep_supervision_loss_regions(outs, y, cfg.regions,
                                                 batch_dice=cfg.batch_dice)
        return dice_bce_loss(outs[0], regions_to_multihot(y, cfg.regions),
                             batch_dice=cfg.batch_dice)
    base = make_loss(cfg.loss, batch_dice=cfg.batch_dice, reduce=reduce)
    if len(outs) > 1:
        return deep_supervision_loss(outs, y, loss_fn=base)
    return base(outs[0], y)


def make_train_step(cfg: TrainConfig, spmd=None) -> Callable:
    """step(model, optimizer, x, y, lr=None) -> {"loss", "grad_norm"}, both
    device scalars; the parameters and the optimizer state change in place.
    x (N, X, Y, Z, C) float32, y (N, X, Y, Z) int; `lr` sets the groups'
    learning rate first. With `spmd` (`parallel/spmd.py:Spmd`) `model` is
    this rank's shard and (x, y) its part of the global batch
    (`Spmd.local_batch`); loss and norm are the global ones."""
    dtype = compute_dtype(cfg)
    reduce = spmd.sum_data if spmd is not None and spmd.n_data > 1 else None

    def step(model, optimizer, x, y, lr=None):
        params = dict(model.named_parameters())
        cast = {k: (v.to(dtype) if v.dtype == torch.float32 else v)
                for k, v in params.items()}
        outs = functional_call(model, cast, (x.to(dtype),), {"all_heads": True})
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        loss = _loss_of(cfg, [o.float() for o in outs], y, reduce=reduce)
        optimizer.zero_grad(set_to_none=True)
        if spmd is None:
            loss.backward()
        else:   # each rank's share of the global loss's gradient, summed below
            (loss * (1.0 / spmd.n_data)).backward()
        # a parameter the loss does not reach (the zero-weighted lowest head)
        # still takes weight decay and momentum, as in the reference
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params.values()]
        if spmd is None:
            gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        else:
            spmd.sum_grads(grads)
            gnorm = spmd.clip_by_global_norm(grads, model, cfg.grad_clip)
        if lr is not None:
            set_lr(optimizer, lr)
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_eval_step(cfg: TrainConfig, spmd=None) -> Callable:
    """eval(model, x, y) -> per-class pseudo dice of the highest-resolution
    head, with `model` already in the compute dtype. With `spmd`, of the
    global batch from this rank's shards (the counts all-reduced over dp
    and sp; a sharded network runs its eager forward, the K1-K3 composite
    reads whole weights)."""
    dtype = compute_dtype(cfg)

    @torch.no_grad()
    def step(model, x, y):
        if spmd is not None and spmd.spatial:
            out = model.forward_eager(x.to(dtype)).float()
        else:
            out = model(x.to(dtype)).float()
        if cfg.regions is not None:
            from boa_tpu_torch.train.losses import pseudo_dice_regions

            return pseudo_dice_regions(out, y, cfg.regions)
        return pseudo_dice(out, y, reduce=None if spmd is None else spmd.sum_data)

    return step


class Trainer:
    """The epoch loop around the step. `batches` yields (x, y): numpy arrays
    or tensors, on the device or pinned (`dataloader.DataLoader.prefetched`).
    The network starts from numpy draws of `seed` (`init_model`), on
    `device` (the card by default). With `mesh` (a dp x sp x tp
    `DeviceMesh`, one rank per device) each rank keeps its shards, takes its
    part of every global batch and runs the step over the mesh. The loop
    never waits for the device: on the card each iteration's seconds
    (`iter_s`) and the device's wait for the host before each step
    (`device_wait_s`, the loader's and the launches') come from CUDA events,
    read at the epoch's one readback; `loader_wait_s` is the host's time in
    `next(batches)`."""

    def __init__(self, cfg: TrainConfig, out_dir: str | Path, seed: int = 0,
                 device=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        model = init_model(cfg.arch, seed, self.device)
        self.spmd = None
        if mesh is not None:
            from boa_tpu_torch.parallel.spmd import Spmd

            self.spmd = Spmd(mesh)
            self.spmd.check(model)
            self._shard(model)
        self._step = make_train_step(cfg, self.spmd)
        self._eval = make_eval_step(cfg, self.spmd)
        self.state = TrainState(model=model, optimizer=init_opt_state(cfg, model))
        self._eval_model: torch.nn.Module | None = None

    def _shard(self, model: torch.nn.Module, optimizer=None):
        """Keep this rank's shards of `model` (and of `optimizer`'s state,
        returning the new optimizer) by the placements of
        `parallel/mesh.py:param_shardings` and `opt_state_shardings`."""
        from boa_tpu_torch.parallel.mesh import param_shardings

        ps = param_shardings(self.spmd.mesh, model)
        return self.spmd.shard(model, ps, optimizer, lambda m: init_opt_state(self.cfg, m),
                               opt_state_shardings(self.cfg, ps))

    @property
    def writer(self) -> bool:
        """Whether this process writes the run's files (rank 0 on a mesh)."""
        return self.spmd is None or self.spmd.writer

    # ------------------------------------------------------------------
    def eval_model(self) -> torch.nn.Module:
        """The network in the compute dtype, refreshed in place from the
        masters (the in-place copy bumps each parameter's version, so the
        composite repacks its weights)."""
        model = self.state.model
        if compute_dtype(self.cfg) == torch.float32:
            return model
        if self._eval_model is None:
            self._eval_model = copy.deepcopy(model).to(compute_dtype(self.cfg)).eval()
        with torch.no_grad():
            for pe, p in zip(self._eval_model.parameters(), model.parameters()):
                pe.copy_(p)
        return self._eval_model

    def train_epoch(self, batches: Iterator, n_iters: int | None = None,
                    local_rows: bool = False) -> dict:
        """One epoch of `n_iters` (default the config's) steps. On a mesh
        each batch is the global one, or with `local_rows` this rank's dp
        rows of it (`DataLoader(part=...)`)."""
        cfg, st = self.cfg, self.state
        lr = schedule_lr(cfg, st.epoch)
        set_lr(st.optimizer, lr)
        n = n_iters if n_iters is not None else cfg.iters_per_epoch
        metrics, wait = [], 0.0
        # marks[i] before iteration i asks for its batch, starts[i] once it
        # has it: CUDA events on the card, host clocks on the CPU
        cuda = self.device.type == "cuda"

        def mark():
            if not cuda:
                return time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def span(a, b) -> float:
            return a.elapsed_time(b) / 1000.0 if cuda else b - a

        t0 = time.perf_counter()
        marks, starts = [mark()], []
        for _ in range(n):
            t_it = time.perf_counter()
            batch = next(batches)
            wait += time.perf_counter() - t_it
            starts.append(mark())
            x, y = to_device(batch[:2], self.device)
            if self.spmd is not None:
                rows = x.shape[0] * (self.spmd.dp if local_rows else 1)
                self.spmd.check(st.model, rows, x.shape[3])
                x, y = self.spmd.local_batch(x, y, rows_local=local_rows)
            metrics.append(self._step(st.model, st.optimizer, x, y))
            marks.append(mark())
        # one readback per metric for the epoch, after the last event
        logs = {k: float(torch.stack([m[k] for m in metrics]).mean()) for k in metrics[0]}
        iter_s = [span(a, b) for a, b in zip(marks, marks[1:])]
        device_wait = sum(span(a, b) for a, b in zip(marks, starts))
        # pseudo dice on the last batch with the updated weights (a one-batch
        # sample of the reference's validation pass); absent classes NaN
        per_class = self._eval(self.eval_model(), x, y).cpu().numpy()
        logs["dice"] = (float(np.nanmean(per_class))
                        if not np.isnan(per_class).all() else 0.0)
        logs.update(epoch=st.epoch, lr=float(lr), epoch_time=time.perf_counter() - t0,
                    loader_wait_s=wait, device_wait_s=device_wait, iter_s=iter_s)
        d = logs["dice"]
        st.ema_dice = d if st.ema_dice is None else 0.9 * st.ema_dice + 0.1 * d
        logs["ema_dice"] = st.ema_dice
        st.logs.append(logs)
        st.epoch += 1
        t_ckpt = time.perf_counter()
        if st.ema_dice > st.best_ema:
            st.best_ema = st.ema_dice
            self.save_checkpoint(self.out_dir / "checkpoint_best.pkl")
        if st.epoch % CHECKPOINT_EVERY == 0 or st.epoch == cfg.num_epochs:
            self.save_checkpoint(self.out_dir / "checkpoint_latest.pkl")
        logs["checkpoint_s"] = time.perf_counter() - t_ckpt
        return logs

    # ------------------------------------------------------------------
    def whole(self):
        """(network, optimizer) whole: the trainer's own on one device, the
        shards gathered on a mesh (every rank must call)."""
        st = self.state
        if self.spmd is None:
            return st.model, st.optimizer
        return self.spmd.gathered(st.model, st.optimizer,
                                  lambda m: init_opt_state(self.cfg, m))

    def serving_model(self) -> torch.nn.Module:
        """The whole network in the compute dtype, for a sliding window (on a
        mesh every rank must call: the shards are gathered)."""
        if self.spmd is None:
            return self.eval_model()
        model = self.whole()[0]
        return model if compute_dtype(self.cfg) == torch.float32 else \
            model.to(compute_dtype(self.cfg)).eval()

    def save_checkpoint(self, path: str | Path) -> None:
        """The resumable state in the reference's pickle layout (on a mesh,
        gathered by every rank and written by rank 0)."""
        st = self.state
        model, optimizer = self.whole()
        if not self.writer:
            return
        blob = {"params": params_to_numpy(model),
                "momentum_buf": opt_state_to_numpy(model, optimizer),
                "epoch": st.epoch, "best_ema": st.best_ema,
                "ema_dice": st.ema_dice, "logs": st.logs}
        tmp = Path(str(path) + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
        tmp.replace(path)

    def load_checkpoint(self, path: str | Path) -> None:
        """Resume from a checkpoint of either package."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        st = self.state
        if self.spmd is not None:   # load whole, then keep this rank's shards
            st.model = init_model(self.cfg.arch, 0, self.device)
        load_params_into(st.model, blob["params"])
        st.optimizer = init_opt_state(self.cfg, st.model)
        opt_state_from_numpy(st.model, st.optimizer, blob["momentum_buf"])
        if self.spmd is not None:
            st.optimizer = self._shard(st.model, st.optimizer)
            self._eval_model = None
        st.epoch, st.best_ema = blob["epoch"], blob["best_ema"]
        st.ema_dice, st.logs = blob["ema_dice"], blob["logs"]

    def load_pretrained_weights(self, path: str | Path, verbose: bool = False) -> None:
        """Transfer-learning init (`train/run_training.py:
        load_pretrained_weights`: encoder and decoder from a checkpoint, the
        heads kept) into the whole network; on a mesh the shards are
        gathered with the optimizer's state, loaded and sharded again."""
        from boa_tpu_torch.train.run_training import load_pretrained_weights

        st = self.state
        if self.spmd is None:
            load_pretrained_weights(st.model, path, verbose=verbose)
            return
        model, optimizer = self.whole()
        load_pretrained_weights(model, path, verbose=verbose)
        st.optimizer = self._shard(model, optimizer)
        st.model = model
        self._eval_model = None

    def final_checkpoint(self) -> None:
        self.save_checkpoint(self.out_dir / "checkpoint_final.pkl")
        if not self.writer:
            return
        with open(self.out_dir / "training_log.json", "w") as f:
            json.dump(self.state.logs, f, indent=2)
