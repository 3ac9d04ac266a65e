"""Rank functions for `tests/test_torch_parallel.py`: module-level (spawned
processes unpickle them by name) and free of JAX, so that each rank imports
torch and the port only."""

from __future__ import annotations

import numpy as np
import torch


def small_arch(feats=(4, 8), num_classes=3, deep_supervision=True):
    from boa_tpu_torch.models.unet import ArchConfig

    n = len(feats)
    return ArchConfig(n_stages=n, features_per_stage=tuple(feats),
                      kernel_sizes=((3, 3, 3),) * n,
                      strides=((1, 1, 1),) + ((2, 2, 2),) * (n - 1),
                      n_conv_per_stage=(2,) * n, n_conv_per_stage_decoder=(2,) * (n - 1),
                      num_classes=num_classes, deep_supervision=deep_supervision)


def train_step(rank: int, shape, arch, x: np.ndarray, y: np.ndarray, out_dir: str,
               optimizer: str = "sgd", seed: int = 1, checkpoint: str | None = None) -> dict:
    """One float32 step of `arch` from `seed` (or from `checkpoint`, a
    reference-layout pickle) on the global batch (x, y): over a mesh of
    `shape` (dp, sp, tp) when `shape` is given (this rank's shard), else on
    one process. Returns the loss, the grad norm and (rank 0, or one
    process) the whole parameters after the step as the reference's tree."""
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer
    from boa_tpu_torch.weights.convert import params_to_numpy

    cfg = TrainConfig(arch=arch, compute_dtype="float32", optimizer=optimizer)
    mesh = None
    if shape is not None:
        from boa_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(int(np.prod(shape)), ("dp", "sp", "tp"), tuple(shape))
    tr = Trainer(cfg, out_dir, seed=seed, device="cpu", mesh=mesh)
    if checkpoint is not None:
        tr.load_checkpoint(checkpoint)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if tr.spmd is not None:
        tr.spmd.check(tr.state.model, xt.shape[0], xt.shape[3])
        xt, yt = tr.spmd.local_batch(xt, yt)
    m = tr._step(tr.state.model, tr.state.optimizer, xt, yt, 1e-2)
    model, _ = tr.whole()
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": params_to_numpy(model) if tr.writer else None}


def pretrained(rank: int, shape, arch, checkpoint: str, out_dir: str) -> dict | None:
    """A trainer of `arch` from seed 1 over a mesh of `shape` (or one
    process) given the encoder and decoder of `checkpoint`
    (`Trainer.load_pretrained_weights`); rank 0's whole parameters."""
    from boa_tpu_torch.train.trainer import TrainConfig, Trainer
    from boa_tpu_torch.weights.convert import params_to_numpy

    mesh = None
    if shape is not None:
        from boa_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(int(np.prod(shape)), ("dp", "sp", "tp"), tuple(shape))
    tr = Trainer(TrainConfig(arch=arch, compute_dtype="float32"), out_dir, seed=1,
                 device="cpu", mesh=mesh)
    tr.load_pretrained_weights(checkpoint)
    sharded = None if tr.spmd is None else sum(tr.spmd.sharded(tr.state.model))
    model, _ = tr.whole()
    return {"params": params_to_numpy(model), "sharded": sharded} if tr.writer else None


def sharded_logits(rank: int, params: list, arch, vol: np.ndarray, starts: np.ndarray,
                   gauss: np.ndarray, n: int) -> np.ndarray:
    from boa_tpu_torch.parallel.mesh import make_mesh
    from boa_tpu_torch.parallel.sharded_inference import sliding_window_logits_sharded
    from boa_tpu_torch.weights.convert import params_from_numpy

    mesh = make_mesh(n, ("dp",), (n,))
    models = [params_from_numpy(p, arch, device="cpu") for p in params]
    return sliding_window_logits_sharded(models, torch.from_numpy(vol), starts, gauss,
                                         arch.num_classes, mesh,
                                         compute_dtype=torch.float32).numpy()


def sharded_seg(rank: int, params: list, arch, vol: np.ndarray, starts: np.ndarray,
                gauss: np.ndarray, n: int) -> np.ndarray:
    from boa_tpu_torch.parallel.mesh import make_mesh
    from boa_tpu_torch.parallel.sharded_inference import sliding_window_seg_sharded_chunked
    from boa_tpu_torch.weights.convert import params_from_numpy

    mesh = make_mesh(n, ("dp",), (n,))
    models = [params_from_numpy(p, arch, device="cpu") for p in params]
    return sliding_window_seg_sharded_chunked(models, torch.from_numpy(vol), starts, gauss,
                                              arch.num_classes, mesh,
                                              compute_dtype=torch.float32).numpy()


def zslab(rank: int, params: list, arch, vol: np.ndarray, gauss: np.ndarray,
          n: int) -> np.ndarray:
    from boa_tpu_torch.parallel.mesh import make_mesh
    from boa_tpu_torch.parallel.sharded_inference import sliding_window_logits_zslab
    from boa_tpu_torch.weights.convert import params_from_numpy

    mesh = make_mesh(n, ("dp",), (n,))
    models = [params_from_numpy(p, arch, device="cpu") for p in params]
    return sliding_window_logits_zslab(models, torch.from_numpy(vol), gauss,
                                       arch.num_classes, mesh,
                                       compute_dtype=torch.float32).numpy()


def mesh_layouts(rank: int) -> dict:
    """The meshes of a 4-rank group: make_mesh's default and a (1, 2, 2),
    and make_multihost_mesh as 2 hosts of (1, 1, 2)."""
    from boa_tpu_torch.parallel.mesh import make_mesh, make_multihost_mesh

    flat = make_mesh(4)
    m = make_mesh(4, shape=(1, 2, 2))
    mh = make_multihost_mesh(n_hosts=2, ici_shape=(1, 1, 2))
    return {"flat": flat.mesh.tolist(), "mesh": m.mesh.tolist(),
            "coord": list(m.get_coordinate()), "multihost": mh.mesh.tolist(),
            "multihost_shape": [mh.size(i) for i in range(3)]}


def rules(rank: int, arch) -> dict:
    """The placements of a (1, 1, 2) mesh: every parameter's, the batch's,
    the labels', an inference volume's."""
    from boa_tpu_torch.parallel.mesh import (batch_sharding, label_sharding, make_mesh,
                                             param_shardings, replicated, spatial_sharding)
    from boa_tpu_torch.weights.convert import params_from_numpy
    from boa_tpu_torch.weights.store import init_params_numpy

    mesh = make_mesh(2, shape=(1, 1, 2))
    model = params_from_numpy(init_params_numpy(arch, 0), arch, device="cpu")
    return {"params": {k: [str(p) for p in v] for k, v in param_shardings(mesh, model).items()},
            "batch": [str(p) for p in batch_sharding(mesh)],
            "label": [str(p) for p in label_sharding(mesh)],
            "replicated": [str(p) for p in replicated(mesh)],
            "spatial": [str(p) for p in spatial_sharding(mesh, 4, -1)]}


def two_rank_suite(rank: int, jobs: dict) -> dict:
    """Every 2-rank check of the test file in one process group: the dp, sp
    and tp train steps, the sharded logits and labels, the rules."""
    out = {"steps": {name: train_step(rank, shape, jobs["arch"], jobs["x"], jobs["y"],
                                      jobs["out_dir"], checkpoint=jobs["checkpoint"])
                     for name, shape in jobs["steps"].items()}}
    out["primus_dp"] = train_step(rank, (2, 1, 1), jobs["primus"], jobs["x"], jobs["y"],
                                  jobs["out_dir"])
    try:
        train_step(rank, (1, 1, 2), jobs["primus"], jobs["x"], jobs["y"], jobs["out_dir"])
        out["primus_tp"] = "ran"
    except ValueError as exc:
        out["primus_tp"] = str(exc)
    inf = jobs["inference"]
    out["logits"] = sharded_logits(rank, inf["params"], inf["arch"], inf["vol"], inf["starts"],
                                   inf["gauss"], 2)
    out["seg"] = sharded_seg(rank, inf["params"], inf["arch"], inf["vol"], inf["starts"],
                             inf["gauss"], 2)
    out["rules"] = rules(rank, jobs["arch"])
    out["pretrained_tp"] = pretrained(rank, (1, 1, 2), jobs["arch"], jobs["checkpoint"],
                                      jobs["out_dir"])
    out["run_training"] = run_training(rank, jobs["run_training"])
    return out


def run_training(rank: int, job: dict) -> dict:
    """`run_training` over a (2, 1, 1) mesh (or one process when `rank` is
    None): the last epoch's log and the final checkpoint's parameters."""
    import pickle
    from pathlib import Path

    from boa_tpu_torch.train.run_training import run_training as run

    last = run(job["cases"], job["out"], mesh_shape=None if rank is None else (2, 1, 1),
               **job["kw"])
    out = Path(job["out"])
    if rank not in (None, 0):
        return {"loss": last["loss"]}
    blob = pickle.loads((out / "checkpoint_final.pkl").read_bytes())
    return {"loss": last["loss"], "dice": last["dice"], "params": blob["params"],
            "validation": "validation" in last,
            "files": sorted(p.name for p in out.iterdir())}


def four_rank_suite(rank: int, jobs: dict) -> dict:
    """The 4-rank checks: the z-slab logits and the mesh layouts."""
    z = jobs["zslab"]
    return {"zslab": zslab(rank, z["params"], z["arch"], z["vol"], z["gauss"], 4),
            "layouts": mesh_layouts(rank)}
