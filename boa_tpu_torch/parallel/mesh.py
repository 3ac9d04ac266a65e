"""Device meshes, process groups and the sharding rules of the U-Net family.

Counterpart of `boa_tpu/parallel/mesh.py` (`make_mesh`,
`initialize_distributed`, `make_multihost_mesh`, `default_mesh_shape`,
`batch_sharding`, `label_sharding`, `replicated`, `param_shardings`,
`spatial_sharding`) on `torch.distributed`: one process (rank) per device,
a `DeviceMesh` from `init_device_mesh` with the dims

  dp - data parallel: the batch axis of the train step;
  sp - spatial parallel: the z axis of the activations (z-slabs with halos);
  tp - tensor parallel: the output channels of each conv, transposed conv
       and instance norm.

The reference lets GSPMD insert the collectives from `NamedSharding`
annotations; here the rules are DTensor placements (one per mesh dim) that
`parallel/spmd.py` applies by hand: `param_shardings` places the network,
`train/trainer.py:opt_state_shardings` its optimizer state, and
`batch_sharding` / `label_sharding` the batch (a Shard(d) on a mesh dim is
the rank's slice of d). `replicated` and `spatial_sharding` are the
reference's API beside them; the port's own code uses them through the
rules above or not at all (an inference volume is dealt by tiles,
`parallel/sharded_inference.py`). Activations and targets are the train
step's (N, X, Y, Z, C) and (N, X, Y, Z); parameters are torch's NCDHW
weights (Conv3d (co, ci, k...), ConvTranspose3d (ci, co, k...)), each rule
chosen by what the axis means.

`spawn_ranks` starts one process per rank (the `spawn` start method), each
with its process group, and joins them all with a timeout: a rank that
fails or hangs fails the call.
"""

from __future__ import annotations

import math
import os
import queue
import socket
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

AXES = ("dp", "sp", "tp")


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _require_group(what: str) -> int:
    if not dist.is_initialized():
        raise ValueError(f"{what} needs a process group: call "
                         "parallel.mesh.initialize_distributed first (one rank per device)")
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None, axes: Sequence[str] = AXES,
              shape: Sequence[int] | None = None):
    """A `DeviceMesh` over the process group's ranks, in rank order.

    The default puts every rank on dp (sp and tp singleton); pass `shape`
    to shard the model, e.g. (2, 2, 2) on 8 ranks. `n_devices` must be the
    world size (one rank per device)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _require_group("make_mesh")
    n = world if n_devices is None else int(n_devices)
    if shape is None:
        shape = [n] + [1] * (len(axes) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    if n != world:
        raise ValueError(f"a mesh of {n} devices on a process group of {world} ranks: "
                         "the port runs one rank per device")
    return init_device_mesh(_mesh_device_type(), tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device: str = "cuda",
                           backend: str | None = None) -> None:
    """`init_process_group` for this rank: NCCL on the card (`device`
    "cuda", the rank's device rank % device count, RuntimeError without
    CUDA), gloo on the host (`device="cpu"`). `coordinator_address` is the
    init method (`tcp://host:port`, `file://path`; default `env://`).
    `backend` overrides the choice (gloo can also reduce CUDA tensors:
    several ranks on one card). Safe to call twice."""
    from boa_tpu_torch.device import resolve_device

    if dist.is_initialized():
        return
    dev = resolve_device(device)
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        # before any mesh: DeviceMesh respects a device already chosen
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=coordinator_address or "env://",
                            world_size=world, rank=rank)


def multihost_layout(world: int, ici_shape: Sequence[int] | None = None,
                     n_hosts: int = 1) -> np.ndarray:
    """The (dp, sp, tp) array of ranks with hosts on the outer dp axis:
    ranks are host-major, each host's block laid out by `ici_shape`
    (default `default_mesh_shape` of its rank count), the host axis merged
    into dp, so dp's reductions cross hosts and sp/tp's stay inside one."""
    if world % n_hosts:
        raise ValueError(f"{world} devices not divisible by {n_hosts} hosts")
    per_host = world // n_hosts
    if ici_shape is None:
        ici_shape = default_mesh_shape(per_host)
    if math.prod(ici_shape) != per_host:
        raise ValueError(f"ici shape {tuple(ici_shape)} != {per_host} local devices")
    arr = np.arange(world).reshape((n_hosts, *ici_shape))
    return arr.reshape((n_hosts * ici_shape[0], *ici_shape[1:]))


def make_multihost_mesh(axes: Sequence[str] = AXES, ici_shape: Sequence[int] | None = None,
                        n_hosts: int | None = None):
    """A `DeviceMesh` over every rank with hosts on the outer dp axis
    (`multihost_layout`). `n_hosts` defaults to the world size over the
    ranks of one host (`LOCAL_WORLD_SIZE`, else the card count, else 1);
    pass it to lay a single host out as several (tests)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = _require_group("make_multihost_mesh")
    if n_hosts is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
            torch.cuda.device_count() if _mesh_device_type() == "cuda" else world)
        n_hosts = max(1, world // max(local, 1))
    layout = multihost_layout(world, ici_shape, n_hosts)
    return DeviceMesh(_mesh_device_type(), torch.as_tensor(layout),
                      mesh_dim_names=tuple(axes))


def default_mesh_shape(n_devices: int) -> tuple[int, int, int]:
    """(dp, sp, tp) factorization: prefer tp=2 then sp=2, rest on dp."""
    tp = 2 if n_devices % 2 == 0 else 1
    rem = n_devices // tp
    sp = 2 if rem % 2 == 0 and rem >= 2 else 1
    dp = rem // sp
    return dp, sp, tp


def _placements(mesh, **dims) -> tuple:
    names = mesh.mesh_dim_names
    return tuple(dims.get(name, Replicate()) for name in names)


def batch_sharding(mesh, spatial_axis: int | None = 3) -> tuple:
    """(N, X, Y, Z, C) activations: batch over dp, z over sp."""
    kw = {"dp": Shard(0)}
    if spatial_axis is not None:
        kw["sp"] = Shard(spatial_axis)
    return _placements(mesh, **kw)


def label_sharding(mesh, spatial_axis: int | None = 3) -> tuple:
    """(N, X, Y, Z) integer targets: batch over dp, z over sp."""
    return batch_sharding(mesh, spatial_axis)


def replicated(mesh) -> tuple:
    return _placements(mesh)


def spatial_sharding(mesh, ndim: int, axis: int) -> tuple:
    """One spatial axis of an `ndim` inference volume over sp."""
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim} dims")
    return _placements(mesh, sp=Shard(axis % ndim))


def _out_channel_dim(mod, pname: str) -> int | None:
    """The output-channel axis of a U-Net layer's parameter: Conv3d weight
    and bias 0, ConvTranspose3d weight 1 and bias 0, instance-norm scale and
    bias 0."""
    if isinstance(mod, torch.nn.ConvTranspose3d) and pname == "weight":
        return 1
    if isinstance(mod, (torch.nn.Conv3d, torch.nn.ConvTranspose3d, torch.nn.InstanceNorm3d)):
        return 0
    return None


def param_shardings(mesh, model) -> dict[str, tuple]:
    """Name -> placements of every parameter of `model`, the rule the mesh
    step shards by (`parallel/spmd.py:Spmd.shard`): the output-channel axis
    of each conv, transposed conv and instance norm of a U-Net over tp where
    its extent divides by tp; replicated are the seg heads (their output
    axis is classes), the axes tp does not divide, every parameter of
    another network (Primus shards over dp only), and everything over dp
    and sp."""
    from boa_tpu_torch.models.unet import PlainConvUNet

    tp = mesh.size(mesh.mesh_dim_names.index("tp")) if "tp" in mesh.mesh_dim_names else 1
    unet = isinstance(model, PlainConvUNet)
    out = {}
    for mod_name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            dim = (_out_channel_dim(mod, pname)
                   if unet and not mod_name.startswith("seg_heads") else None)
            out[f"{mod_name}.{pname}" if mod_name else pname] = (
                _placements(mesh, tp=Shard(dim))
                if tp > 1 and dim is not None and p.shape[dim] % tp == 0
                else replicated(mesh))
    return out


# ---------------------------------------------------------------------------
# ranks in processes of their own
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _rank_entry(fn, rank, world, init_method, device, backend, args, results) -> None:
    if device == "cpu":   # the host's cores shared among the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        initialize_distributed(init_method, world, rank, device=device, backend=backend)
        value = fn(rank, *args)
        results.put((rank, True, value))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), *, device: str = "cpu",
                backend: str | None = None, init_method: str | None = None,
                timeout: float | None = 600.0) -> list:
    """Run `fn(rank, *args)` in `world_size` spawned processes, each with
    its process group (`initialize_distributed(init_method, world_size,
    rank, device, backend)`; default a free localhost TCP port), and return
    their results in rank order. `fn` and `args` are pickled (a module-level
    function). A rank that raises or exits makes it raise RuntimeError with
    the rank's traceback; past `timeout` seconds every rank is terminated and
    TimeoutError raised. Every process is joined before it returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = init_method or f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, world_size, init_method, device,
                                                   backend, tuple(args), results))
             for r in range(world_size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    got: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                       "without a result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(None if deadline is None else max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"a rank did not exit in {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"rank {bad[0][0]} exited with code {bad[0][1]}")
    return [got[r] for r in range(world_size)]
