"""The train step over a dp x sp x tp mesh, written by hand.

Counterpart of the reference's GSPMD train step (`boa_tpu/train/trainer.py:
make_train_step` with `in_shardings`, `opt_state_shardings`): the same loss
and the same update as one device computes on the whole batch, in float32
to the last few bits. One rank per device; each holds its dp rows of the
global batch, its sp slab of z, and its tp shard of the output channels of
every conv, transposed conv and instance norm. What a rank holds follows
one rule, the placements of `parallel/mesh.py` (`param_shardings`,
`batch_sharding`, `label_sharding`) and `train/trainer.py:
opt_state_shardings`: `Spmd.shard`, `Spmd.gathered` and `Spmd.local_batch`
turn each Shard(d) into the rank's slice of d. The step itself is
`train/trainer.py:make_train_step` with this rank's `Spmd`. Every
collective is an `all_reduce` (gloo reduces CUDA tensors, NCCL
everything), each wrapped in an autograd function whose backward is the
forward's adjoint:

* dp and sp share one "data" group (the ranks of one tp index). The loss's
  sums are global: the dice intersect, prediction and target sums and the
  CE sum and voxel count are all-reduced over it inside autograd before the
  ratios (batch dice), so every rank holds the reference's loss. Each rank
  back-propagates loss / (dp * sp) through those sums (whose backward
  all-reduces the gradient), and the parameters' gradients are summed over
  the group: the gradient of the global loss.
* sp: each 3x3x3 conv reads one slice of its neighbours' slabs (a halo,
  zero at the volume's ends; its gradient goes back to the neighbour), and
  instance-norm sums are all-reduced over sp. The slab must divide by
  2^(stages - 1).
* tp: a rank computes its shard of a layer's output channels, normalizes
  them, and gathers the channels. Every tp rank then computes the same
  thing, so the gather's backward keeps the local slice (summing over tp
  would multiply the shards' gradients by tp). The input gradient of a
  sharded layer comes from the rank's output shard only, so it is summed
  over tp on the way in (`_ToShards`). The global-norm clip counts each
  shard once: the sharded gradients' squares are all-reduced over tp, the
  replicated ones counted once.

The network keeps its own forward on a mesh: `Spmd.shard` turns each
`ConvBlock`'s conv and norm and each decoder stage's transposed conv into
the mesh's versions of those layers (`_MeshConv3d`, `_MeshNorm`,
`_MeshConvTranspose3d`: halo and `to_shards` on the conv, the sp-summed
statistics and the tp gather on the norm), the same parameters under the
same names; `Spmd.gathered` turns a whole copy back. Primus (and any
network that is not a 3d U-Net) trains over dp only.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from boa_tpu_torch.models.unet import InstanceNorm
from boa_tpu_torch.parallel.mesh import AXES, batch_sharding, label_sharding


def _reduced(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Sum(torch.autograd.Function):
    """all_reduce(SUM) over `group`; its adjoint is the same all_reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """Concatenate the ranks' shards along `dim` (rank order); the backward
    keeps this rank's slice of the gradient (the ranks compute alike)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, index):
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * size
        buf = x.new_zeros(shape)
        buf.narrow(dim, index * n, n).copy_(x)
        dist.all_reduce(buf, group=group)
        ctx.dim, ctx.lo, ctx.n = dim, index * n, n
        return buf

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None, None, None


class _ToShards(torch.autograd.Function):
    """Identity forward into a channel-sharded layer; the backward sums the
    ranks' input gradients, each of which comes from its own output shard."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _HaloZ(torch.autograd.Function):
    """(N, C, X, Y, Zl) -> (N, C, X, Y, Zl + 2w): `w` slices of the previous
    and the next rank's slab around this one (zeros at the volume's ends)."""

    @staticmethod
    def forward(ctx, x, w, group, size, index):
        ctx.w, ctx.group, ctx.size, ctx.index = w, group, size, index
        edge = x.shape[:-1] + (w,)
        buf = x.new_zeros((size, 2) + edge)
        buf[index, 0] = x[..., :w]
        buf[index, 1] = x[..., -w:]
        dist.all_reduce(buf, group=group)
        lo = buf[index - 1, 1] if index > 0 else x.new_zeros(edge)
        hi = buf[index + 1, 0] if index < size - 1 else x.new_zeros(edge)
        return torch.cat([lo, x, hi], dim=-1)

    @staticmethod
    def backward(ctx, g):
        w, size, index = ctx.w, ctx.size, ctx.index
        edge = g.shape[:-1] + (w,)
        buf = g.new_zeros((size, 2) + edge)
        buf[index, 0] = g[..., :w]       # the previous rank's last slices
        buf[index, 1] = g[..., -w:]      # the next rank's first slices
        dist.all_reduce(buf, group=ctx.group)
        gx = g[..., w:-w].clone()
        if index > 0:
            gx[..., :w] += buf[index - 1, 1]
        if index < size - 1:
            gx[..., -w:] += buf[index + 1, 0]
        return gx, None, None, None, None


class Spmd:
    """This rank's place on a dp x sp x tp `DeviceMesh` and its groups. A
    copy of a network keeps the one `Spmd` (`copy.deepcopy` shares it)."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        if names != AXES:
            raise ValueError(f"the train step's mesh has dims {AXES}, not {names}")
        self.mesh = mesh
        self.sizes = tuple(mesh.size(i) for i in range(3))
        self.coord = tuple(mesh.get_coordinate())
        self.dp, self.sp, self.tp = self.sizes
        self.d, self.s, self.t = self.coord
        self.sp_group = mesh.get_group("sp")
        self.tp_group = mesh.get_group("tp")
        self.n_data = self.dp * self.sp
        ranks = mesh.mesh
        self.data_group = None
        for t in range(self.tp):   # every rank creates every group, in one order
            g = dist.new_group(ranks[:, :, t].flatten().tolist())
            if t == self.t:
                self.data_group = g
        self.spatial = self.sp > 1 or self.tp > 1
        self.writer = dist.get_rank() == 0
        self.placements: dict = {}
        self.opt_placements = None

    def __deepcopy__(self, memo):
        return self

    # ---- collectives ------------------------------------------------------
    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(t, self.data_group) if self.n_data > 1 else t

    def sum_sp(self, t: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(t, self.sp_group) if self.sp > 1 else t

    def gather_tp(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(t, dim, self.tp_group, self.tp, self.t) if self.tp > 1 else t

    def to_shards(self, x: torch.Tensor) -> torch.Tensor:
        return _ToShards.apply(x, self.tp_group) if self.tp > 1 else x

    def halo(self, x: torch.Tensor, w: int) -> torch.Tensor:
        return _HaloZ.apply(x, w, self.sp_group, self.sp, self.s)

    # ---- placements -------------------------------------------------------
    def _local(self, t: torch.Tensor, placements, skip=()) -> torch.Tensor:
        """This rank's block of a whole tensor under `placements`: each mesh
        dim's Shard(d) narrowed to the rank's slice of d (not the dims in
        `skip`)."""
        for axis, pl, size, at in zip(AXES, placements, self.sizes, self.coord):
            if isinstance(pl, Shard) and axis not in skip:
                n = t.shape[pl.dim] // size
                t = t.narrow(pl.dim, at * n, n)
        return t

    @staticmethod
    def _tp_dim(placements) -> int | None:
        pl = placements[AXES.index("tp")]
        return pl.dim if isinstance(pl, Shard) else None

    def _whole(self, t: torch.Tensor, placements) -> torch.Tensor:
        dim = self._tp_dim(placements)
        return t if dim is None else self.gather_tp(t, dim)

    # ---- the batch --------------------------------------------------------
    def check(self, model, batch: int | None = None, z: int | None = None) -> None:
        """ValueError unless this mesh can run `model` (and a global batch of
        `batch` rows and `z` slices)."""
        from boa_tpu_torch.models.unet import PlainConvUNet

        if self.spatial:
            if not isinstance(model, PlainConvUNet) or model.cfg.two_d:
                raise ValueError(
                    f"sp={self.sp}, tp={self.tp}: only the 3d U-Net families shard "
                    f"space and channels; {type(model).__name__} trains over dp only")
        if batch is not None and batch % self.dp:
            raise ValueError(f"batch {batch} does not divide over dp={self.dp}")
        if z is not None and self.sp > 1:
            levels = 2 ** (model.cfg.n_stages - 1)
            if z % self.sp or (z // self.sp) % levels:
                raise ValueError(f"z extent {z} over sp={self.sp}: each slab must divide "
                                 f"by 2^(stages - 1) = {levels}")

    def local_batch(self, x: torch.Tensor, y: torch.Tensor, rows_local: bool = False):
        """This rank's part of a global (N, X, Y, Z, C) batch and its
        (N, X, Y, Z) labels under `batch_sharding` / `label_sharding`: its
        dp rows (unless `rows_local`: the batch holds them already, as
        `train/dataloader.py:DataLoader(part=...)` loads it) and its sp
        slab of z."""
        skip = ("dp",) if rows_local else ()
        return (self._local(x, batch_sharding(self.mesh), skip).contiguous(),
                self._local(y, label_sharding(self.mesh), skip).contiguous())

    # ---- parameters -------------------------------------------------------
    def shard(self, model: nn.Module, placements: dict, optimizer=None,
              make_optimizer=None, opt_placements=None):
        """Keep this rank's block of every parameter under `placements`
        (`parallel/mesh.py:param_shardings`), in place, and turn the U-Net's
        layers into their mesh versions (sp or tp > 1). With `optimizer`,
        returns `make_optimizer(model)` carrying its state, each entry
        narrowed by `opt_placements` (`train/trainer.py:
        opt_state_shardings`)."""
        names = {p: name for name, p in model.named_parameters()}
        moved = {}
        for name, p in list(model.named_parameters()):
            if self._tp_dim(placements[name]) is None:
                continue
            mod_name, _, pname = name.rpartition(".")
            new = nn.Parameter(self._local(p.detach(), placements[name]).clone())
            setattr(model.get_submodule(mod_name), pname, new)
            moved[p] = new
        self.placements, self.opt_placements = placements, opt_placements
        if self.spatial:
            self._mesh_layers(model)
        if optimizer is None:
            return None
        new_opt = make_optimizer(model)
        for old, st in optimizer.state.items():
            name = names[old]
            new_opt.state[moved.get(old, old)] = {
                k: (self._local(v, _state_placements(opt_placements, name, k)).clone()
                    if torch.is_tensor(v) else v) for k, v in st.items()}
        return new_opt

    def sharded(self, model: nn.Module) -> list[bool]:
        """For each of `model.parameters()`: whether it is a tp shard."""
        return [self._tp_dim(self.placements[name]) is not None
                for name, _ in model.named_parameters()]

    @torch.no_grad()
    def gathered(self, model: nn.Module, optimizer=None, make_optimizer=None):
        """A whole copy of a sharded network with its plain layers (every rank
        takes part), and with `optimizer` a whole optimizer from
        `make_optimizer(copy)` with its state gathered alike."""
        full = copy.deepcopy(model)
        for mod in full.modules():
            if isinstance(mod, _MeshLayer):
                mod.__class__ = mod.plain
                del mod.spmd, mod.tp_shard
        for name, p in model.named_parameters():
            if self._tp_dim(self.placements[name]) is not None:
                mod_name, _, pname = name.rpartition(".")
                setattr(full.get_submodule(mod_name), pname,
                        nn.Parameter(self._whole(p.detach(), self.placements[name])))
        if optimizer is None:
            return full, None
        new_opt = make_optimizer(full)
        for (name, p_s), p_f in zip(model.named_parameters(), full.parameters()):
            st = optimizer.state.get(p_s)
            if st:
                new_opt.state[p_f] = {
                    k: (self._whole(v, _state_placements(self.opt_placements, name, k))
                        if torch.is_tensor(v) else v) for k, v in st.items()}
        return full, new_opt

    def _mesh_layers(self, model: nn.Module) -> None:
        from boa_tpu_torch.models.unet import ConvBlock, DecoderStage

        def become(mod, cls, weight):
            mod.__class__ = cls
            mod.spmd = self
            mod.tp_shard = self._tp_dim(self.placements[weight]) is not None

        for name, mod in model.named_modules():
            if isinstance(mod, ConvBlock):
                become(mod.conv, _MeshConv3d, f"{name}.conv.weight")
                become(mod.norm, _MeshNorm, f"{name}.conv.weight")
            elif isinstance(mod, DecoderStage):
                become(mod.transp, _MeshConvTranspose3d, f"{name}.transp.weight")

    # ---- the step's collectives -------------------------------------------
    def sum_grads(self, grads: list[torch.Tensor]) -> None:
        """Sum the gradients over the data group, in place."""
        if self.n_data == 1:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        for g, f in zip(grads, torch.split(flat, [g.numel() for g in grads])):
            g.copy_(f.view_as(g))

    def clip_by_global_norm(self, grads, model: nn.Module, max_norm: float) -> torch.Tensor:
        """`train/optim.py:clip_by_global_norm` over shards: each tp shard's
        squares all-reduced over tp, each replicated gradient counted once."""
        sharded = self.sharded(model)
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        sq_sh = sum((g.float().square().sum() for g, s in zip(grads, sharded) if s), zero)
        sq_rep = sum((g.float().square().sum() for g, s in zip(grads, sharded) if not s),
                     zero)
        if self.tp > 1:
            sq_sh = _reduced(sq_sh, self.tp_group)
        norm = torch.sqrt(sq_sh + sq_rep)
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        torch._foreach_mul_(list(grads), scale)
        return norm


def _state_placements(opt_placements, name: str, key: str):
    """The placements of torch's optimizer state `key` of parameter `name`
    in `opt_placements`, the reference's optimizer tree
    (`train/trainer.py:opt_state_shardings`)."""
    from boa_tpu_torch.train.optim import STATE_TREE_KEYS

    tree_key = STATE_TREE_KEYS[key]
    if tree_key is None:     # SGD's momentum: the parameters' own tree
        return opt_placements[name]
    node = opt_placements[tree_key]
    return node if tree_key == "step" else node[name]


# ---------------------------------------------------------------------------
# the U-Net's layers on slabs and channel shards
# ---------------------------------------------------------------------------

class _MeshLayer:
    """A layer of a sharded network: `spmd` is the rank's place, `tp_shard`
    whether the layer's output channels are a tp shard, `plain` the class it
    was."""

    plain: type


class _MeshConv3d(_MeshLayer, nn.Conv3d):
    """A conv on this rank's z slab (a halo from the sp neighbours in place
    of z padding); into a channel shard its input gradient is summed over
    tp."""

    plain = nn.Conv3d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spmd = self.spmd
        if self.tp_shard:
            x = spmd.to_shards(x)
        pad = list(self.padding)
        kz = self.kernel_size[2]
        if spmd.sp > 1 and kz > 1:
            x = spmd.halo(x, (kz - 1) // 2)
            pad[2] = 0
        return F.conv3d(x, self.weight, self.bias, self.stride, tuple(pad))


class _MeshNorm(_MeshLayer, InstanceNorm):
    """Instance norm with float32 statistics over the whole volume (the
    slabs' sums all-reduced over sp), as `models/unet.py:instance_norm`; a
    channel shard is gathered after it."""

    plain = InstanceNorm

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        spmd = self.spmd
        yf = y.float()
        count = spmd.sp
        for d in self.dims:
            count *= yf.shape[d]
        mean = spmd.sum_sp(yf.sum(self.dims, keepdim=True)) / count
        var = spmd.sum_sp((yf - mean).square().sum(self.dims, keepdim=True)) / count
        out = (yf - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            out = out * self.weight.float()[None, :, None, None, None]
        if self.bias is not None:
            out = out + self.bias.float()[None, :, None, None, None]
        out = out.to(y.dtype)
        return spmd.gather_tp(out, 1) if self.tp_shard else out


class _MeshConvTranspose3d(_MeshLayer, nn.ConvTranspose3d):
    """The decoder's upsampling (kernel = stride, local to a z slab); a
    channel shard is gathered after it."""

    plain = nn.ConvTranspose3d

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        spmd = self.spmd
        if not self.tp_shard:
            return F.conv_transpose3d(x, self.weight, self.bias, self.stride)
        up = F.conv_transpose3d(spmd.to_shards(x), self.weight, self.bias, self.stride)
        return spmd.gather_tp(up, 1)
