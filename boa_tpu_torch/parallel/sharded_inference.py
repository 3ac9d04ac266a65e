"""Multi-device sliding-window inference over the ranks of a mesh's dp axis.

Counterpart of `boa_tpu/parallel/sharded_inference.py`
(`pad_starts_for_mesh`, `sliding_window_logits_sharded`,
`sliding_window_seg_sharded_chunked`, `sliding_window_logits_zslab`). The
tile grid is the parallel axis: the tiles are dealt to the dp ranks in turn
(tile i to rank i mod dp), each rank runs the port's tile forward
(`inference/sliding_window.py:tiles_pred`, the K1-K3 composite in bf16 on
the card) on its tiles and adds them in place into a whole volume of its
own, and one `all_reduce` over dp sums the volumes (the Gaussian weights sum
as on one device). The z-slab form shards the volume instead: each rank
runs the whole sliding window on its slab widened by a margin and keeps the
interior, with no reduction at all.

Not carried over from the reference: the 128-lane class padding of the
accumulator, the chunk-of-k unrolled in-place adds and `jax.lax.pcast`,
which were XLA devices; padding tiles (`valid` 0) are skipped rather than
added with weight 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from boa_tpu_torch.inference.sliding_window import sliding_window_logits, tiles_pred


def pad_starts_for_mesh(starts: np.ndarray, n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the (T, 3) tile starts to a multiple of `n_shards` by repeating the
    first start, with a validity flag (1 real, 0 padding) per tile."""
    t = len(starts)
    t_pad = -(-t // n_shards) * n_shards
    valid = np.ones((t_pad,), np.float32)
    if t_pad != t:
        starts = np.concatenate([starts, np.repeat(starts[:1], t_pad - t, axis=0)])
        valid[t:] = 0.0
    return starts, valid


def _dp(mesh) -> tuple[int, int, object]:
    """(dp size, this rank's dp index, the dp group)."""
    return mesh.size(mesh.mesh_dim_names.index("dp")), mesh.get_local_rank("dp"), \
        mesh.get_group("dp")


def my_tiles(starts: np.ndarray, mesh) -> np.ndarray:
    """This rank's tile starts: the padded list dealt to the dp ranks in
    turn, padding tiles dropped."""
    n_dp, r, _ = _dp(mesh)
    starts_p, valid = pad_starts_for_mesh(np.asarray(starts, np.int64), n_dp)
    return starts_p[r::n_dp][valid[r::n_dp] > 0]


@torch.no_grad()
def sliding_window_logits_sharded(models, vol: torch.Tensor, starts: np.ndarray, gaussian,
                                  num_classes: int, mesh, mirror_axes=(),
                                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Gaussian-weight-normalized fused logits (classes, X, Y, Z) float32 on
    every rank, the tiles computed across the mesh's dp axis. `vol` (C, X,
    Y, Z) normalized and padded to at least the patch, on this rank's
    device."""
    _, _, group = _dp(mesh)
    spatial = tuple(vol.shape[-3:])
    px, py, pz = gaussian.shape
    g = torch.as_tensor(gaussian, dtype=torch.float32, device=vol.device)
    logits = torch.zeros(spatial + (num_classes,), dtype=torch.float32, device=vol.device)
    weights = torch.zeros(spatial, dtype=torch.float32, device=vol.device)
    for sx, sy, sz in my_tiles(starts, mesh):
        pred = tiles_pred(models, vol, [(sx, sy, sz)], g[..., None], compute_dtype,
                          (px, py, pz), mirror_axes)[0]
        win = (slice(sx, sx + px), slice(sy, sy + py), slice(sz, sz + pz))
        logits[win] += pred
        weights[win] += g
    dist.all_reduce(logits, group=group)
    dist.all_reduce(weights, group=group)
    return (logits / torch.clamp(weights, min=1e-8)[..., None]).permute(3, 0, 1, 2)


@torch.no_grad()
def sliding_window_seg_sharded_chunked(models, vol: torch.Tensor, starts: np.ndarray,
                                       gaussian, num_classes: int, mesh, mirror_axes=(),
                                       compute_dtype=torch.bfloat16,
                                       accum_dtype=torch.float32,
                                       seg_dtype=torch.uint8) -> torch.Tensor:
    """Fused argmax labels (X, Y, Z) on every rank, the tiles computed across
    the mesh's dp axis: each rank adds its Gaussian-weighted tiles into its
    own (X, Y, Z, classes) `accum_dtype` volume, then the volumes are summed
    in float32 over dp and argmaxed an x-slab at a time (the weight
    normalization is left out: it does not move the argmax)."""
    _, _, group = _dp(mesh)
    spatial = tuple(vol.shape[-3:])
    px, py, pz = gaussian.shape
    g = torch.as_tensor(gaussian, dtype=torch.float32, device=vol.device)[..., None]
    buf = torch.zeros(spatial + (num_classes,), dtype=accum_dtype, device=vol.device)
    for sx, sy, sz in my_tiles(starts, mesh):
        p = tiles_pred(models, vol, [(sx, sy, sz)], g, compute_dtype, (px, py, pz),
                       mirror_axes)[0]
        buf[sx:sx + px, sy:sy + py, sz:sz + pz].add_(p.to(accum_dtype))
    seg = torch.empty(spatial, dtype=seg_dtype, device=vol.device)
    for x0 in range(0, spatial[0], 16):
        part = buf[x0:x0 + 16].float().contiguous()
        dist.all_reduce(part, group=group)
        seg[x0:x0 + 16] = torch.argmax(part, dim=-1).to(seg_dtype)
    return seg


@torch.no_grad()
def sliding_window_logits_zslab(models, vol: torch.Tensor, gaussian, num_classes: int, mesh,
                                tile_step_size: float = 0.5, margin: int | None = None,
                                mirror_axes=(), compute_dtype=torch.bfloat16) -> torch.Tensor:
    """This rank's z-slab of the fused logits, (classes, X, Y, Zr) float32
    for z in [r * slab, r * slab + Zr), slab = ceil(Z / dp): the volume split
    into dp slabs, each widened by `margin` slices (default pz // 2) from
    the whole volume, run through the whole sliding window, and cropped
    back to its interior, as the reference's z triple split (20-slice
    margins, `totalsegmentator/nnunet.py:483-505`). No collective: only the
    slab's logits are ever held."""
    from boa_tpu_torch.ops import preprocess as pp

    n_dp, r, _ = _dp(mesh)
    Z = vol.shape[-1]
    px, py, pz = gaussian.shape
    if margin is None:
        margin = pz // 2
    slab = -(-Z // n_dp)
    zp = slab * n_dp
    volp = F.pad(vol, (0, zp - Z))
    ext = max(min(slab + 2 * margin, zp), pz)
    lo = int(np.clip(r * slab - margin, 0, zp - ext))
    starts = pp.tile_starts((vol.shape[1], vol.shape[2], ext), (px, py, pz), tile_step_size)
    fused = sliding_window_logits(models, volp[..., lo:lo + ext].contiguous(), starts, gaussian,
                                  num_classes, mirror_axes=mirror_axes,
                                  compute_dtype=compute_dtype, accum_dtype=torch.float32)
    inner = r * slab - lo
    keep = max(0, min(slab, Z - r * slab))
    return fused[..., inner:inner + keep]
