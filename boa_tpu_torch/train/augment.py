"""Training augmentation on the device, each transform a draw and an apply.

Counterpart of `boa_tpu/train/augment.py` (nnU-Net's batchgeneratorsv2
stack, `nnUNetTrainer.get_training_transforms`, `nnUNetTrainer.py:695-845`):
spatial (rotation p 0.2 up to 30°, scaling p 0.2 in 0.7-1.4; data
trilinear, labels nearest), Gaussian noise p 0.1, Gaussian blur p 0.2,
brightness p 0.15, contrast p 0.15, simulated low resolution p 0.25,
gamma (inverted p 0.1, plain p 0.3), mirroring; the DA5 preset; the
cascade stack with the previous stage one-hot and its binary dilate/erode
noise.

Randomness comes from an explicit `torch.Generator` on the batch's device.
The JAX PRNG draws other numbers, so each transform is split into
`draw_*` (its random parameters, per sample) and `*_apply` (the
deterministic function of those parameters), and the applies are held to
the reference at the same parameters. Per-sample probabilities blend with
`torch.where`, as the reference's `_blend`; nothing reads a drawn value
back to the host. The resamplers gather with clamped indices, as the
reference's `_sample_trilinear` / `_sample_nearest` do.
Tensors: x (N, X, Y, Z, C) float32, y (N, X, Y, Z) int.

`part=(i, k)` says the batch is the i-th of k equal parts of a larger one
(a dp rank's rows, `train/dataloader.py:DataLoader(part=...)`): every draw
is made for the whole batch and the part's rows of it applied, so the
parts put together are the whole batch's augmentation.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _rows(x: torch.Tensor, part) -> tuple[int, slice]:
    """(the whole batch's rows, `x`'s slice of them) for `part` = (i, k),
    or `x`'s own rows for None."""
    if part is None:
        return x.shape[0], slice(None)
    i, k = part
    n = x.shape[0]
    return n * k, slice(i * n, (i + 1) * n)


def _mine(prm: dict, rows: slice) -> dict:
    return {k: v[rows] for k, v in prm.items()}


def _blend(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


# ---------------------------------------------------------------- spatial
def _rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    ax, ay, az = angles[0], angles[1], angles[2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cx, -sx]),
                      torch.stack([zero, sx, cx])])
    ry = torch.stack([torch.stack([cy, zero, sy]), torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rz = torch.stack([torch.stack([cz, -sz, zero]), torch.stack([sz, cz, zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def _affine_coords(shape, mat: torch.Tensor) -> torch.Tensor:
    """(3, X, Y, Z) source coordinates of an affine about the centre."""
    center = torch.tensor([(s - 1) / 2.0 for s in shape], dtype=torch.float32,
                          device=mat.device)
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=mat.device)
                             for s in shape], indexing="ij")
    pts = torch.stack([g - c for g, c in zip(grids, center)])
    src = torch.einsum("ij,jxyz->ixyz", mat.float(), pts)
    return src + center[:, None, None, None]


def _sample_trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """vol (X, Y, Z[, C]), coords (3, X, Y, Z) -> vol at the coordinates,
    neighbours clamped to the volume."""
    shape = vol.shape[:3]
    c0 = torch.floor(coords)
    frac = coords - c0
    c0 = c0.long()
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = torch.clamp(c0[0] + dx, 0, shape[0] - 1)
                iy = torch.clamp(c0[1] + dy, 0, shape[1] - 1)
                iz = torch.clamp(c0[2] + dz, 0, shape[2] - 1)
                w = ((frac[0] if dx else 1 - frac[0])
                     * (frac[1] if dy else 1 - frac[1])
                     * (frac[2] if dz else 1 - frac[2]))
                v = vol[ix, iy, iz]
                term = (w[..., None] if vol.dim() == 4 else w) * v
                out = term if out is None else out + term
    return out


def _sample_nearest(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    shape = vol.shape[:3]
    c0 = torch.round(coords).long()
    return vol[torch.clamp(c0[0], 0, shape[0] - 1), torch.clamp(c0[1], 0, shape[1] - 1),
               torch.clamp(c0[2], 0, shape[2] - 1)]


def draw_spatial(gen, n: int, p_rotation: float = 0.2, p_scaling: float = 0.2,
                 rot_max: float = 0.5235987755982988,
                 scale_range: tuple[float, float] = (0.7, 1.4),
                 in_plane_only: bool = False) -> dict:
    """Per sample: angles (n, 3), zero unless rotated; scale (n,), one unless
    scaled; identity (n,) where neither applies."""
    do_rot = _uniform(gen, (n,)) < p_rotation
    do_scale = _uniform(gen, (n,)) < p_scaling
    angles = torch.where(do_rot[:, None], _uniform(gen, (n, 3), -rot_max, rot_max),
                         torch.zeros((), device=gen.device))
    if in_plane_only:
        angles = angles * torch.tensor([0.0, 0.0, 1.0], device=gen.device)
    scale = torch.where(do_scale, _uniform(gen, (n,), *scale_range),
                        torch.ones((), device=gen.device))
    return {"angles": angles, "scale": scale, "identity": ~(do_rot | do_scale)}


def spatial_apply(x: torch.Tensor, y: torch.Tensor, angles: torch.Tensor,
                  scale: torch.Tensor, identity: torch.Tensor):
    """Rotate and scale each sample about its centre: x trilinear, y (which
    may carry trailing seg channels, (N, X, Y, Z, S)) nearest."""
    xs, ys = [], []
    for i in range(x.shape[0]):
        mat = _rotation_matrix(angles[i]) * scale[i]
        coords = _affine_coords(y.shape[1:4], mat)
        xo = _sample_trilinear(x[i], coords)
        yo = _sample_nearest(y[i], coords)
        xs.append(torch.where(identity[i], x[i], xo))
        ys.append(torch.where(identity[i], y[i], yo))
    return torch.stack(xs), torch.stack(ys)


def spatial_transform(gen, x, y, p_rotation: float = 0.2, p_scaling: float = 0.2,
                      rot_max: float = 0.5235987755982988,
                      scale_range: tuple[float, float] = (0.7, 1.4), part=None):
    """Singleton-z patches (the 2d configuration) rotate in-plane only."""
    n, rows = _rows(x, part)
    prm = draw_spatial(gen, n, p_rotation, p_scaling, rot_max, scale_range,
                       in_plane_only=x.shape[3] == 1)
    return spatial_apply(x, y, **_mine(prm, rows))


# ---------------------------------------------------------------- intensity
def draw_noise(gen, x_shape, p: float = 0.1, max_var: float = 0.1) -> dict:
    n = x_shape[0]
    return {"mask": _uniform(gen, (n,)) < p, "var": _uniform(gen, (n,), 0.0, max_var),
            "noise": torch.randn(x_shape, generator=gen, device=gen.device)}


def noise_apply(x, mask, var, noise):
    return _blend(mask, x + noise * torch.sqrt(var).reshape(-1, 1, 1, 1, 1), x)


def gaussian_noise(gen, x, p: float = 0.1, max_var: float = 0.1, part=None):
    n, rows = _rows(x, part)
    return noise_apply(x, **_mine(draw_noise(gen, (n, *x.shape[1:]), p, max_var), rows))


def _gauss_kernel1d(sigma: torch.Tensor, radius: int = 3) -> torch.Tensor:
    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (t / torch.clamp(sigma, min=1e-3)) ** 2)
    return k / k.sum()


def blur_radius(x_shape, sigma_range: tuple[float, float]) -> int:
    """scipy's 4·sigma truncation for the largest sigma, kept smaller than
    the patch on every axis."""
    radius = max(3, int(-(-4.0 * sigma_range[1] // 1)))
    return min(radius, (min(x_shape[1:4]) - 1) // 2)


def draw_blur(gen, n: int, p: float = 0.2,
              sigma_range: tuple[float, float] = (0.5, 1.0)) -> dict:
    return {"mask": _uniform(gen, (n,)) < p, "sigma": _uniform(gen, (n,), *sigma_range)}


def blur_apply(x, mask, sigma, radius: int):
    """Separable Gaussian per sample, zero outside the patch ('same' mode)."""
    n, X, Y, Z, C = x.shape
    k = torch.stack([_gauss_kernel1d(sigma[i], radius) for i in range(n)])  # (n, K)
    w = k.repeat_interleave(C, dim=0)                                      # (n*C, K)
    v = x.permute(0, 4, 1, 2, 3).reshape(1, n * C, X, Y, Z)
    for ax in range(3):
        shape = [n * C, 1, 1, 1, 1]
        shape[2 + ax] = w.shape[1]
        pad = [0, 0, 0]
        pad[ax] = radius
        v = F.conv3d(v, w.reshape(shape), padding=tuple(pad), groups=n * C)
    blurred = v.reshape(n, C, X, Y, Z).permute(0, 2, 3, 4, 1)
    return _blend(mask, blurred, x)


def gaussian_blur(gen, x, p: float = 0.2, sigma_range: tuple[float, float] = (0.5, 1.0),
                  part=None):
    n, rows = _rows(x, part)
    return blur_apply(x, **_mine(draw_blur(gen, n, p, sigma_range), rows),
                      radius=blur_radius(x.shape, sigma_range))


def draw_factor(gen, n: int, p: float, rng: tuple[float, float]) -> dict:
    """A blend mask and one factor per sample (brightness, contrast, gamma)."""
    return {"mask": _uniform(gen, (n,)) < p,
            "factor": _uniform(gen, (n,), *rng).reshape(n, 1, 1, 1, 1)}


def brightness_apply(x, mask, factor):
    return _blend(mask, x * factor, x)


def brightness(gen, x, p: float = 0.15, rng: tuple[float, float] = (0.75, 1.25),
               part=None):
    n, rows = _rows(x, part)
    return brightness_apply(x, **_mine(draw_factor(gen, n, p, rng), rows))


def contrast_apply(x, mask, factor):
    """Range-preserving contrast (batchgenerators ContrastTransform)."""
    axes = (1, 2, 3)
    mean = x.mean(axes, keepdim=True)
    mn = x.amin(axes, keepdim=True)
    mx = x.amax(axes, keepdim=True)
    out = torch.minimum(torch.maximum((x - mean) * factor + mean, mn), mx)
    return _blend(mask, out, x)


def contrast(gen, x, p: float = 0.15, rng: tuple[float, float] = (0.75, 1.25), part=None):
    n, rows = _rows(x, part)
    return contrast_apply(x, **_mine(draw_factor(gen, n, p, rng), rows))


def _nearest_idx(m: int, n: int) -> np.ndarray:
    """`jax.image.resize`'s nearest: floor((i + 0.5)·m/n) in float32."""
    off = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m) / np.float32(n)
    return np.floor(off.astype(np.float32)).astype(np.int64)


@lru_cache(maxsize=64)
def _cubic_weights(m: int, n: int) -> np.ndarray:
    """`jax.image.resize(..., "cubic")`'s (m, n) weight matrix for one axis:
    Keys' cubic (a = -0.5) at the sample positions, normalized over the
    inputs it reaches, zero for positions outside the input."""
    f32 = np.float32
    scale = n / m
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))    # antialias only when shrinking
    sample_f = ((np.arange(n, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
         ).astype(f32)
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    w = np.where(x >= 2.0, f32(0.0), out).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_nearest(v: torch.Tensor, shape) -> torch.Tensor:
    """v (X, Y, Z, C) -> (shape..., C), `jax.image.resize` nearest."""
    for ax, n in enumerate(shape):
        if v.shape[ax] != n:
            v = torch.index_select(v, ax, torch.from_numpy(
                _nearest_idx(v.shape[ax], n)).to(v.device))
    return v


def _resize_cubic(v: torch.Tensor, shape) -> torch.Tensor:
    """v (X, Y, Z, C) -> (shape..., C), `jax.image.resize` cubic."""
    eq = ("xyzc,xa->ayzc", "xyzc,yb->xbzc", "xyzc,zd->xydc")
    for ax, n in enumerate(shape):
        if v.shape[ax] != n:
            w = torch.from_numpy(_cubic_weights(v.shape[ax], n)).to(v.device)
            v = torch.einsum(eq[ax], v, w)
    return v


def lowres_levels(zoom_range: tuple[float, float], n_levels: int) -> list[float]:
    """The zoom factors, quantized to `n_levels` below the upper end (the
    identity at the upper end has measure zero in the reference's draw)."""
    lo, hi = zoom_range
    return [lo + (hi - lo) * i / n_levels for i in range(n_levels)]


def draw_lowres(gen, n: int, p: float = 0.25, n_levels: int = 4) -> dict:
    return {"mask": _uniform(gen, (n,)) < p,
            "level": torch.randint(0, n_levels, (n,), generator=gen, device=gen.device)}


def lowres_apply(x, mask, level, zoom_range: tuple[float, float] = (0.5, 1.0),
                 n_levels: int = 4):
    """Nearest down, cubic up, at each sample's level. Every level is
    computed for the batch and the sample's own picked on the device."""
    spatial = x.shape[1:4]
    out = x
    for li, z in enumerate(lowres_levels(zoom_range, n_levels)):
        if z >= 0.999:
            continue
        small = tuple(max(1, int(round(s * z))) for s in spatial)
        lv = torch.stack([_resize_cubic(_resize_nearest(xi, small), spatial) for xi in x])
        out = _blend(level == li, lv, out)
    return _blend(mask, out, x)


def simulate_low_resolution(gen, x, p: float = 0.25,
                            zoom_range: tuple[float, float] = (0.5, 1.0),
                            n_levels: int = 4, part=None):
    n, rows = _rows(x, part)
    return lowres_apply(x, **_mine(draw_lowres(gen, n, p, n_levels), rows),
                        zoom_range=zoom_range, n_levels=n_levels)


def gamma_apply(x, mask, factor, invert: bool = False):
    """GammaTransform with retain_stats (nnU-Net's default)."""
    axes = (1, 2, 3)
    xin = -x if invert else x
    mn = xin.amin(axes, keepdim=True)
    span = torch.clamp(xin.amax(axes, keepdim=True) - mn, min=1e-7)
    mean = xin.mean(axes, keepdim=True)
    std = xin.std(axes, correction=0, keepdim=True)
    out = torch.pow((xin - mn) / span, factor) * span + mn
    out = (out - out.mean(axes, keepdim=True)) / torch.clamp(
        out.std(axes, correction=0, keepdim=True), min=1e-7) * std + mean
    out = -out if invert else out
    return _blend(mask, out, x)


def gamma(gen, x, p: float = 0.3, rng: tuple[float, float] = (0.7, 1.5),
          invert: bool = False, part=None):
    n, rows = _rows(x, part)
    return gamma_apply(x, **_mine(draw_factor(gen, n, p, rng), rows), invert=invert)


def draw_mirror(gen, n: int, n_axes: int, p: float = 0.5) -> torch.Tensor:
    """(n, n_axes) flip flags."""
    return _uniform(gen, (n, n_axes)) < p


def mirror_apply(x, y, flips: torch.Tensor, axes: tuple[int, ...]):
    xs, ys = [], []
    for i in range(x.shape[0]):
        xi, yi = x[i], y[i]
        for j, ax in enumerate(axes):
            xi = torch.where(flips[i, j], torch.flip(xi, (ax,)), xi)
            yi = torch.where(flips[i, j], torch.flip(yi, (ax,)), yi)
        xs.append(xi)
        ys.append(yi)
    return torch.stack(xs), torch.stack(ys)


def mirror(gen, x, y, axes: tuple[int, ...] = (0, 1, 2), p: float = 0.5, part=None):
    """Per-sample, per-axis flips."""
    n, rows = _rows(x, part)
    return mirror_apply(x, y, draw_mirror(gen, n, len(axes), p)[rows], axes)


# ---------------------------------------------------------------- pipelines
def _intensity(gen, x, *, noise=(0.1, 0.1), blur=(0.2, (0.5, 1.0)),
               bright=(0.15, (0.75, 1.25)), contr=(0.15, (0.75, 1.25)),
               lowres=(0.25, (0.5, 1.0)), gamma_inv=(0.1, (0.7, 1.5)),
               gamma_plain=(0.3, (0.7, 1.5)), part=None):
    x = gaussian_noise(gen, x, *noise, part=part)
    x = gaussian_blur(gen, x, *blur, part=part)
    x = brightness(gen, x, *bright, part=part)
    x = contrast(gen, x, *contr, part=part)
    x = simulate_low_resolution(gen, x, *lowres, part=part)
    x = gamma(gen, x, *gamma_inv, invert=True, part=part)
    return gamma(gen, x, *gamma_plain, invert=False, part=part)


@torch.no_grad()
def augment_batch(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                  mirror_axes: tuple[int, ...] = (), part=None):
    """nnU-Net's training transform stack. x (N, X, Y, Z, C) float32
    normalized, y (N, X, Y, Z) int -> (x', y' int32)."""
    x, y = spatial_transform(gen, x, y, part=part)
    x = _intensity(gen, x, part=part)
    if mirror_axes:
        x, y = mirror(gen, x, y, axes=mirror_axes, part=part)
    return x, y.to(torch.int32)


@torch.no_grad()
def augment_batch_da5(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                      mirror_axes: tuple[int, ...] = (0, 1, 2), part=None):
    """The DA5 preset (`variants/data_augmentation/nnUNetTrainerDA5.py`):
    wider rotations and scales, higher probabilities."""
    x, y = spatial_transform(gen, x, y, p_rotation=0.6, p_scaling=0.6,
                             rot_max=0.9599310885968813, scale_range=(0.6, 1.6), part=part)
    x = _intensity(gen, x, noise=(0.3, 0.15), blur=(0.3, (0.3, 1.5)),
                   bright=(0.3, (0.65, 1.35)), contr=(0.3, (0.65, 1.35)),
                   lowres=(0.4, (0.4, 1.0)), gamma_inv=(0.15, (0.6, 1.6)),
                   gamma_plain=(0.4, (0.6, 1.6)), part=part)
    if mirror_axes:
        x, y = mirror(gen, x, y, axes=mirror_axes, part=part)
    return x, y.to(torch.int32)


def draw_binary_noise(gen, n_f: int, p: float = 0.4, max_radius: int = 8) -> dict:
    return {"apply": _uniform(gen, (n_f,)) < p, "dilate": _uniform(gen, (n_f,)) < 0.5,
            "radius": torch.randint(1, max_radius + 1, (n_f,), generator=gen,
                                    device=gen.device)}


def binary_noise_apply(onehot: torch.Tensor, apply, dilate, radius,
                       max_radius: int = 8) -> torch.Tensor:
    """Per-channel binary dilation or erosion of ONE sample's one-hot
    (X, Y, Z, F): radius r runs r steps of the 3-cube op, outside the patch
    background (scipy's border_value=0)."""
    v = onehot.permute(3, 0, 1, 2)[None]                 # (1, F, X, Y, Z)
    act = apply[None, :, None, None, None]
    dil = dilate[None, :, None, None, None]
    rad = radius[None, :, None, None, None]

    def pool(t, sign):
        return sign * F.max_pool3d(F.pad(sign * t, (1, 1, 1, 1, 1, 1)), 3, stride=1)

    for i in range(max_radius):
        stepped = torch.where(dil, pool(v, 1.0), pool(v, -1.0))
        v = torch.where((i < rad) & act, stepped, v)
    return v[0].permute(1, 2, 3, 0)


@torch.no_grad()
def augment_batch_cascade(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor,
                          prev: torch.Tensor, fg_labels: tuple[int, ...],
                          mirror_axes: tuple[int, ...] = (), part=None):
    """Cascade transforms (`nnUNetTrainer.py:802-829`): the default stack,
    the previous stage's labels warped by the same spatial transform
    (nearest), one-hot over `fg_labels`, binary dilate/erode noise p 0.4
    per channel, mirroring of data, one-hot and labels together. The random
    component dropout runs on the host patch (`dataloader.py`). Returns x
    with C + len(fg_labels) channels."""
    segs = torch.stack([y, prev], dim=-1)
    x, segs = spatial_transform(gen, x, segs, part=part)
    y, prev = segs[..., 0], segs[..., 1]
    x = _intensity(gen, x, part=part)
    onehot = torch.stack([(prev == lb) for lb in fg_labels], dim=-1).to(x.dtype)
    n, rows = _rows(x, part)
    draws = [draw_binary_noise(gen, len(fg_labels)) for _ in range(n)][rows]
    onehot = torch.stack([binary_noise_apply(o, **d) for o, d in zip(onehot, draws)])
    x = torch.cat([x, onehot], dim=-1)
    if mirror_axes:
        x, y = mirror(gen, x, y, axes=mirror_axes, part=part)
    return x, y.to(torch.int32)
