"""Cropping with affine bookkeeping.

Counterpart of `boa_tpu/ops/cropping.py`. The in-plane body crop
(`BodyCrop`, `body_crop_xy`, `pad_back`): a CT is cropped to the in-plane
bounding box of voxels above an HU threshold before upload (the card pays
for every air voxel), and the result is zero-padded back to the input grid.
The mask crop of a crop-cascade task (`get_bbox_from_mask`, `crop_to_mask`,
`undo_crop`; TotalSegmentator `cropping.py`): crop to the bounding box of an
organ mask plus an addon in mm, and zero-fill back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from boa_tpu_torch.io.nifti import NiftiImage


@dataclass(frozen=True)
class BodyCrop:
    """In-plane crop bookkeeping: pad-back target for saved volumes."""

    orig_shape: tuple[int, int, int]
    orig_affine: np.ndarray
    x0: int
    x1: int
    y0: int
    y1: int


def body_crop_xy(img: NiftiImage, threshold: float = -500.0,
                 margin_mm: float = 16.0, stride: int = 4,
                 min_saving: float = 0.10
                 ) -> tuple[NiftiImage, BodyCrop | None]:
    """Crop a CT to the in-plane bounding box of voxels above `threshold`,
    found on a stride-subsampled view, widened by `margin_mm` plus the
    stride slack and bucketed to multiples of 64 voxels. z is never cropped.
    Returns `(img, None)` when the crop would save less than `min_saving`
    of the in-plane area."""
    data = np.asarray(img.data)
    if data.ndim != 3:
        return img, None
    sx, sy, _ = data.shape
    fg = data[::stride, ::stride, ::stride] > threshold
    px = fg.any(axis=(1, 2))
    py = fg.any(axis=(0, 2))
    if not bool(px.any()):
        return img, None
    zooms = img.zooms
    nzx = np.flatnonzero(px)
    nzy = np.flatnonzero(py)
    mx = int(np.ceil(margin_mm / max(zooms[0], 1e-3))) + stride
    my = int(np.ceil(margin_mm / max(zooms[1], 1e-3))) + stride
    x0 = max(0, int(nzx[0]) * stride - mx)
    x1 = min(sx, (int(nzx[-1]) + 1) * stride + mx)
    y0 = max(0, int(nzy[0]) * stride - my)
    y1 = min(sy, (int(nzy[-1]) + 1) * stride + my)

    def _bucket(lo: int, hi: int, n: int) -> tuple[int, int]:
        lo = (lo // 8) * 8
        w = min(n, ((hi - lo + 63) // 64) * 64)
        hi = min(n, lo + w)
        return max(0, hi - w), hi

    x0, x1 = _bucket(x0, x1, sx)
    y0, y1 = _bucket(y0, y1, sy)
    if (x1 - x0) * (y1 - y0) > (1.0 - min_saving) * sx * sy:
        return img, None
    info = BodyCrop(orig_shape=tuple(data.shape),
                    orig_affine=np.array(img.affine, dtype=np.float64, copy=True),
                    x0=x0, x1=x1, y0=y0, y1=y1)
    affine = np.copy(img.affine)
    affine[:3, 3] = (affine @ np.array([x0, y0, 0.0, 1.0]))[:3]
    return NiftiImage(data=data[x0:x1, y0:y1], affine=affine,
                      crop_info=info), info


def pad_back(data: np.ndarray, info: BodyCrop) -> np.ndarray:
    """Zero-fill cropped voxels back into the original in-plane grid."""
    full = np.zeros(info.orig_shape[:2] + data.shape[2:], dtype=data.dtype)
    full[info.x0:info.x1, info.y0:info.y1] = data
    return full


def get_bbox_from_mask(mask: np.ndarray, outside_value: float = 0,
                       addon=(0, 0, 0)) -> list[list[int]]:
    """[[x0, x1], [y0, y1], [z0, z1]] of the voxels above `outside_value`,
    widened by `addon` voxels per axis and clipped to the volume; the full
    extent for an empty mask."""
    if isinstance(addon, int):
        addon = [addon] * 3
    fg = mask > outside_value
    projs = [fg.any(axis=(1, 2)), fg.any(axis=(0, 2)), fg.any(axis=(0, 1))]
    if not projs[0].any():
        return [[0, n] for n in mask.shape[:3]]
    bbox = []
    for ax, p in enumerate(projs):
        nz = np.flatnonzero(p)
        bbox.append([max(0, int(nz[0]) - int(addon[ax])),
                     min(mask.shape[ax], int(nz[-1]) + 1 + int(addon[ax]))])
    return bbox


def crop_to_bbox(data: np.ndarray, bbox) -> np.ndarray:
    return data[bbox[0][0]:bbox[0][1], bbox[1][0]:bbox[1][1], bbox[2][0]:bbox[2][1]]


def crop_img_to_bbox(img: NiftiImage, bbox, dtype=None) -> NiftiImage:
    """Crop and shift the affine origin to the bbox corner."""
    data = crop_to_bbox(np.asarray(img.data), bbox)
    affine = np.copy(img.affine)
    affine[:3, 3] = (affine @ np.array([bbox[0][0], bbox[1][0], bbox[2][0], 1.0]))[:3]
    if dtype is not None:
        data = data.astype(dtype)
    return NiftiImage(data=np.ascontiguousarray(data), affine=affine)


def crop_to_mask(img: NiftiImage, mask_img: NiftiImage, addon_mm=(0, 0, 0),
                 dtype=None) -> tuple[NiftiImage, list[list[int]]]:
    """Crop `img` to the bbox of `mask_img`, widened by `addon_mm` per axis
    (converted to whole voxels)."""
    addon_vox = (np.array(addon_mm) / np.array(img.zooms)).astype(int)
    bbox = get_bbox_from_mask(np.asarray(mask_img.data), outside_value=0,
                              addon=addon_vox)
    return crop_img_to_bbox(img, bbox, dtype), bbox


def undo_crop(img: NiftiImage, ref_img: NiftiImage, bbox) -> NiftiImage:
    """Zero-fill `img` back into the full extent of `ref_img`."""
    out = np.zeros(ref_img.shape, dtype=np.asarray(img.data).dtype)
    out[bbox[0][0]:bbox[0][1], bbox[1][0]:bbox[1][1], bbox[2][0]:bbox[2][1]] = img.data
    return NiftiImage(data=out, affine=ref_img.affine.copy(),
                      crop_info=getattr(ref_img, "crop_info", None))
