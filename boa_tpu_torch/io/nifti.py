"""NIfTI image record and orientation math.

Counterpart of the part of `boa_tpu/io/nifti.py` that `predict_image`
needs: the in-memory `NiftiImage` (data indexed [x, y, z], affine mapping
voxel indices to RAS+ mm), nibabel-style orientation on the host and the
same reorientation as tensor flips/permutes on the device. The file codec
is not ported yet: callers hand in arrays.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class NiftiImage:
    """In-memory NIfTI image: data array + RAS affine + optional extras."""

    data: np.ndarray
    affine: np.ndarray
    extensions: list[tuple[int, bytes]] = field(default_factory=list)
    # set when this image lives on a body-cropped grid (ops/cropping.BodyCrop)
    crop_info: object | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def zooms(self) -> tuple[float, ...]:
        return tuple(float(np.linalg.norm(self.affine[:3, i])) for i in range(3))

    def device_data(self, device: torch.device) -> torch.Tensor:
        """The voxel array on `device`, uploaded at most once per image.

        The cache is keyed on the identity of `data`: replace `img.data`
        rather than mutating it in place."""
        cached = getattr(self, "_device_data", None)
        if cached is None or cached[0] is not self.data or cached[1] != device:
            from boa_tpu_torch.ops import packing

            cached = (self.data, device, packing.upload_ct(self.data, device))
            object.__setattr__(self, "_device_data", cached)
        return cached[2]

    def set_label_map(self, label_map: dict[int, str]) -> None:
        payload = json.dumps({str(k): v for k, v in label_map.items()}).encode()
        self.extensions = [e for e in self.extensions if e[0] != 44]
        self.extensions.append((44, payload))

    def get_label_map(self) -> dict[int, str] | None:
        for ecode, payload in self.extensions:
            if ecode == 44:
                try:
                    raw = json.loads(payload.decode().rstrip("\x00"))
                    return {int(k): v for k, v in raw.items()}
                except (ValueError, UnicodeDecodeError):
                    return None
        return None


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """For each input axis, (RAS output axis, +1/-1 direction)."""
    rzs = affine[:3, :3].copy()
    lengths = np.sqrt((rzs ** 2).sum(axis=0))
    lengths[lengths == 0] = 1
    rzs /= lengths[None, :]
    ornt = np.zeros((3, 2))
    mat = rzs.copy()
    for _ in range(3):
        out_ax, in_ax = np.unravel_index(np.argmax(np.abs(mat)), mat.shape)
        ornt[in_ax, 0] = out_ax
        ornt[in_ax, 1] = 1.0 if mat[out_ax, in_ax] > 0 else -1.0
        mat[out_ax, :] = 0
        mat[:, in_ax] = 0
    return ornt


def apply_orientation(data: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    """Flip and reorder the first 3 axes of `data` according to `ornt`."""
    out = data
    for ax in range(3):
        if ornt[ax, 1] < 0:
            out = np.flip(out, axis=ax)
    perm = np.argsort(ornt[:, 0]).tolist() + list(range(3, data.ndim))
    return np.transpose(out, perm)


def apply_orientation_device(data: torch.Tensor, ornt: np.ndarray) -> torch.Tensor:
    """`apply_orientation` as tensor ops on the tensor's device."""
    out = data
    flips = [ax for ax in range(3) if ornt[ax, 1] < 0]
    if flips:
        out = torch.flip(out, dims=flips)
    perm = np.argsort(ornt[:, 0]).tolist() + list(range(3, data.dim()))
    if perm != list(range(data.dim())):
        out = out.permute(*perm)
    return out.contiguous()


def inv_orientation(ornt: np.ndarray) -> np.ndarray:
    inv = np.zeros_like(ornt)
    for i in range(3):
        out_ax = int(ornt[i, 0])
        inv[out_ax, 0] = i
        inv[out_ax, 1] = ornt[i, 1]
    return inv


def orientation_affine(ornt: np.ndarray, shape) -> np.ndarray:
    """Affine mapping array indices after reorientation to indices before."""
    undo_flip = np.eye(4)
    for ax in range(3):
        if ornt[ax, 1] < 0:
            undo_flip[ax, ax] = -1
            undo_flip[ax, 3] = shape[ax] - 1
    perm = np.argsort(ornt[:, 0])
    perm_aff = np.zeros((4, 4))
    perm_aff[3, 3] = 1
    for out_ax, in_ax in enumerate(perm):
        perm_aff[in_ax, out_ax] = 1
    return undo_flip @ perm_aff


def canonical_geometry(img: NiftiImage):
    """(ornt, canonical affine, canonical shape, canonical zooms), from the
    affine alone."""
    ornt = io_orientation(img.affine)
    new_affine = img.affine @ orientation_affine(ornt, img.shape)
    perm = np.argsort(ornt[:, 0])
    shape = tuple(int(np.asarray(img.shape)[p]) for p in perm)
    zooms = tuple(float(np.sqrt((new_affine[:3, i] ** 2).sum())) for i in range(3))
    return ornt, new_affine, shape, zooms
