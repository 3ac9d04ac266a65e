"""Pluggable image reader/writer registry.

Counterpart of `boa_tpu/io/imageio.py`. Parity: `nnunetv2/imageio/` (SimpleITKIO / NibabelIO / NaturalImage2DIO
selected by dataset.json `overwrite_image_reader_writer` or file ending).
Here the registry maps file endings / names to the built-in codecs:
NIfTI (.nii/.nii.gz), DICOM directories, and .npy/.npz arrays.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Protocol

import numpy as np

from boa_tpu_torch.io import nifti, npz


class ImageIO(Protocol):
    def read(self, path: Path) -> nifti.NiftiImage: ...

    def write(self, img: nifti.NiftiImage, path: Path) -> None: ...


class NiftiIO:
    endings = (".nii", ".nii.gz")

    def read(self, path: Path) -> nifti.NiftiImage:
        return nifti.load(path)

    def write(self, img: nifti.NiftiImage, path: Path) -> None:
        nifti.save(img, path)


class DicomDirIO:
    endings = ()

    def read(self, path: Path) -> nifti.NiftiImage:
        from boa_tpu_torch.io import dicom_io

        img, _files, _hdr = dicom_io.read_series(Path(path))
        return img

    def write(self, img: nifti.NiftiImage, path: Path) -> None:
        from boa_tpu_torch.io import dicom_io

        dicom_io.write_ct_series(img, Path(path))


class NpyIO:
    endings = (".npy", ".npz")

    def read(self, path: Path) -> nifti.NiftiImage:
        path = Path(path)
        if path.suffix == ".npz":
            blob = np.load(path)
            data = blob["data"]
            affine = blob["affine"] if "affine" in blob else np.eye(4)
        else:
            data = np.load(path)
            affine = np.eye(4)
        return nifti.NiftiImage(data=data, affine=np.asarray(affine))

    def write(self, img: nifti.NiftiImage, path: Path) -> None:
        path = Path(path)
        if path.suffix == ".npz":
            npz.savez_compressed(path, data=np.asarray(img.data),
                                 affine=np.asarray(img.affine))
        else:
            np.save(path, np.asarray(img.data))


_REGISTRY: dict[str, ImageIO] = {
    "NiftiIO": NiftiIO(),
    "DicomDirIO": DicomDirIO(),
    "NpyIO": NpyIO(),
}


def register_io(name: str, io: ImageIO) -> None:
    _REGISTRY[name] = io


def get_io(name: str) -> ImageIO:
    return _REGISTRY[name]


def io_for_path(path: str | Path) -> ImageIO:
    """Resolve a reader/writer by file ending (directory → DICOM)."""
    p = Path(path)
    name = p.name.lower()
    if name.endswith((".nii", ".nii.gz")):
        return _REGISTRY["NiftiIO"]
    if name.endswith((".npy", ".npz")):
        return _REGISTRY["NpyIO"]
    if p.is_dir() or "." not in name:  # directory (existing or to-create)
        return _REGISTRY["DicomDirIO"]
    raise ValueError(f"no image reader/writer for {path}")


def read_image(path: str | Path) -> nifti.NiftiImage:
    return io_for_path(path).read(Path(path))


def write_image(img: nifti.NiftiImage, path: str | Path) -> None:
    io_for_path(path).write(img, Path(path))
