"""DICOM RTSTRUCT export: segmentation masks -> contour sequences.

Counterpart of `boa_tpu/io/rtstruct.py` (TotalSegmentator's RTSTRUCT output
through rt_utils): per label and slice, the planar outer and hole contours
of the mask, mapped to patient coordinates through the series geometry.
The contours come from the port's own tracer
(`compute/geometry.py:find_contours`, Suzuki-Abe border following with
OpenCV's `RETR_CCOMP` / `CHAIN_APPROX_SIMPLE` output) in place of
`cv2.findContours`; the RT tags are in io/dicom.py's dictionary.
"""

from __future__ import annotations

import logging
import time
from datetime import datetime
from typing import Sequence

import numpy as np

from boa_tpu_torch.compute.geometry import find_contours
from boa_tpu_torch.io import dicom
from boa_tpu_torch.io.dicom import Dataset, generate_uid
from boa_tpu_torch.io.dicom_seg import slice_labels

logger = logging.getLogger(__name__)

RTSTRUCT_STORAGE = "1.2.840.10008.5.1.4.1.1.481.3"


def _slice_contours(mask2d: np.ndarray) -> list[np.ndarray]:
    """Contours of a 2D (x, y) mask in pixel coordinates (x, y), outer and
    hole borders (a ring without its hole contour would rasterize back as a
    disk); contours of fewer than 3 points (a pixel, a 2-pixel line) are
    dropped."""
    out = []
    for c in find_contours(mask2d.T):   # the tracer takes (rows = y, cols = x)
        pts = c[:, 0, :]
        if len(pts) >= 3:
            out.append(pts.astype(np.float64))
    return out


def write_rtstruct(seg: np.ndarray, label_map: dict[int, str],
                   source_headers: Sequence[Dataset],
                   colors: dict[int, tuple[int, int, int]] | None = None,
                   label: str = "BOA-TPU", spans: dict | None = None) -> Dataset:
    """Build an RTSTRUCT dataset from an (x, y, z) label volume aligned to
    the given z-sorted CT slice headers. `spans`, when given, receives the
    seconds of the contour tracer (`contours`)."""
    first = source_headers[0]
    ds = Dataset()
    sop_uid = generate_uid()
    meta = Dataset()
    meta.MediaStorageSOPClassUID = RTSTRUCT_STORAGE
    meta.MediaStorageSOPInstanceUID = sop_uid
    meta.TransferSyntaxUID = dicom.EXPLICIT_VR_LE
    ds.file_meta = meta
    ds.SOPClassUID = RTSTRUCT_STORAGE
    ds.SOPInstanceUID = sop_uid
    for kw in ("PatientName", "PatientID", "PatientBirthDate", "PatientSex",
               "StudyDate", "StudyTime", "AccessionNumber", "StudyID",
               "StudyInstanceUID"):
        v = first.get(kw)
        if v is not None:
            setattr(ds, kw, v)
    now = datetime.now()
    ds.Modality = "RTSTRUCT"
    ds.SeriesInstanceUID = generate_uid()
    ds.SeriesNumber = 98
    ds.InstanceNumber = 1
    ds.StructureSetLabel = label
    ds.StructureSetDate = now.strftime("%Y%m%d")
    ds.StructureSetTime = now.strftime("%H%M%S")
    ds.Manufacturer = "boa_tpu"
    frame_uid = first.get("FrameOfReferenceUID", generate_uid())
    fref = Dataset()
    fref.FrameOfReferenceUID = frame_uid
    ds.ReferencedFrameOfReferenceSequence = [fref]

    labels = sorted(lb for lb in np.unique(seg) if lb and lb in label_map)
    present = slice_labels(seg, max(labels, default=0))
    iop = np.asarray(first.get("ImageOrientationPatient")
                     or [1, 0, 0, 0, 1, 0], float)
    ps = first.get("PixelSpacing") or [1.0, 1.0]
    col_dir, row_dir = iop[:3], iop[3:]
    row_sp, col_sp = float(ps[0]), float(ps[1])

    roi_seq, contour_seq, obs_seq = [], [], []
    for num, lb in enumerate(labels, start=1):
        roi = Dataset()
        roi.ROINumber = num
        roi.ROIName = label_map[lb]
        roi.ROIGenerationAlgorithm = "AUTOMATIC"
        roi.ReferencedFrameOfReferenceUID = frame_uid
        roi_seq.append(roi)

        rc = Dataset()
        rc.ReferencedROINumber = num
        if colors and lb in colors:
            rc.ROIDisplayColor = list(colors[lb])
        contours = []
        for z in range(seg.shape[2]):
            if not present[z, lb]:
                continue
            ipp = np.asarray(source_headers[z].get("ImagePositionPatient")
                             or [0, 0, z], float)
            t0 = time.perf_counter()
            polys = _slice_contours(seg[:, :, z] == lb)
            if spans is not None:
                spans["contours"] = spans.get("contours", 0) + time.perf_counter() - t0
            for poly in polys:
                c = Dataset()
                c.ContourGeometricType = "CLOSED_PLANAR"
                c.NumberOfContourPoints = len(poly)
                pts3d = (ipp[None]
                         + poly[:, 0:1] * col_dir[None] * col_sp
                         + poly[:, 1:2] * row_dir[None] * row_sp)
                c.ContourData = [float(v) for v in pts3d.ravel()]
                img = Dataset()
                img.ReferencedSOPClassUID = source_headers[z].get(
                    "SOPClassUID", dicom.CT_IMAGE_STORAGE)
                img.ReferencedSOPInstanceUID = source_headers[z].get(
                    "SOPInstanceUID", "")
                c.ContourImageSequence = [img]
                contours.append(c)
        rc.ContourSequence = contours
        contour_seq.append(rc)

        obs = Dataset()
        obs.ObservationNumber = num
        obs.ReferencedROINumber = num
        obs.RTROIInterpretedType = "ORGAN"
        obs.ROIInterpreter = ""
        obs_seq.append(obs)

    ds.StructureSetROISequence = roi_seq
    ds.ROIContourSequence = contour_seq
    ds.RTROIObservationsSequence = obs_seq
    return ds
