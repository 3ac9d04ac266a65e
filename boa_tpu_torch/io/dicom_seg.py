"""DICOM-SEG and Encapsulated-PDF writers.

Counterpart of `boa_tpu/io/dicom_seg.py`: the pydicom_seg.MultiClassWriter +
dcmqi metainfo templates of `body_organ_analysis/compute/io.py:122-251`
(binary Segmentation IOD, skip_empty_slices=True, one segment per label,
CIELab display colors), and an Encapsulated PDF IOD writer in place of the
DCMTK `pdf2dcm` subprocess (`io.py:139-153`). Both build on the port's
DICOM dataset and writer (io/dicom.py). A label's frames are cut only from
the slices that hold it, found in one counting pass per slice.
"""

from __future__ import annotations

import logging
from datetime import datetime
from typing import Sequence

import numpy as np

from boa_tpu_torch.io import dicom
from boa_tpu_torch.io.dicom import Dataset, code_item, generate_uid

logger = logging.getLogger(__name__)

# SCT = SNOMED CT coding scheme (dcmqi default category/type for organs)
_CATEGORY = ("123037004", "SCT", "Anatomical Structure")
_TYPE = ("78961009", "SCT", "Anatomical structure")  # generic fallback


def _now_strings(ts: datetime | None = None) -> tuple[str, str]:
    ts = ts or datetime.now()
    return ts.strftime("%Y%m%d"), ts.strftime("%H%M%S")


def _file_meta(sop_class: str, sop_uid: str) -> Dataset:
    meta = Dataset()
    meta.MediaStorageSOPClassUID = sop_class
    meta.MediaStorageSOPInstanceUID = sop_uid
    meta.TransferSyntaxUID = dicom.EXPLICIT_VR_LE
    return meta


def _copy_patient_study(src: Dataset, dst: Dataset) -> None:
    for kw in ("PatientName", "PatientID", "PatientBirthDate", "PatientSex",
               "StudyDate", "StudyTime", "AccessionNumber", "StudyID",
               "StudyInstanceUID", "ReferringPhysicianName"):
        v = src.get(kw)
        if v is not None:
            setattr(dst, kw, v)


def slice_labels(seg: np.ndarray, max_label: int) -> np.ndarray:
    """(nz, max_label + 1) bool: which labels each z-slice of an (x, y, z)
    label volume holds (labels above `max_label` are ignored)."""
    nz = seg.shape[2]
    out = np.zeros((nz, max_label + 1), bool)
    for z in range(nz):
        counts = np.bincount(seg[:, :, z].ravel(), minlength=max_label + 1)
        out[z] = counts[:max_label + 1] > 0
    return out


def write_multiclass_seg(
    seg: np.ndarray,                     # (x, y, z) label volume
    label_map: dict[int, str],           # label -> name (0 = background)
    source_headers: Sequence[Dataset],   # per-slice CT headers, z-sorted
    series_description: str,
    colors: dict[int, tuple[int, int, int]] | None = None,
    skip_empty_slices: bool = True,
    content_label: str = "SEG",
    algorithm_name: str = "BOA-TPU",
) -> Dataset:
    """Build a binary multi-segment Segmentation IOD dataset."""
    first = source_headers[0]
    nx, ny, nz = seg.shape
    if nz != len(source_headers):
        raise ValueError(f"segmentation has {nz} slices but "
                         f"{len(source_headers)} source headers given")
    labels = sorted(lb for lb in np.unique(seg) if lb != 0 and lb in label_map)
    if not labels:
        raise ValueError("segmentation is empty")

    ds = Dataset()
    sop_uid = generate_uid()
    ds.file_meta = _file_meta(dicom.SEGMENTATION_STORAGE, sop_uid)
    ds.SOPClassUID = dicom.SEGMENTATION_STORAGE
    ds.SOPInstanceUID = sop_uid
    _copy_patient_study(first, ds)
    d, t = _now_strings()
    ds.SeriesDate = d
    ds.SeriesTime = t
    ds.ContentDate = d
    ds.ContentTime = t
    ds.Modality = "SEG"
    ds.SeriesInstanceUID = generate_uid()
    ds.SeriesNumber = 99
    ds.InstanceNumber = 1
    ds.FrameOfReferenceUID = first.get("FrameOfReferenceUID", generate_uid())
    ds.PositionReferenceIndicator = ""
    ds.SeriesDescription = series_description
    ds.ContentLabel = content_label
    ds.ContentDescription = series_description
    ds.ContentCreatorName = "BOA-TPU"
    ds.Manufacturer = "boa_tpu"
    ds.ManufacturerModelName = "boa_tpu"
    ds.SoftwareVersions = "boa_tpu"
    ds.DeviceSerialNumber = "0"
    ds.ImageType = ["DERIVED", "PRIMARY"]
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.Rows = ny
    ds.Columns = nx
    ds.BitsAllocated = 1
    ds.BitsStored = 1
    ds.HighBit = 0
    ds.PixelRepresentation = 0
    ds.LossyImageCompression = "00"
    ds.SegmentationType = "BINARY"

    # dimension organization (segment, position)
    dim_uid = generate_uid()
    org = Dataset()
    org.DimensionOrganizationUID = dim_uid
    ds.DimensionOrganizationSequence = [org]
    dim1 = Dataset()
    dim1.DimensionOrganizationUID = dim_uid
    dim1.DimensionIndexPointer = dicom.DICT["ReferencedSegmentNumber"][:2]
    dim1.FunctionalGroupPointer = dicom.DICT["SegmentIdentificationSequence"][:2]
    dim2 = Dataset()
    dim2.DimensionOrganizationUID = dim_uid
    dim2.DimensionIndexPointer = dicom.DICT["ImagePositionPatient"][:2]
    dim2.FunctionalGroupPointer = dicom.DICT["PlanePositionSequence"][:2]
    ds.DimensionIndexSequence = [dim1, dim2]

    # segment sequence
    seg_items = []
    for i, lb in enumerate(labels, start=1):
        item = Dataset()
        item.SegmentNumber = i
        item.SegmentLabel = label_map[lb]
        item.SegmentDescription = label_map[lb]
        item.SegmentAlgorithmType = "AUTOMATIC"
        item.SegmentAlgorithmName = algorithm_name
        item.SegmentedPropertyCategoryCodeSequence = [code_item(*_CATEGORY)]
        item.SegmentedPropertyTypeCodeSequence = [code_item(*_TYPE)]
        if colors and lb in colors:
            item.RecommendedDisplayCIELabValue = \
                dicom.rgb_to_cielab_dicom(colors[lb])
        seg_items.append(item)
    ds.SegmentSequence = seg_items

    # shared functional groups: plane orientation + pixel measures
    shared = Dataset()
    po = Dataset()
    po.ImageOrientationPatient = list(first.get("ImageOrientationPatient")
                                      or [1, 0, 0, 0, 1, 0])
    shared.PlaneOrientationSequence = [po]
    pm = Dataset()
    ps = first.get("PixelSpacing") or [1.0, 1.0]
    pm.PixelSpacing = [float(ps[0]), float(ps[1])]
    if len(source_headers) > 1:
        p0 = np.asarray(source_headers[0].get("ImagePositionPatient"), float)
        p1 = np.asarray(source_headers[1].get("ImagePositionPatient"), float)
        pm.SpacingBetweenSlices = float(np.linalg.norm(p1 - p0))
        pm.SliceThickness = float(first.get("SliceThickness",
                                            pm.SpacingBetweenSlices)
                                  or pm.SpacingBetweenSlices)
    shared.PixelMeasuresSequence = [pm]
    ds.SharedFunctionalGroupsSequence = [shared]

    # frames: per segment, per (non-empty) slice
    frames: list[np.ndarray] = []
    perframe: list[Dataset] = []
    present = slice_labels(seg, max(labels))
    for seg_idx, lb in enumerate(labels, start=1):
        for z in range(nz):
            if skip_empty_slices and not present[z, lb]:
                continue
            frames.append((seg[:, :, z] == lb).T.astype(np.uint8))  # (rows, cols)
            fg = Dataset()
            fc = Dataset()
            fc.DimensionIndexValues = [seg_idx, z + 1]
            fg.FrameContentSequence = [fc]
            pp = Dataset()
            pp.ImagePositionPatient = list(
                source_headers[z].get("ImagePositionPatient") or [0, 0, z])
            fg.PlanePositionSequence = [pp]
            si = Dataset()
            si.ReferencedSegmentNumber = seg_idx
            fg.SegmentIdentificationSequence = [si]
            refs = []
            ref = Dataset()
            ref.ReferencedSOPClassUID = source_headers[z].get(
                "SOPClassUID", dicom.CT_IMAGE_STORAGE)
            ref.ReferencedSOPInstanceUID = source_headers[z].get(
                "SOPInstanceUID", "")
            refs.append(ref)
            der = Dataset()
            der.SourceImageSequence = refs
            fg.DerivationImageSequence = [der]
            perframe.append(fg)
    ds.NumberOfFrames = len(frames)
    ds.PerFrameFunctionalGroupsSequence = perframe

    packed = np.packbits(np.concatenate([f.ravel() for f in frames]),
                         bitorder="little")
    ds.set_raw(dicom.DICT["PixelData"][:2], "OB", packed.tobytes())

    # referenced series
    rs = Dataset()
    rs.SeriesInstanceUID = first.get("SeriesInstanceUID", "")
    inst_items = []
    for hdr in source_headers:
        it = Dataset()
        it.ReferencedSOPClassUID = hdr.get("SOPClassUID",
                                           dicom.CT_IMAGE_STORAGE)
        it.ReferencedSOPInstanceUID = hdr.get("SOPInstanceUID", "")
        inst_items.append(it)
    rs.ReferencedInstanceSequence = inst_items
    ds.ReferencedSeriesSequence = [rs]
    return ds


def read_seg_labelmap(ds: Dataset) -> tuple[np.ndarray, dict[int, str]]:
    """Inverse of write_multiclass_seg (round-trip testing): rebuild the
    (x, y, z) label volume from a binary multi-segment SEG dataset."""
    rows, cols = int(ds.Rows), int(ds.Columns)
    n_frames = int(ds.NumberOfFrames)
    bits = np.unpackbits(np.frombuffer(ds.get("PixelData"), np.uint8),
                         bitorder="little")[: n_frames * rows * cols]
    frames = bits.reshape(n_frames, rows, cols)
    seen: set[tuple] = set()
    zs = []
    for fg in ds.PerFrameFunctionalGroupsSequence:
        ipp = tuple(fg.PlanePositionSequence[0].ImagePositionPatient)
        if ipp not in seen:  # segments sharing a slice reuse its z index
            seen.add(ipp)
            zs.append(ipp)
    zs.sort(key=lambda p: p[2])
    pos_to_z = {p: i for i, p in enumerate(zs)}
    seg_names = {int(s.SegmentNumber): s.SegmentLabel
                 for s in ds.SegmentSequence}
    vol = np.zeros((cols, rows, len(zs)), np.uint16)
    for k, fg in enumerate(ds.PerFrameFunctionalGroupsSequence):
        z = pos_to_z[tuple(fg.PlanePositionSequence[0].ImagePositionPatient)]
        segno = int(fg.SegmentIdentificationSequence[0].ReferencedSegmentNumber)
        vol[:, :, z][frames[k].T.astype(bool)] = segno
    return vol, seg_names


def write_encapsulated_pdf(pdf_bytes: bytes, source_header: Dataset,
                           title: str = "Body Composition Analysis Report"
                           ) -> Dataset:
    """Encapsulated PDF IOD (replaces the DCMTK pdf2dcm subprocess)."""
    ds = Dataset()
    sop_uid = generate_uid()
    ds.file_meta = _file_meta(dicom.ENCAPSULATED_PDF_STORAGE, sop_uid)
    ds.SOPClassUID = dicom.ENCAPSULATED_PDF_STORAGE
    ds.SOPInstanceUID = sop_uid
    _copy_patient_study(source_header, ds)
    d, t = _now_strings()
    ds.ContentDate = d
    ds.ContentTime = t
    ds.SeriesDate = d
    ds.SeriesTime = t
    ds.Modality = "DOC"
    ds.SeriesInstanceUID = generate_uid()
    ds.SeriesNumber = 100
    ds.InstanceNumber = 1
    ds.BurnedInAnnotation = "YES"
    ds.DocumentTitle = title
    ds.SeriesDescription = title
    ds.VerificationFlag = "UNVERIFIED"
    ds.ConceptNameCodeSequence = [code_item("18748-4", "LN",
                                            "Diagnostic imaging report")]
    ds.MIMETypeOfEncapsulatedDocument = "application/pdf"
    ds.set_raw(dicom.DICT["EncapsulatedDocument"][:2], "OB",
               pdf_bytes + (b"\x00" if len(pdf_bytes) % 2 else b""))
    return ds
