"""DICOM series → NIfTI ingest, validation and metadata extraction.

Counterpart of `boa_tpu/io/dicom_io.py`, on the host (numpy). Parity:
`body_organ_analysis/compute/io.py:253-383` — GDCM series read → NIfTI
(`_load_series_from_disk` + `get_image_info`), axial/tilt validation
(`validate_dicom:286-323`, `classify_orientation:270-283`), and the 17-tag
metadata table. The reader sorts instances along the slice normal from
ImagePositionPatient (GDCM ordering) and builds the NIfTI affine from
IOP/IPP/PixelSpacing (LPS → RAS sign flip).
"""

from __future__ import annotations

import logging
from datetime import date, datetime
from pathlib import Path
from typing import Any

import numpy as np

from boa_tpu_torch.io import dicom, dicom_codecs, nifti

logger = logging.getLogger(__name__)


def _safe_date(value: Any) -> date | None:
    if not value:
        return None
    s = str(value).strip()
    try:
        return datetime.strptime(s[:8], "%Y%m%d").date()
    except ValueError:
        return None


def _compute_age(when: date, birthdate: date) -> int:
    return (when.year - birthdate.year
            - ((when.month, when.day) < (birthdate.month, birthdate.day)))


def classify_orientation(iop) -> tuple[str | None, np.ndarray | None]:
    """('axial'|'coronal'|'sagittal', slice normal) — `io.py:270-283`."""
    if iop is None or len(iop) != 6:
        return None, None
    row = np.asarray(iop[:3], dtype=float)
    col = np.asarray(iop[3:], dtype=float)
    normal = np.cross(row, col)
    ax, ay, az = abs(normal[0]), abs(normal[1]), abs(normal[2])
    if az >= ax and az >= ay:
        return "axial", normal
    if ay >= ax and ay >= az:
        return "coronal", normal
    return "sagittal", normal


def validate_dicom(dcm: dicom.Dataset, num_dicoms: int, *,
                   minimum_images: int = 10,
                   axial_normal_z_min: float = 0.85) -> str | None:
    """None if acceptable, else the rejection reason (`io.py:286-323`)."""
    if num_dicoms < minimum_images:
        return (f"The series has less than {minimum_images} instances: "
                f"{num_dicoms}.")
    modality = dcm.get("Modality")
    if modality is not None and modality != "CT":
        return f"The modality is not CT: {modality}"
    iop = dcm.get("ImageOrientationPatient")
    if iop is not None:
        plane, normal = classify_orientation(iop)
        if plane is not None and normal is not None and plane != "axial":
            return (f"Image plane is {plane}, not axial. IOP={list(iop)}, "
                    f"slice normal={normal.tolist()}")
        if normal is not None and abs(normal[2]) < axial_normal_z_min:
            return ("Axial but tilted beyond tolerance: |normal_z|="
                    f"{abs(normal[2]):.3f} < {axial_normal_z_min}. "
                    f"IOP={list(iop)}")
    image_type = dcm.get("ImageType") or ()
    if isinstance(image_type, str):
        image_type = [image_type]
    bad_markers = {"LOCALIZER", "REFORMATTED", "DERIVED", "PROJECTION IMAGE"}
    hits = bad_markers & set(image_type)
    if hits:
        return (f"ImageType contains disqualifying marker(s) {hits}: "
                f"{list(image_type)}")
    return None


def sorted_series_headers(input_folder: Path
                          ) -> tuple[list[Path], list[dicom.Dataset]]:
    """Largest series in a folder: (position-sorted files, their headers).

    Header-only pass (no pixel decode) — consumers that only need geometry
    or metadata (the SEG writer) must not pay a full series decode on this
    host."""
    input_folder = Path(input_folder)
    candidates = [p for p in sorted(input_folder.iterdir())
                  if p.is_file() and not p.name.startswith(".")]
    by_series: dict[str, list[tuple[float, Path, dicom.Dataset]]] = {}
    for p in candidates:
        try:
            ds = dicom.dcmread(p, stop_before_pixels=True)
        except Exception:
            continue
        uid = ds.get("SeriesInstanceUID")
        if uid is None or ds.get("PixelSpacing") is None:
            continue
        iop = ds.get("ImageOrientationPatient") or [1, 0, 0, 0, 1, 0]
        normal = np.cross(np.asarray(iop[:3], float), np.asarray(iop[3:], float))
        ipp = np.asarray(ds.get("ImagePositionPatient") or [0, 0, 0], float)
        by_series.setdefault(uid, []).append((float(normal @ ipp), p, ds))
    if not by_series:
        raise ValueError(f"No DICOM series found in {input_folder}")
    uid, slices = max(by_series.items(), key=lambda kv: len(kv[1]))
    slices.sort(key=lambda t: t[0])
    return [p for _, p, _ in slices], [h for _, _, h in slices]


def read_series(input_folder: Path) -> tuple[nifti.NiftiImage, list[Path],
                                             dicom.Dataset]:
    """Read the (largest) series in a folder into a NiftiImage.

    Returns (image, sorted file list, header of first instance). Voxel order
    is (x, y, z) with a NIfTI RAS affine, matching what SimpleITK's
    WriteImage produces for the reference.
    """
    files, headers = sorted_series_headers(input_folder)
    slices = list(zip([0.0] * len(files), files, headers))
    first = headers[0]

    rows = int(first.get("Rows"))
    cols = int(first.get("Columns"))
    n = len(slices)
    vol = np.empty((cols, rows, n), dtype=np.int16)  # (x, y, z)
    for k, (_, p, _hdr) in enumerate(slices):
        full = dicom.dcmread(p)
        arr = dicom.pixel_array(full).astype(np.float32)
        slope = float(full.get("RescaleSlope", 1.0) or 1.0)
        intercept = float(full.get("RescaleIntercept", 0.0) or 0.0)
        arr = arr * slope + intercept
        # DICOM rows are y, columns are x -> transpose to (x, y)
        vol[:, :, k] = np.clip(np.round(arr.T), -32768, 32767).astype(np.int16)

    # affine: LPS direction cosines scaled by spacing; z from slice step
    iop = np.asarray(first.get("ImageOrientationPatient")
                     or [1, 0, 0, 0, 1, 0], float)
    ps = first.get("PixelSpacing")
    row_sp, col_sp = float(ps[0]), float(ps[1])  # (row, col) spacing
    ipp0 = np.asarray(slices[0][2].get("ImagePositionPatient")
                      or [0, 0, 0], float)
    if n > 1:
        ippN = np.asarray(slices[-1][2].get("ImagePositionPatient")
                          or [0, 0, n - 1.0], float)
        zvec = (ippN - ipp0) / (n - 1)
    else:
        normal = np.cross(iop[:3], iop[3:])
        zvec = normal * float(first.get("SliceThickness", 1.0) or 1.0)
    lps = np.eye(4)
    lps[:3, 0] = iop[:3] * col_sp   # x step = along a row = column dir
    lps[:3, 1] = iop[3:] * row_sp   # y step = along a column = row dir
    lps[:3, 2] = zvec
    lps[:3, 3] = ipp0
    ras = lps.copy()
    ras[0] *= -1  # LPS -> RAS
    ras[1] *= -1
    return nifti.NiftiImage(data=vol, affine=ras), files, first


def extract_metadata(dcm: dicom.Dataset) -> list[dict[str, Any]]:
    """The 17-tag info table (`io.py:343-382`)."""
    series_date = _safe_date(dcm.get("SeriesDate"))
    birth_date = _safe_date(dcm.get("PatientBirthDate"))
    pixel_spacing = dcm.get("PixelSpacing")
    ordered: list[tuple[str, Any]] = [
        ("StudyInstanceUID", dcm.get("StudyInstanceUID")),
        ("SeriesInstanceUID", dcm.get("SeriesInstanceUID")),
        ("Date", series_date.strftime("%d.%m.%Y") if series_date else None),
        ("AgeYears", _compute_age(series_date, birth_date)
         if series_date and birth_date else None),
        ("Gender", dcm.get("PatientSex")),
        ("AccessionNumber", dcm.get("AccessionNumber")),
        ("SeriesNumber", dcm.get("SeriesNumber")),
        ("SeriesDescription", dcm.get("SeriesDescription")),
        ("Modality", dcm.get("Modality")),
        ("CTDIvol", dcm.get("CTDIvol")),
        ("ExposureTime", dcm.get("ExposureTime")),
        ("XRayTubeCurrent", dcm.get("XRayTubeCurrent")),
        ("Exposure", dcm.get("Exposure")),
        ("KVP", dcm.get("KVP")),
        ("SpiralPitchFactor", dcm.get("SpiralPitchFactor")),
        ("ConvolutionKernel",
         (dcm.get("ConvolutionKernel")[0]
          if isinstance(dcm.get("ConvolutionKernel"), list)
          else dcm.get("ConvolutionKernel"))),
        ("SliceThickness", dcm.get("SliceThickness")),
    ]
    if isinstance(pixel_spacing, (list, tuple)) and len(pixel_spacing) >= 2:
        ordered.append(("PixelSpacingX", pixel_spacing[0]))
        ordered.append(("PixelSpacingY", pixel_spacing[1]))
    else:
        ordered.append(("PixelSpacing", pixel_spacing))
    ordered.append(("ScanLength", dcm.get("ScanLength")))
    return [{"name": name, "value": value} for name, value in ordered]


def write_ct_series(img: nifti.NiftiImage, out_dir: Path, *,
                    patient_id: str = "ANON", accession: str = "ACC0",
                    series_number: int = 1,
                    series_description: str = "CT Axial",
                    study_uid: str | None = None,
                    series_uid: str | None = None,
                    extra: dict[str, Any] | None = None,
                    transfer_syntax: str | None = None) -> list[Path]:
    """Write a NiftiImage as an axial CT DICOM series.

    The inverse of `read_series` (exact round-trip on int16 HU volumes);
    also the test/PACS-simulation series source — the reference downloads
    a TCIA series for this (`tests/conftest.py:32-60`). `transfer_syntax`
    selects explicit VR LE (default) or one of the supported compressed
    syntaxes (RLE, JPEG Lossless SV1, JPEG-LS, JPEG 2000) with
    encapsulated frames."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = np.asarray(img.data)
    nx, ny, nz = data.shape
    aff = img.affine
    # RAS -> LPS
    lps = aff.copy()
    lps[0] *= -1
    lps[1] *= -1
    col_dir = lps[:3, 0] / np.linalg.norm(lps[:3, 0])
    row_dir = lps[:3, 1] / np.linalg.norm(lps[:3, 1])
    col_sp = float(np.linalg.norm(lps[:3, 0]))
    row_sp = float(np.linalg.norm(lps[:3, 1]))
    slice_sp = float(np.linalg.norm(lps[:3, 2]))
    study_uid = study_uid or dicom.generate_uid()
    series_uid = series_uid or dicom.generate_uid()
    frame_uid = dicom.generate_uid()
    ts = transfer_syntax or dicom.EXPLICIT_VR_LE
    encoders = {
        dicom.RLE_LOSSLESS: dicom_codecs.encode_rle,
        dicom.JPEG_LOSSLESS_SV1: dicom_codecs.encode_jpeg_lossless_sv1,
        dicom.JPEG_LS_LOSSLESS: dicom_codecs.encode_jpeg_ls,
        dicom.JPEG_2000_LOSSLESS: dicom_codecs.encode_jpeg2000,
        # lossy 12-bit (JPEG Extended process 2&4): HU biased to unsigned
        # 12 bits with RescaleIntercept -1024, the usual CT convention
        dicom.JPEG_EXTENDED: lambda sl: dicom_codecs.encode_jpeg_dct(
            sl, precision=12),
    }
    if ts != dicom.EXPLICIT_VR_LE and ts not in encoders:
        raise ValueError(f"unsupported write transfer syntax {ts}")
    lossy12 = ts == dicom.JPEG_EXTENDED
    files = []
    for z in range(nz):
        ds = dicom.Dataset()
        sop_uid = dicom.generate_uid(entropy_srcs=[series_uid, str(z)])
        ds.file_meta = dicom.Dataset()
        ds.file_meta.MediaStorageSOPClassUID = dicom.CT_IMAGE_STORAGE
        ds.file_meta.MediaStorageSOPInstanceUID = sop_uid
        ds.file_meta.TransferSyntaxUID = ts
        ds.SOPClassUID = dicom.CT_IMAGE_STORAGE
        ds.SOPInstanceUID = sop_uid
        ds.Modality = "CT"
        ds.ImageType = ["ORIGINAL", "PRIMARY", "AXIAL"]
        ds.PatientName = patient_id
        ds.PatientID = patient_id
        ds.PatientSex = "O"
        ds.AccessionNumber = accession
        ds.StudyInstanceUID = study_uid
        ds.SeriesInstanceUID = series_uid
        ds.FrameOfReferenceUID = frame_uid
        ds.StudyID = "1"
        ds.SeriesNumber = series_number
        ds.InstanceNumber = z + 1
        ds.SeriesDescription = series_description
        ds.StudyDate = "20260101"
        ds.SeriesDate = "20260101"
        ds.StudyTime = "120000"
        ds.ImageOrientationPatient = [float(v) for v in
                                      (*col_dir, *row_dir)]
        ipp = lps[:3, 3] + z * lps[:3, 2]
        ds.ImagePositionPatient = [float(v) for v in ipp]
        ds.PixelSpacing = [row_sp, col_sp]
        ds.SliceThickness = slice_sp
        ds.Rows = ny
        ds.Columns = nx
        ds.SamplesPerPixel = 1
        ds.PhotometricInterpretation = "MONOCHROME2"
        ds.BitsAllocated = 16
        ds.BitsStored = 12 if lossy12 else 16
        ds.HighBit = 11 if lossy12 else 15
        ds.PixelRepresentation = 0 if lossy12 else 1
        ds.RescaleIntercept = -1024.0 if lossy12 else 0.0
        ds.RescaleSlope = 1.0
        if lossy12:
            ds.LossyImageCompression = "01"
            ds.LossyImageCompressionMethod = "ISO_10918_1"
        for k, v in (extra or {}).items():
            setattr(ds, k, v)
        sl = np.ascontiguousarray(data[:, :, z].T.astype(np.int16))
        if ts == dicom.EXPLICIT_VR_LE:
            ds.set_raw(dicom.DICT["PixelData"][:2], "OW", sl.tobytes())
        elif lossy12:
            biased = np.clip(sl.astype(np.int32) + 1024, 0, 4095
                             ).astype(np.uint16)
            ds.PixelData = dicom.encapsulate([encoders[ts](biased)])
        else:
            frame = encoders[ts](sl.view(np.uint16))
            ds.PixelData = dicom.encapsulate([frame])
        p = out_dir / f"slice_{z:04d}.dcm"
        dicom.dcmwrite(p, ds)
        files.append(p)
    return files


def get_image_info(input_folder: Path, output_folder: Path
                   ) -> tuple[Path, list[dict[str, Any]]]:
    """DICOM dir → image.nii.gz + info rows (`io.py:326-383`)."""
    img, files, dcm = read_series(Path(input_folder))
    message = validate_dicom(dcm, len(files))
    if message:
        raise ValueError(message)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    nifti_path = output_folder / "image.nii.gz"
    nifti.save(img, nifti_path)
    return nifti_path, extract_metadata(dcm)
