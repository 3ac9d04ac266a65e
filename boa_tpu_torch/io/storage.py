"""Output sinks: DICOM-SEG and encapsulated-PDF generation and upload, SMB
storage of the workbook.

Counterpart of `boa_tpu/io/storage.py` (upstream `compute/io.py`
`store_dicoms` and `store_excel`). The DICOMweb STOW-RS upload is a
multipart/related POST over urllib, so no dicomweb client is needed; SMB
needs the optional `smbclient` package and raises a clear error without it.
"""

from __future__ import annotations

import base64
import logging
import os
import secrets
import urllib.request
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np

from boa_tpu_torch.io import dicom, dicom_io, dicom_seg, nifti
from boa_tpu_torch.tasks import class_maps
from boa_tpu_torch.utils.constants import SERIES_DESCRIPTIONS
from boa_tpu_torch.version import __version__

logger = logging.getLogger(__name__)

# a source of the deterministic UIDs below, as the reference's
__githash__ = "unknown"

# output kinds written as DICOM-SEG, mirroring templates/*-meta.json
SEG_OUTPUT_KINDS = [
    "body_parts", "body_regions", "tissues", "total",
    "lung_vessels_airways", "cerebral_bleed", "hip_implant",
    "coronary_arteries", "pleural_pericard_effusion", "liver_vessels",
    "heartchambers", "ct_pfav",
]


def _label_map_for_kind(kind: str) -> dict[int, str] | None:
    try:
        if kind == "tissues":
            return {int(v): k for k, v in class_maps.bca_tissues().items()}
        if kind == "body_regions":
            return {int(v): k for k, v in class_maps.bca_body_regions().items()}
        if kind == "body_parts":
            return {int(v): k for k, v in class_maps.bca_body_parts().items()}
        key = {"lung_vessels_airways": "lung_vessels",
               "heartchambers": "heartchambers_highres",
               "ct_pfav": None}.get(kind, kind)
        if key is None:
            return {1: "pulmonary_fat"}
        return class_maps.get_class_map(key)
    except KeyError:
        return None


def set_dcm_params(img_dcm: dicom.Dataset, out_dcm: dicom.Dataset,
                   series_id: int, output_name: str,
                   timestamp: datetime) -> None:
    """Deterministic series and SOP UIDs, descriptions and dates
    (upstream `io.py:92-119`)."""
    out_dcm.SeriesDescription = SERIES_DESCRIPTIONS.get(output_name, output_name)
    out_dcm.SeriesNumber = 42000 * int(img_dcm.get("SeriesNumber", 1) or 1) + series_id
    out_dcm.SeriesInstanceUID = dicom.generate_uid(entropy_srcs=[
        str(img_dcm.get("StudyInstanceUID")),
        str(img_dcm.get("SeriesInstanceUID")),
        output_name, __githash__, __version__])
    out_dcm.SOPInstanceUID = dicom.generate_uid(entropy_srcs=[
        str(img_dcm.get("StudyInstanceUID")),
        str(out_dcm.SeriesInstanceUID)])
    bpe = img_dcm.get("BodyPartExamined")
    if bpe is not None:
        out_dcm.BodyPartExamined = bpe
    out_dcm.file_meta.MediaStorageSOPInstanceUID = out_dcm.SOPInstanceUID
    date_str = timestamp.strftime("%Y%m%d")
    time_str = timestamp.strftime("%H%M%S")
    out_dcm.InstanceCreationDate = date_str
    out_dcm.InstanceCreationTime = time_str
    out_dcm.SeriesDate = date_str
    out_dcm.SeriesTime = time_str
    out_dcm.ContentDate = date_str
    out_dcm.ContentTime = time_str


def build_output_dicoms(input_folder: Path, segmentation_folder: Path
                        ) -> tuple[list[dicom.Dataset], list[dict[str, Any]]]:
    """A SEG dataset for every label file the study wrote, and the report's
    encapsulated PDF."""
    segmentation_folder = Path(segmentation_folder)
    # headers only: the geometry is all this needs
    files, headers = dicom_io.sorted_series_headers(Path(input_folder))
    img_dcm = headers[0]
    img_shape = (int(img_dcm.get("Columns")), int(img_dcm.get("Rows")), len(files))
    timestamp = datetime.now()
    generated: list[dicom.Dataset] = []
    info: list[dict[str, Any]] = []

    for i, kind in enumerate(SEG_OUTPUT_KINDS):
        seg_file = segmentation_folder / f"{kind}.nii.gz"
        if not seg_file.exists():
            logger.warning("The segmentation %s does not exist.", kind)
            continue
        seg_img = nifti.load(seg_file)
        if tuple(seg_img.shape) != img_shape:
            raise ValueError(
                f"Image and segmentation {kind} do not have the same size: "
                f"{img_shape} vs. {seg_img.shape}")
        seg_arr = np.asarray(seg_img.data)
        if not seg_arr.sum():
            logger.warning("The segmentation %s does not have any values.", kind)
            continue
        if kind == "body_regions":
            seg_arr = seg_arr.copy()
            seg_arr[seg_arr == 255] = 0  # drop the ignore label (upstream io.py:177-182)
        label_map = seg_img.get_label_map() or _label_map_for_kind(kind) or {
            int(lb): f"label_{int(lb)}" for lb in np.unique(seg_arr) if lb}
        try:
            out = dicom_seg.write_multiclass_seg(
                seg_arr, label_map, headers,
                series_description=SERIES_DESCRIPTIONS.get(kind, kind))
        except ValueError as exc:
            logger.warning("Skipping %s: %s", kind, exc)
            continue
        set_dcm_params(img_dcm, out, i, kind, timestamp)
        info.append({"name": kind,
                     "study_instance_uid": img_dcm.get("StudyInstanceUID"),
                     "series_instance_uid": out.SeriesInstanceUID,
                     "sop_instance_uid": out.SOPInstanceUID})
        generated.append(out)

    report = segmentation_folder / "report.pdf"
    if report.exists():
        pdf_dcm = dicom_seg.write_encapsulated_pdf(report.read_bytes(), img_dcm)
        set_dcm_params(img_dcm, pdf_dcm, len(SEG_OUTPUT_KINDS), "report", timestamp)
        info.append({"name": "report",
                     "study_instance_uid": img_dcm.get("StudyInstanceUID"),
                     "series_instance_uid": pdf_dcm.SeriesInstanceUID,
                     "sop_instance_uid": pdf_dcm.SOPInstanceUID})
        generated.append(pdf_dcm)
    return generated, info


def stow_rs(url: str, datasets: list[dicom.Dataset],
            auth: tuple[str, str] | None = None) -> None:
    """DICOMweb STOW-RS upload as one multipart/related POST."""
    boundary = secrets.token_hex(16)
    parts = []
    for ds in datasets:
        body = dicom.dataset_bytes(ds)
        parts.append(f"--{boundary}\r\nContent-Type: application/dicom\r\n\r\n"
                     .encode() + body + b"\r\n")
    payload = b"".join(parts) + f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(url.rstrip("/") + "/studies", data=payload, method="POST")
    req.add_header("Content-Type", f'multipart/related; type="application/dicom"; '
                                   f'boundary={boundary}')
    req.add_header("Accept", "application/dicom+json")
    if auth:
        cred = base64.b64encode(f"{auth[0]}:{auth[1]}".encode()).decode()
        req.add_header("Authorization", f"Basic {cred}")
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status not in (200, 202):
            raise RuntimeError(f"STOW-RS upload failed: HTTP {resp.status}")


def store_dicoms(input_folder: Path, segmentation_folder: Path) -> list[dict[str, Any]]:
    """Build every output DICOM and upload them over DICOMweb
    (upstream `io.py:120-251`)."""
    generated, info = build_output_dicoms(input_folder, segmentation_folder)
    if not generated:
        logger.warning("No DICOMs generated. Skipping DICOM-Web upload.")
        return info
    url = os.environ["SEGMENTATION_UPLOAD_URL"]
    auth = (os.environ["UPLOAD_USER"], os.environ["UPLOAD_PWD"])
    logger.info("Uploading %s objects to %s with user %s.", len(generated), url, auth[0])
    stow_rs(url, generated, auth)
    return info


def _get_smb_info() -> tuple[str, str]:
    raw = os.environ["SMB_DIR_OUTPUT"].replace("\\", "/")
    normalized = raw.rstrip("/") + "/"
    parts = [p for p in normalized.split("/") if p]
    if len(parts) < 2:
        raise ValueError(
            f"SMB_DIR_OUTPUT must be a UNC-style path with server/share, got: {raw!r}")
    return parts[0], normalized


def store_excel(paths_to_store: list[Path], store_path: str) -> None:
    """Copy result files to an SMB share (upstream `io.py:56-78`)."""
    try:
        import smbclient
        import smbclient.shutil
    except ImportError as exc:  # smbclient is an optional PACS-only dependency
        raise RuntimeError(
            "store_excel requires the 'smbclient' package (PACS deployment "
            "image); it is not installed in this environment") from exc

    smbclient.ClientConfig(username=os.environ["SMB_USER"], password=os.environ["SMB_PWD"])
    server_name, full_name = _get_smb_info()
    smbclient.register_session(server=server_name, username=os.environ["SMB_USER"],
                               password=os.environ["SMB_PWD"])
    try:
        target_dir = f"{full_name}{store_path}"
        smbclient.makedirs(target_dir, exist_ok=True)
        for p in paths_to_store:
            if p.exists():
                smbclient.shutil.copy2(str(p), f"{target_dir}{p.name}")
            else:
                logger.warning("Skipping missing file: %s", p)
    finally:
        smbclient.delete_session(server=server_name)
