"""Orthanc Python-plugin callback.

Counterpart of `boa_tpu/pacs/on_change.py` (upstream
`scripts/on_change_callback.py`): when a series becomes stable, gate it
(enough instances, CT modality, AXIAL image type), enqueue the worker task
and record it in the monitoring DB; a rejected series is logged, recorded
as not computed and deleted from Orthanc. The `orthanc` module is provided
by the Orthanc runtime; tests stub it. Orthanc's embedded Python only
publishes tasks, so nothing this module imports loads torch or numpy.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from typing import Any

import orthanc  # provided by the Orthanc python plugin runtime

from boa_tpu_torch.pacs.util import get_db_connection, write_to_postgres
from boa_tpu_torch.pacs.worker import analyze_stable_series

#: tags echoed to the Orthanc log for every stable series
IMPORTANT_INFOS = [
    "StudyDate",
    "AccessionNumber",
    "SeriesNumber",
    "SeriesDescription",
]


def summarize_important_info(dicom_tags: dict[str, Any]) -> str:
    lines = [f"{tag}: {dicom_tags.get(tag, 'Unknown')}"
             for tag in IMPORTANT_INFOS]
    return "\n".join(lines) + "\n"


def _gate_reason(series_info: dict[str, Any], dicom_tags: dict[str, Any],
                 minimum_images: int) -> str | None:
    """Why a series should be skipped, or None to accept it.

    Missing tags are accepted conservatively, like the reference — only a
    tag that is present and wrong rejects.
    """
    n = len(series_info["Instances"])
    if n < minimum_images:
        return f"only {n} instances (need at least {minimum_images})"
    modality = dicom_tags.get("Modality", "CT")
    if modality != "CT":
        return f"modality {modality!r} is not CT"
    image_type = dicom_tags.get("ImageType", ["AXIAL"])
    if "AXIAL" not in image_type:
        return f"image type {image_type!r} lacks AXIAL"
    return None


def generate_task(series_info: dict[str, Any], dicom_tags: dict[str, Any],
                  minimum_images: int = 10) -> bool:
    """Series gating (behavior of `on_change_callback.py:27-50`)."""
    reason = _gate_reason(series_info, dicom_tags, minimum_images)
    if reason is not None:
        orthanc.LogWarning(f"Series skipped: {reason}")
        return False
    return True


def get_max_id(connection: Any) -> Any:
    with connection.cursor() as cursor:
        cursor.execute("SELECT MAX(id) FROM boa_entries")
        return cursor.fetchone()[0]


def _monitoring_row(dicom_tags: dict[str, Any]) -> dict[str, Any]:
    stamp = datetime.now(timezone.utc).strftime("%Y-%m-%d %H:%M:%S")
    return {
        "orthanc_timestamp": stamp,
        "study_description": dicom_tags.get("StudyDescription", "Unknown"),
        "accession_number": dicom_tags.get("AccessionNumber", "Unknown"),
        "series_description": dicom_tags.get("SeriesDescription", "Unknown"),
    }


def on_change(change_type: int, _level: int, resource_id: str) -> None:
    if change_type != orthanc.ChangeType.STABLE_SERIES:
        return
    orthanc.LogWarning(f"Stable series received: {resource_id}")
    series_info = json.loads(orthanc.RestApiGet(f"/series/{resource_id}"))
    first_instance = series_info["Instances"][0]
    dicom_tags = json.loads(orthanc.RestApiGet(
        f"/instances/{first_instance}/simplified-tags"))
    orthanc.LogWarning(
        "Series tags:\n" + summarize_important_info(dicom_tags))

    row = _monitoring_row(dicom_tags)
    db_conn = get_db_connection()
    try:
        if generate_task(series_info, dicom_tags):
            task = analyze_stable_series.delay(resource_id=resource_id)
            row["task_id"] = str(task)
            write_to_postgres(db_conn, data=row)
            orthanc.LogWarning(
                f"Enqueued task {task} for series {resource_id}.")
        else:
            if db_conn is not None:
                row["task_id"] = f"none-{get_max_id(db_conn)}"
                row["computed"] = False
                write_to_postgres(db_conn, data=row)
            orthanc.LogWarning(
                f"Series {resource_id} rejected by the gating rules; "
                "deleting it.")
            orthanc.RestApiDelete(f"/series/{resource_id}")
    finally:
        if db_conn is not None:
            db_conn.close()


orthanc.RegisterOnChangeCallback(on_change)
