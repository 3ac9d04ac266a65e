"""PACS worker utilities.

Counterpart of `boa_tpu/pacs/util.py` (upstream `scripts/util.py`): the
Orthanc REST download, the output naming scheme (umlaut transliteration and
filesystem sanitization), the Postgres UPSERT into `boa_entries`, and the
SMB and DICOMweb persistence. requests, psycopg2 and unidecode become
urllib, a lazy psycopg2 import and a stdlib transliterator. Everything that
loads torch or numpy is imported inside the function that needs it, so that
the Orthanc callback (`pacs/on_change.py`) stays light.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import re
import shutil
import traceback
import unicodedata
import urllib.request
from pathlib import Path
from time import time
from typing import Any

logger = logging.getLogger(__name__)

_VOWEL_MAP = {
    # German
    ord("ä"): "ae", ord("ü"): "ue", ord("ö"): "oe", ord("ß"): "ss",
    ord("Ä"): "Ae", ord("Ü"): "Ue", ord("Ö"): "Oe",
    # Scandinavia
    ord("æ"): "ae", ord("ø"): "oe", ord("å"): "ae",
    ord("Æ"): "Ae", ord("Ø"): "Oe", ord("Å"): "Ae",
}


def _replace_umlauts(text: str) -> str:
    """Transliterate to ASCII (umlaut digraphs first, then NFKD strip —
    the stdlib equivalent of unidecode for the characters PACS names hit)."""
    text = text.translate(_VOWEL_MAP)
    nfkd = unicodedata.normalize("NFKD", text)
    return nfkd.encode("ascii", "ignore").decode("ascii")


def _sanitize_segment(value: str) -> str:
    """One safe path segment: ASCII-transliterated, everything outside
    [A-Za-z0-9_.] replaced — and never empty or dots-only (a '..' segment
    would escape the storage root)."""
    out = re.sub(r"[^\w.]", "_", _replace_umlauts(value))
    if not out.strip("."):
        out = out.replace(".", "_") or "_"
    return out


def _process_info_element(dicom_tags: dict[str, Any],
                          infos_to_include: list[str]) -> str:
    """One path segment from a group of DICOM tags: values joined by
    underscores (missing tags become ``Unknown<Tag>``), transliterated to
    ASCII, with everything outside [A-Za-z0-9_.] replaced so the result
    is safe for every filesystem/SMB share it lands on."""
    parts = [str(dicom_tags[tag]) if tag in dicom_tags else f"Unknown{tag}"
             for tag in infos_to_include]
    return _sanitize_segment("_".join(parts))


#: tag groups forming the output directory layers, outermost first
_STUDY_LAYER = ["StudyDate", "AccessionNumber", "StudyDescription"]
_SERIES_LAYER = ["SeriesNumber", "SeriesDescription"]
_PATIENT_LAYER = ["PatientName", "PatientBirthDate"]


def get_naming_scheme(dicom_tags: dict[str, str],
                      patient_info: bool = False) -> str:
    """Output path: /<CalledAET>[/<patient>]/<study>/<series>/."""
    layers = [_STUDY_LAYER, _SERIES_LAYER]
    if patient_info:
        layers.insert(0, _PATIENT_LAYER)
    segments = [_process_info_element(dicom_tags, layer) for layer in layers]
    # the called AET is sender-controlled: sanitize it like every other
    # segment (an AET of '..' would otherwise escape the storage root)
    called = _sanitize_segment(str(dicom_tags["CalledAET"]))
    return "/" + "/".join([called, *segments]) + "/"


def collect_auth() -> tuple[str, str]:
    """Orthanc REST credentials from the environment.

    Prefers explicit ORTHANC_USERNAME/ORTHANC_PASSWORD; otherwise the
    first entry of the ORTHANC__REGISTERED_USERS dict (a JSON-ish
    ``{"user": "password"}`` string as Orthanc's config uses).
    """
    user = os.environ.get("ORTHANC_USERNAME")
    password = os.environ.get("ORTHANC_PASSWORD")
    if user is not None and password is not None:
        return user, password
    raw = os.environ.get("ORTHANC__REGISTERED_USERS")
    if raw is None:
        raise ValueError(
            "Orthanc credentials missing: set ORTHANC_USERNAME and "
            "ORTHANC_PASSWORD, or ORTHANC__REGISTERED_USERS.")
    try:
        users = json.loads(raw.replace("'", '"'))
    except json.JSONDecodeError:
        users = None
    if isinstance(users, dict) and users:
        name, pwd = next(iter(users.items()))
        return str(name), str(pwd)
    pair = re.search(r"""["']([^"']+)["']\s*:\s*["']([^"']+)["']""", raw)
    if pair is None:
        raise ValueError(
            f"could not parse credentials from "
            f"ORTHANC__REGISTERED_USERS={raw!r}")
    return pair.group(1), pair.group(2)


class OrthancSession:
    """Minimal authenticated REST client over urllib (requests-free)."""

    def __init__(self, auth: tuple[str, str] | None = None):
        self.auth = auth

    def _request(self, url: str, method: str = "GET",
                 data: bytes | None = None) -> bytes:
        req = urllib.request.Request(url, data=data, method=method)
        if self.auth:
            cred = base64.b64encode(
                f"{self.auth[0]}:{self.auth[1]}".encode()).decode()
            req.add_header("Authorization", f"Basic {cred}")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.read()

    def get_bytes(self, url: str) -> bytes:
        return self._request(url)

    def get_json(self, url: str) -> Any:
        return json.loads(self._request(url).decode())

    def delete(self, url: str) -> None:
        self._request(url, method="DELETE")


# ---------------------------------------------------------------------------
# monitoring database
# ---------------------------------------------------------------------------


def get_db_connection() -> Any | None:
    missing = [v for v in ("POSTGRES_HOST", "POSTGRES_PORT", "POSTGRES_USER",
                           "POSTGRES_PASSWORD", "POSTGRES_DATABASE")
               if v not in os.environ]
    if missing:
        logger.error(
            "All environment variables must be defined to connect to the "
            "monitoring database: %s missing.", ", ".join(missing))
        return None
    try:
        import psycopg2
    except ImportError:
        logger.error("psycopg2 is not installed; monitoring DB disabled.")
        return None
    try:
        return psycopg2.connect(
            host=os.environ["POSTGRES_HOST"],
            port=os.environ["POSTGRES_PORT"],
            user=os.environ["POSTGRES_USER"],
            password=os.environ["POSTGRES_PASSWORD"],
            database=os.environ["POSTGRES_DATABASE"])
    except Exception:
        logger.error(traceback.format_exc())
        logger.error("Failed to connect to the Postgres database.")
        return None


_IDENT_RE = re.compile(r"^[a-z_][a-z0-9_]*$")


def upsert_sql(keys: list[str]) -> str:
    """Parametrized UPSERT into boa_entries (identifiers validated)."""
    for k in keys:
        if not _IDENT_RE.match(k):
            raise ValueError(f"invalid column name {k!r}")
    update_keys = [k for k in keys if k != "task_id"]
    cols = ", ".join(keys)
    ph = ", ".join(["%s"] * len(keys))
    updates = ", ".join(f"{k} = EXCLUDED.{k}" for k in update_keys)
    return (f"INSERT INTO boa_entries ({cols}) VALUES ({ph}) "
            f"ON CONFLICT (task_id) DO UPDATE SET {updates}")


def write_to_postgres(db_conn: Any, data: dict[str, Any]) -> None:
    if db_conn is None:
        return
    if "task_id" not in data:
        raise KeyError("The task_id field must be given to update the row.")
    try:
        keys = list(data.keys())
        with db_conn.cursor() as cur:
            cur.execute(upsert_sql(keys), list(data.values()))
        db_conn.commit()
    except Exception:
        logger.exception("Failed to write monitoring information to postgres.")
        try:
            # without a rollback the connection stays in aborted-transaction
            # state and every later write on it fails too
            db_conn.rollback()
        except Exception:
            logger.exception("Rollback after failed monitoring write failed.")


# ---------------------------------------------------------------------------
# work steps
# ---------------------------------------------------------------------------


def download_dicoms_from_orthanc(session: OrthancSession, output_folder: Path,
                                 base_url: str,
                                 series_instances: list[str]) -> Path:
    from boa_tpu_torch.io import dicom

    input_data_folder = output_folder / "input_dicoms"
    input_data_folder.mkdir(parents=True, exist_ok=True)
    start = time()
    for instance_number in series_instances:
        content = session.get_bytes(
            f"{base_url}/instances/{instance_number}/file")
        try:
            ds = dicom.dcmread(content, stop_before_pixels=True)
            name = f"{ds.get('SOPInstanceUID', instance_number)}.dcm"
        except Exception:
            name = f"{instance_number}.dcm"
        (input_data_folder / name).write_bytes(content)
    logger.info("DICOM data store: DONE in %0.5fs", time() - start)
    return input_data_folder


def build_excel(input_data_folder: Path, output_folder: Path,
                dicom_tags: dict[str, Any], fast_bca: bool = False,
                fast_total: bool = False,
                analyze_fn=None) -> tuple[Path, dict[str, Any]]:
    """`analyze_ct` on the downloaded series (on the card unless `DEVICE`
    says otherwise), its workbook renamed after the series."""
    from boa_tpu_torch.commands import analyze_ct
    from boa_tpu_torch.utils.config import resolve_device, resolve_models

    analyze_fn = analyze_fn or analyze_ct
    start = time()
    excel_path, stats = analyze_fn(
        input_folder=input_data_folder,
        processed_output_folder=output_folder,
        excel_output_folder=output_folder,
        models=resolve_models(os.environ.get("PACS_MODEL"),
                              license_number=os.environ.get("LICENSE_NUMBER")),
        device=resolve_device(),
        fast_bca=fast_bca,
        fast_total=fast_total,
    )
    new_excel_path = excel_path.parent / (
        _process_info_element(dicom_tags, ["AccessionNumber", "SeriesNumber",
                                           "SeriesDescription"]) + ".xlsx")
    shutil.move(excel_path, new_excel_path)
    logger.info("Excel build: DONE in %0.5fs", time() - start)
    return new_excel_path, stats


def _sink_env_set(*names: str) -> bool:
    return all(n in os.environ and os.environ[n].upper() not in {"", "TODO"}
               for n in names)


def save_data_persistent(input_data_folder: Path, output_folder: Path,
                         new_excel_path: Path | None,
                         secondary_excel_path: str,
                         output_information: str) -> None:
    from boa_tpu_torch.io.storage import store_dicoms, store_excel

    if _sink_env_set("UPLOAD_USER", "UPLOAD_PWD", "SEGMENTATION_UPLOAD_URL"):
        try:
            store_dicoms(input_folder=input_data_folder,
                         segmentation_folder=output_folder)
        except Exception:
            logger.exception("Storing segmentation in DicomWeb failed.")
    else:
        logger.info(
            "The variables UPLOAD_USER, UPLOAD_PWD and SEGMENTATION_UPLOAD_URL "
            "are not set, the segmentations will not be uploaded.")

    with (output_folder / "debug_information.txt").open("a") as f:
        f.write(output_information)
    if _sink_env_set("SMB_USER", "SMB_PWD", "SMB_DIR_OUTPUT"):
        start = time()
        try:
            if new_excel_path is None:
                store_excel(
                    paths_to_store=[output_folder / "debug_information.txt"],
                    store_path=secondary_excel_path)
                logger.error("No excel file was generated.")
            else:
                store_excel(
                    paths_to_store=[
                        new_excel_path,
                        output_folder / "report.pdf",
                        output_folder / "preview_total.png",
                        output_folder / "preview_total.pdf",
                        output_folder / "debug_information.txt",
                    ],
                    store_path=secondary_excel_path)
        except Exception:
            traceback.print_exc()
            logger.error("Storing Excel in SMB storage failed.")
        logger.info("Storing Excel in SMB storage: DONE in %0.5fs",
                    time() - start)
    else:
        logger.info(
            "The variables SMB_USER, SMB_PWD and SMB_DIR_OUTPUT are not set, "
            "the Excel file will not be stored in SMB storage.")


def get_dicom_tags(session: OrthancSession, base_url: str,
                   resource_id: str) -> dict[str, Any]:
    series_info = session.get_json(f"{base_url}/series/{resource_id}")
    metadata = session.get_json(
        f"{base_url}/instances/{series_info['Instances'][0]}/metadata?expand")
    dicom_tags = session.get_json(
        f"{base_url}/instances/{series_info['Instances'][0]}/simplified-tags")
    useful_info: dict[str, Any] = {
        "Instances": series_info["Instances"],
        "CalledAET": metadata["CalledAET"],
    }
    for tag in ("StudyDate", "AccessionNumber", "StudyDescription",
                "SeriesNumber", "SeriesDescription", "PatientName",
                "PatientBirthDate"):
        if tag in dicom_tags:
            useful_info[tag] = dicom_tags[tag]
    return useful_info
