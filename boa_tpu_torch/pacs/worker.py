"""PACS worker: the `analyze_stable_series` task and its queue.

Counterpart of `boa_tpu/pacs/worker.py` (upstream `scripts/celery_task.py`):
the same task body (tags -> Postgres row -> download -> analyze_ct on the
card -> sinks -> Postgres stats -> delete the series), the same reliability
settings (acks-late, prefetch 1, one task per child against memory leaks,
`celery_task.py:78-95`) and the same liveness and readiness files. The queue
is Celery + RabbitMQ when `CELERY_BROKER` is set and celery is installed,
otherwise a local thread queue with the same `.delay()` API, so the Orthanc
callback is the same either way.
"""

from __future__ import annotations

import logging
import os
import queue as _queue
import tempfile
import threading
import traceback
import uuid
from datetime import datetime, timezone
from pathlib import Path
from time import time
from typing import Any, Callable

from boa_tpu_torch.pacs.util import (OrthancSession, build_excel, collect_auth,
                               download_dicoms_from_orthanc,
                               get_db_connection, get_dicom_tags,
                               get_naming_scheme, save_data_persistent,
                               write_to_postgres)
from boa_tpu_torch.utils.config import env_bool

logger = logging.getLogger(__name__)

_TMP = Path(tempfile.gettempdir())
HEARTBEAT_FILE = _TMP / "worker_heartbeat"
READINESS_FILE = _TMP / "worker_ready"


class _AsyncResult:
    def __init__(self, task_id: str):
        self.id = task_id

    def __str__(self) -> str:
        return self.id


class LocalQueue:
    """Celery-compatible single-worker queue on a thread (no broker).

    Mirrors the reference's reliability posture: one task at a time
    (prefetch 1 ≙ queue consumed serially), heartbeat file updated by a
    timer thread, readiness file on start.
    """

    def __init__(self) -> None:
        self._q: _queue.Queue = _queue.Queue()
        self._worker: threading.Thread | None = None
        self._beat: threading.Thread | None = None
        self._stop = threading.Event()

    def start(self) -> None:
        if self._worker:
            return
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._beat = threading.Thread(target=self._heartbeat, daemon=True)
        self._beat.start()
        READINESS_FILE.touch()

    def stop(self) -> None:
        self._stop.set()
        READINESS_FILE.unlink(missing_ok=True)
        HEARTBEAT_FILE.unlink(missing_ok=True)

    def _heartbeat(self) -> None:
        while not self._stop.is_set():
            HEARTBEAT_FILE.touch()
            self._stop.wait(1.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                fn, task_id, args, kwargs = self._q.get(timeout=0.5)
            except _queue.Empty:
                continue
            try:
                fn(*args, __task_id=task_id, **kwargs)
            except Exception:
                logger.exception("Task %s failed", task_id)
            finally:
                self._q.task_done()  # ack AFTER completion (acks-late)

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> _AsyncResult:
        task_id = str(uuid.uuid4())
        self.start()
        self._q.put((fn, task_id, args, kwargs))
        return _AsyncResult(task_id)

    def join(self) -> None:
        self._q.join()


_local_queue = LocalQueue()
_celery_app = None
_celery_task = None


def get_celery_app():
    """Celery app with the reference's reliability conf, if available.

    The task is registered on the app HERE (once), so both the publisher
    (`analyze_stable_series.delay`) and a consumer started with
    ``celery -A boa_tpu_torch.pacs.worker worker`` speak the same registry —
    a task object created only inside delay() would publish messages no
    worker knows how to run."""
    global _celery_app, _celery_task
    if _celery_app is not None:
        return _celery_app
    broker = os.environ.get("CELERY_BROKER")
    if not broker:
        return None
    try:
        from celery import Celery
    except ImportError:
        logger.warning("CELERY_BROKER set but celery not installed; "
                       "falling back to the local queue")
        return None
    app = Celery(broker=broker)
    app.conf.update(
        task_acks_late=True,
        worker_prefetch_multiplier=1,
        broker_pool_limit=0,
        task_publish_retry=True,
        task_publish_retry_policy={"max_retries": 5},
        worker_max_tasks_per_child=1,  # memory-leak containment
    )
    _celery_task = app.task(run_analyze_stable_series,
                            name="analyze_stable_series")
    _celery_app = app
    return app


def __getattr__(name: str):
    """`celery -A boa_tpu_torch.pacs.worker worker` resolves the app lazily
    (CELERY_BROKER is read at lookup time, not import time)."""
    if name in ("celery", "celery_app"):
        app = get_celery_app()
        if app is None:
            raise AttributeError(
                "CELERY_BROKER is not configured; no celery app available")
        return app
    raise AttributeError(name)


def _utcnow() -> str:
    return datetime.now(timezone.utc).strftime("%Y-%m-%d %H:%M:%S")


def run_analyze_stable_series(resource_id: str, *, __task_id: str | None = None,
                              analyze_fn=None,
                              storage_root: str | Path | None = None
                              ) -> dict[str, Any]:
    """The task body (`celery_task.py:100-254`)."""
    task_id = __task_id or str(uuid.uuid4())
    patient_info = env_bool("PATIENT_INFO_IN_OUTPUT", False)
    if patient_info:
        logger.warning(
            "CAREFUL: You have selected the PATIENT_INFO_IN_OUTPUT option: "
            "results will be stored using patient name and study dates.")
    session = OrthancSession(auth=collect_auth())
    base_url = f"{os.environ['ORTHANC_URL']}:{os.environ['ORTHANC_PORT']}"

    storage_root = Path(storage_root or "/storage_directory")
    if not storage_root.exists():
        # the actual sinks need the FULL credential triplets
        # (util.py save_data_persistent) — a lone SMB_DIR_OUTPUT would
        # pass this guard and then silently discard every output
        from boa_tpu_torch.pacs.util import _sink_env_set

        smb = _sink_env_set("SMB_USER", "SMB_PWD", "SMB_DIR_OUTPUT")
        web = _sink_env_set("UPLOAD_USER", "UPLOAD_PWD",
                            "SEGMENTATION_UPLOAD_URL")
        if not smb and not web:
            raise ValueError(
                "The local directory does not exist and the SMB storage and "
                "the DicomWeb instance have not been specified. You will not "
                "be able to retrieve any of the results.")
        if not smb:
            logger.warning("No SMB storage specified; Excel results will not "
                           "be retrievable.")
        if not web:
            logger.warning("No DicomWeb link specified; segmentation results "
                           "will not be retrievable.")
        output_root = None
    else:
        output_root = storage_root

    initial_dict: dict[str, Any] = {"task_id": task_id,
                                    "start_timestamp": _utcnow()}
    try:
        dicom_tags = get_dicom_tags(session=session, base_url=base_url,
                                    resource_id=resource_id)
    except Exception:
        traceback.print_exc()
        logger.error("Could not retrieve DICOM tags.")
        dicom_tags = {}

    for key in ("study_description", "accession_number", "series_description"):
        tag = key.replace("_", " ").title().replace(" ", "")
        if tag in dicom_tags:
            initial_dict[key] = dicom_tags[tag]

    db_conn = get_db_connection()
    if len(dicom_tags) == 0:
        initial_dict["end_timestamp"] = _utcnow()
        initial_dict["computed"] = False
        write_to_postgres(db_conn, initial_dict)
        if db_conn is not None:
            db_conn.close()
        return {"outputs": None}
    write_to_postgres(db_conn, data=initial_dict)

    secondary_excel_path = get_naming_scheme(dicom_tags, patient_info)
    logger.info("The target directory is %s.", secondary_excel_path)

    output_information = ""
    computed = False
    stats: dict[str, Any] = {}
    new_excel_path: Path | None = None
    with tempfile.TemporaryDirectory(prefix="boa_") as working_dir:
        if output_root is not None:
            output_folder = output_root / secondary_excel_path[1:]
            output_folder.mkdir(parents=True, exist_ok=True)
        else:
            output_folder = Path(working_dir)
        download_start = time()
        input_data_folder = download_dicoms_from_orthanc(
            session=session, output_folder=output_folder, base_url=base_url,
            series_instances=dicom_tags["Instances"])
        download_time = time() - download_start
        if not list(input_data_folder.glob("*.dcm")):
            output_information += \
                "No DICOMs could be downloaded for this series.\n\n"
        try:
            new_excel_path, stats = build_excel(
                input_data_folder=input_data_folder,
                output_folder=output_folder,
                dicom_tags=dicom_tags,
                fast_bca=env_bool("FAST_BCA", False),
                fast_total=env_bool("FAST_TOTAL", False),
                analyze_fn=analyze_fn)
            computed = True
        except Exception:
            output_information += (
                f"BOA analysis failed:\n{traceback.format_exc()}\n\n")
            logger.error("BOA analysis failed")
            traceback.print_exc()

        save_start = time()
        save_data_persistent(
            input_data_folder=input_data_folder,
            output_folder=output_folder,
            new_excel_path=new_excel_path,
            secondary_excel_path=secondary_excel_path,
            output_information=output_information)
        stats = dict(stats)
        stats.update(task_id=task_id, computed=computed,
                     download_time=download_time,
                     save_persistent_time=time() - save_start,
                     end_timestamp=_utcnow())
        write_to_postgres(db_conn, data=stats)
        if db_conn is not None:
            db_conn.close()

    if env_bool("DELETE_SERIES_FROM_ORTHANC", True):
        try:
            session.delete(f"{base_url}/series/{resource_id}")
        except Exception:
            logger.warning("Failed to delete series %s from Orthanc",
                           resource_id)
    return {"outputs": str(new_excel_path) if new_excel_path else None,
            "computed": computed}


class _TaskHandle:
    """`analyze_stable_series.delay(resource_id=...)` — celery or local."""

    def delay(self, resource_id: str) -> _AsyncResult:
        if get_celery_app() is not None:
            return _celery_task.delay(resource_id)
        return _local_queue.submit(run_analyze_stable_series, resource_id)


analyze_stable_series = _TaskHandle()
