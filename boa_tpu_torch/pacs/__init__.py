"""PACS service layer: Orthanc callback -> queue -> worker -> sinks.

Counterpart of `boa_tpu/pacs/` (upstream `scripts/`: on_change_callback.py,
celery_task.py, util.py): Orthanc's STABLE_SERIES gate enqueues a task, the
worker runs `analyze_ct` on the card and hands the results to the
DICOMweb, SMB and Postgres sinks. The queue is Celery + RabbitMQ when
configured and installed, a local thread queue otherwise.
"""
