"""dcmqi-style DICOM-SEG metainfo templates, one per output kind
(counterpart of `boa_tpu/templates/`)."""
