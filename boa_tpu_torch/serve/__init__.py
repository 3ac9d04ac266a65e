"""Serving: the pipelined study stream and the deploy-time warm-up."""

from boa_tpu_torch.serve.stream import StreamRunner, StreamStats, StudyJob  # noqa: F401
