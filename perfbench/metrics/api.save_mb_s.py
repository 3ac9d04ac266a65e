"""The write of the labels, MB/s: the voxel bytes `io/nifti.py:save`
serialises after the pad-back (the counter `save_bytes`) over the host
seconds of the `save_nifti` spans, over the traced window's own spans
(`boa_tpu_torch.utils.timing.last_trace()`)."""

from boa_tpu_torch.utils import timing


def read(art):
    tr = timing.last_trace() if hasattr(timing, "last_trace") else None
    if tr is None:
        return None
    s, b = tr.host_s("save_nifti"), tr.total("save_bytes")
    return b / 1e6 / s if s > 0 and b > 0 else None
