"""The label merge of a study's sub-models, ms: the time between the CUDA
events of the `merge` spans (each part's labels to the device, the class
LUT and the `torch.where` over the model grid), the mean over the studies
of the traced window, read from its own spans
(`boa_tpu_torch.utils.timing.last_trace()`)."""

from boa_tpu_torch.utils import timing


def read(art):
    tr = timing.last_trace() if hasattr(timing, "last_trace") else None
    if tr is None or not tr.studies():
        return None
    dev_s = tr.device_s("merge")
    return None if dev_s is None else 1e3 * dev_s / tr.studies()
