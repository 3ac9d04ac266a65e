"""The input's load a study, ms: the program's `load_input` span
(`python_api._load_input`: the NIfTI read) on the host clock, the mean over
the studies of the traced window, read from the window's own spans
(`boa_tpu_torch.utils.timing.last_trace()`)."""

from boa_tpu_torch.utils import timing


def read(art):
    tr = timing.last_trace() if hasattr(timing, "last_trace") else None
    if tr is None or not tr.studies() or not any(s.name == "load_input" for s in tr.spans):
        return None
    return 1e3 * tr.host_s("load_input") / tr.studies()
