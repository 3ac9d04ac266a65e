"""The sliding window's host time per tile forward, ms: the host seconds of
the `window` spans (the predictor's `sliding_window_seg_chunked` call with
its argmax, never waited on) over the `tile_forwards` counter, over the
traced window's own spans (`boa_tpu_torch.utils.timing.last_trace()`).
Beside `window.device_ms`: where the two are close, the host sets the
window's pace."""

from boa_tpu_torch.utils import timing


def read(art):
    tr = timing.last_trace() if hasattr(timing, "last_trace") else None
    if tr is None:
        return None
    tiles = tr.total("tile_forwards")
    if not tiles or not any(s.name == "window" for s in tr.spans):
        return None
    return 1e3 * tr.host_s("window") / tiles
