"""The sliding window's device time per tile forward, ms: the time between
the CUDA events at the entry and exit of the `window` spans (the
predictor's `sliding_window_seg_chunked` call with its argmax) over the
`tile_forwards` counter, over the traced window's own spans
(`boa_tpu_torch.utils.timing.last_trace()`)."""

from boa_tpu_torch.utils import timing


def read(art):
    tr = timing.last_trace() if hasattr(timing, "last_trace") else None
    if tr is None:
        return None
    tiles, dev_s = tr.total("tile_forwards"), tr.device_s("window")
    return 1e3 * dev_s / tiles if tiles and dev_s is not None else None
