"""Download, postprocessing, back-resample and pad-back of a study, ms: the
program's `download+postprocess` and `back_resample+pad` spans, the mean
over the traced studies; None where no study has either."""

KEYS = ("download+postprocess", "back_resample+pad")


def read(art):
    spans = art.get("spans") or []
    if not any(k in sp for sp in spans for k in KEYS):
        return None
    return 1e3 * sum(sum(sp.get(k, 0.0) for k in KEYS) for sp in spans) / len(spans)
