"""Sliding window per tile forward, ms: the program's `predict` span (or the
sum of the `predict_{task id}` spans of a task of sub-models, each with its
label merge) over its `tile_forwards` count, over the traced studies; None
where the studies have no such span or count."""


def read(art):
    spans = art.get("spans") or []
    tiles = sum(sp.get("tile_forwards", 0) for sp in spans)
    t = [v for sp in spans for k, v in sp.items() if k == "predict" or k.startswith("predict_")]
    if not tiles or not t:
        return None
    return 1e3 * sum(t) / tiles
