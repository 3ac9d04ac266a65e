"""The whole network's share of the bf16 peak over the traced window: the
family's operations per tile forward (`nets/<family>.py:layers`, the mean
over the configuration's models) times the tile forwards of the traced
studies, over the window's seconds times 989 TFLOP/s. It bounds any gain a
later change claims once a kernel leaves the path."""

from perfbench.work import h100


def read(art):
    tr, spans = art.get("trace"), art.get("spans") or []
    tiles = sum(sp.get("tile_forwards", 0) for sp in spans)
    if not tr or not tiles:
        return None
    cfg = art["config"]
    per_tile = sum(sum(x["flops"] for x in art["family"].layers(
        cfg["network"], cfg["patch_size"], int(m["num_classes"])))
        for m in cfg["models"]) / len(cfg["models"])
    return 100.0 * per_tile * tiles / (tr["window_s"] * h100.BF16_FLOP_PER_S)
