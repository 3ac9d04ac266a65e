"""Studies completed per hour: every study the window finished over the
whole window (the backlog's first load to its last write), on the host
clock."""


def read(art):
    w = art["window"]
    return 3600.0 * w["done"] / w["run_s"] if w["done"] else None
