"""Share of the traced window in which no kernel, copy or fill ran on the
device (profiler trace)."""


def read(art):
    tr = art.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
