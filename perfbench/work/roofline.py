"""Roofline share of row-conv kernels in a traced window: the least time of
the layers their launches computed (`work/bounds.py` on the family's counts,
`nets/<family>.py:layers`, at the configuration's tile), over their device
time in the trace (`work/rowconv.py`'s name table)."""

from perfbench.work import bounds, rowconv


def share(art, kernels) -> float | None:
    tr, launches = art.get("trace"), art.get("launches") or {}
    if not tr or launches.get("conv3d_in_act", 0):
        return None   # the fused forward shares K1's kernel names
    cfg = art["config"]
    net, patch = cfg["network"], cfg["patch_size"]
    n_st = len(net["features_per_stage"])
    layers = {m["task_id"]: {x["name"]: x for x in art["family"].layers(
        net, patch, int(m["num_classes"]))} for m in cfg["models"]}
    least = device = 0.0
    for k in kernels:
        spec = rowconv.KERNELS[k]
        names = rowconv.layer_names(k, n_st)
        per_launch = sum(bounds.least_seconds(x[n]["flops"], x[n]["bytes"])
                         for x in layers.values() for n in names) / (len(names) * len(layers))
        least += per_launch * launches.get(spec["launches"], 0)
        device += sum(s for name, s in tr["kernel_s"].items()
                      if any(d in name for d in spec["device_names"]))
    return 100.0 * least / device if device > 0 and least > 0 else None
