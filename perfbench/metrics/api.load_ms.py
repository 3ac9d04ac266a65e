"""A study's call outside every span, ms: the input's `nifti.load` and the
API's bookkeeping (the benchmark's clock around `totalsegmentator(spans=...)`
less the program's spans), the mean over the traced studies; None where a
study lacks the API's `save_nifti` span (another entry point: the rest would
not be the load)."""

SPANS = ("body_crop", "upload+orient", "resample", "download+postprocess",
         "back_resample+pad", "load_weights", "save_nifti")


def read(art):
    spans = art.get("spans") or []
    if not spans or not all("save_nifti" in sp for sp in spans):
        return None
    rest = [sp["call_s"] - sum(v for k, v in sp.items()
                               if k in SPANS or k == "predict" or k.startswith("predict_"))
            for sp in spans]
    return 1e3 * sum(rest) / len(rest)
