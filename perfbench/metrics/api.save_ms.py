"""The write of `total.nii.gz` (gzip level 1, slice by slice) a study, ms: the
API's `save_nifti` span (`totalsegmentator(spans=...)`), the mean over the
traced studies; None where no study has the span."""


def read(art):
    spans = art.get("spans") or []
    if not any("save_nifti" in sp for sp in spans):
        return None
    return 1e3 * sum(sp.get("save_nifti", 0.0) for sp in spans) / len(spans)
