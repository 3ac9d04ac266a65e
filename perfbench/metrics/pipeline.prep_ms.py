"""Host prep and upload of a study, ms: the program's `body_crop`,
`upload+orient` and `resample` spans (`predict_image(spans=...)`, which
synchronizes at each mark), the mean over the traced studies; None where no
study has any of them."""

KEYS = ("body_crop", "upload+orient", "resample")


def read(art):
    spans = art.get("spans") or []
    if not any(k in sp for sp in spans for k in KEYS):
        return None
    return 1e3 * sum(sum(sp.get(k, 0.0) for k in KEYS) for sp in spans) / len(spans)
