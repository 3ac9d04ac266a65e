"""Model catalogue constants (counterpart of `boa_tpu/utils/constants.py`)."""

# models computed through the BCA path rather than TotalSegmentator
BASE_MODELS = {"bca", "body_regions", "body_parts"}

ALL_MODELS = {
    "bca",
    "body_parts",
    "body_regions",
    "cerebral_bleed",
    "hip_implant",
    "liver_vessels",
    "lung_vessels",
    "pleural_pericard_effusion",
    "total",
}

LICENSE_MODELS = {"heartchambers_highres"}

AVAILABLE_MODELS = ALL_MODELS | LICENSE_MODELS
