"""Model catalogue constants (counterpart of `boa_tpu/utils/constants.py`)."""

# models computed through the BCA path rather than TotalSegmentator
BASE_MODELS = {"bca", "body_regions", "body_parts"}
