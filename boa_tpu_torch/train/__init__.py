"""Training side of the port: so far the trainer-variant table alone
(`variants.py`); the trainer itself waits for ROADMAP M11."""

from boa_tpu_torch.train.variants import VariantSpec, get_variant  # noqa: F401
