"""Training side of the port: losses, optimizers, the case store and its
loader, augmentation on the device, the trainer and its entry point
(`run_training.py`), cascade staging, and the trainer-variant table."""

from boa_tpu_torch.train.variants import VariantSpec, apply_variant, get_variant  # noqa: F401
