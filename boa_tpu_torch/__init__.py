"""boa_tpu_torch: the PyTorch / CUDA port of boa_tpu for NVIDIA Hopper.

The JAX package `boa_tpu` is the reference; this package imports none of it
and no JAX. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

__all__ = [
    "__version__",
    "analyze_ct",
    "store_dicoms",
    "store_excel",
    "totalsegmentator",
]

from boa_tpu_torch.version import __version__


def __getattr__(name):  # lazy imports keep `import boa_tpu_torch` free of torch
    if name == "analyze_ct":
        from boa_tpu_torch.commands import analyze_ct

        return analyze_ct
    if name in ("store_excel", "store_dicoms"):
        from boa_tpu_torch.io import storage

        return getattr(storage, name)
    if name == "totalsegmentator":
        from boa_tpu_torch.python_api import totalsegmentator

        return totalsegmentator
    raise AttributeError(f"module 'boa_tpu_torch' has no attribute {name!r}")
