"""boa_tpu_torch: the PyTorch / CUDA port of boa_tpu for NVIDIA Hopper.

The JAX package `boa_tpu` is the reference; this package imports none of it
and no JAX. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
