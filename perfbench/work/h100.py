"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

BF16_FLOP_PER_S = 989e12     # dense bf16 / fp16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth
