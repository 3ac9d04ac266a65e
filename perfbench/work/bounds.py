"""The least time of a piece of work on the card: the larger of its
operations at the bf16 tensor-core peak and its compulsory bytes at the
HBM bandwidth. A frozen copy of the arithmetic of PERF.md's kernel table
("bound: compulsory bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s bf16")."""

from perfbench.work import h100


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / h100.BF16_FLOP_PER_S, nbytes / h100.HBM_BYTES_PER_S)
