"""Device resolution shared by every entry point of the port.

The card is the default: ``device=None`` means ``"cuda"``, and asking for
CUDA on a machine without it raises instead of falling back to the CPU. Only
an explicit ``device="cpu"`` runs on the host (the tests do so).

Resolving a CUDA device also pins the float32 precision of the library
calls the port makes: ``torch.backends.cudnn.allow_tf32 = False`` (cuDNN
would otherwise run the interior float32 convolutions in TF32, about three
decimal digits) and ``torch.backends.cuda.matmul.allow_tf32 = False`` (the
resample contractions and the 1x1 head). The float32 path is held to the
reference at 1e-4 and needs both; the bf16 path is unaffected.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: boa_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run on the host")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def named_device(device: str) -> torch.device:
    """The torch device of a user-facing device name: "gpu", "cuda",
    "gpu:N" and "cuda:N" are the card (RuntimeError without CUDA), "cpu"
    the host; anything else raises ValueError."""
    name = str(device)
    kind, _, index = name.partition(":")
    if kind not in ("gpu", "cuda", "cpu") or (index and (kind == "cpu"
                                                         or not index.isdigit())):
        raise ValueError(f"unsupported device {device!r}: use 'gpu', 'gpu:N' or 'cpu'")
    return resolve_device("cpu" if kind == "cpu" else "cuda" + (f":{index}" if index else ""))
