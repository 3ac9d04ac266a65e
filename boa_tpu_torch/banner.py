"""Startup banner (counterpart of `boa_tpu/banner.py`)."""

from __future__ import annotations

import os
import sys

_BANNER = r"""
 ____   ___    _          _____ ____  _   _
| __ ) / _ \  / \        |_   _|  _ \| | | |
|  _ \| | | |/ _ \   _____ | | | |_) | | | |
| |_) | |_| / ___ \ |_____|| | |  __/| |_| |
|____/ \___/_/   \_\       |_| |_|    \___/
"""

_SUB = "Body and Organ Analysis — PyTorch / CUDA port"


def _gradient(text: str) -> str:
    """256-color horizontal gradient, teal → violet."""
    lines = text.splitlines()
    width = max((len(ln) for ln in lines), default=1)
    out = []
    for ln in lines:
        colored = []
        for i, ch in enumerate(ln):
            t = i / max(width - 1, 1)   # through the 6x6x6 color cube
            r, g, b = int(t * 4), int(5 - t * 3), 5
            colored.append(f"\x1b[38;5;{16 + 36 * r + 6 * g + b}m{ch}")
        out.append("".join(colored))
    return "\n".join(out) + "\x1b[0m"


def print_banner(file=None) -> None:
    file = file or sys.stdout
    if file.isatty() and os.environ.get("TERM", "") not in ("", "dumb"):
        print(_gradient(_BANNER), file=file)
    else:
        print(_BANNER, file=file)
    print(_SUB + "\n", file=file)
