"""Lazy optional-import shim (counterpart of `boa_tpu/pacs/imports.py`,
upstream `scripts/imports.py`)."""

from __future__ import annotations

import importlib
from typing import Any


class _FailedImport:
    def __init__(self, msg: str):
        self._msg = msg

    def __call__(self, *a: Any, **k: Any) -> Any:
        raise ImportError(self._msg)

    def __getattr__(self, name: str) -> Any:
        raise ImportError(self._msg)


def optional_import(module: str, name: str = "") -> tuple[Any, bool]:
    """Returns (object, success). On failure the object raises on use."""
    try:
        mod = importlib.import_module(module)
        obj = getattr(mod, name) if name else mod
        return obj, True
    except Exception as exc:
        return _FailedImport(f"optional import of {module}"
                             f"{'.' + name if name else ''} failed: {exc}"), False
