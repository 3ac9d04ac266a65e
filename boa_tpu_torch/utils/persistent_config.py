"""Persistent per-install JSON config.

Counterpart of `boa_tpu/utils/persistent_config.py` (TotalSegmentator
`config.py:54-104`): ``$BOA_TPU_CONFIG_DIR/config.json`` (default
``~/.boa_tpu``) holds a random install id, the prediction counter and the
license number, in the same layout, so that either package reads the
other's file. There is no telemetry.
"""

from __future__ import annotations

import json
import os
import random
import string
from pathlib import Path
from typing import Any

from boa_tpu_torch.utils.config import is_valid_license


def config_dir() -> Path:
    override = os.environ.get("BOA_TPU_CONFIG_DIR")
    return Path(override) if override else Path.home() / ".boa_tpu"


def config_path() -> Path:
    return config_dir() / "config.json"


def setup_config() -> dict[str, Any]:
    """Create or load the install config."""
    p = config_path()
    if p.exists():
        try:
            return json.loads(p.read_text())
        except json.JSONDecodeError:
            pass
    cfg = {
        "boa_tpu_id": "boa_" + "".join(random.choices(
            string.ascii_lowercase + string.digits, k=8)),
        "prediction_counter": 0,
        "license_number": "",
    }
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(cfg, indent=2))
    return cfg


def get_config_key(key: str) -> Any:
    return setup_config().get(key)


def set_config_key(key: str, value: Any) -> None:
    cfg = setup_config()
    cfg[key] = value
    config_path().write_text(json.dumps(cfg, indent=2))


def set_license_number(license_number: str, skip_validation: bool = False) -> None:
    if not skip_validation and not is_valid_license(license_number):
        raise ValueError(f"Invalid license number: {license_number}")
    set_config_key("license_number", license_number)


def get_license_number() -> str:
    return str(get_config_key("license_number") or "")


def increase_prediction_counter() -> int:
    """Add one prediction; concurrent runs race, the last writer wins (as
    in the reference)."""
    cfg = setup_config()
    cfg["prediction_counter"] = int(cfg.get("prediction_counter", 0)) + 1
    config_path().write_text(json.dumps(cfg, indent=2))
    return cfg["prediction_counter"]
