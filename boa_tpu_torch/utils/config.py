"""Environment flags, model specs and the device spec of the CLI.

Counterpart of `boa_tpu/utils/config.py` (body_organ_analysis
`compute/config.py`): boolean and string env vars where ``TODO`` or empty
mean "unset", ``+``-separated model specs with an ``all`` shortcut and
license gating. `resolve_device` differs: the port runs on CUDA, so
``gpu``, ``cuda`` and ``tpu`` all mean the card.
"""

from __future__ import annotations

import json
import logging
import os
import urllib.request

from boa_tpu_torch.utils.constants import ALL_MODELS, AVAILABLE_MODELS, LICENSE_MODELS

logger = logging.getLogger(__name__)

#: values (lowercased) that make a boolean env var True
_TRUE_WORDS = frozenset({"1", "true"})
#: values (lowercased) that leave a string env var unset
_PLACEHOLDER_WORDS = frozenset({"", "todo"})


def env_bool(name: str, default: bool = False) -> bool:
    value = os.environ.get(name)
    if value is None:
        return default
    return value.strip().lower() in _TRUE_WORDS


def env_str(name: str, default: str | None = None) -> str | None:
    value = os.environ.get(name)
    if value is None:
        return default
    value = value.strip()
    if value.lower() in _PLACEHOLDER_WORDS:
        return default
    return value


def _validate_license_online(license_number: str, backend: str) -> bool:
    """POST ``{"license_number": ..}`` to ``<backend>/is_valid_license_number``
    (5 s timeout); only an HTTP-ok answer with ``status == "valid_license"``
    accepts. Errors, timeouts and malformed bodies reject."""
    url = backend.rstrip("/") + "/is_valid_license_number"
    req = urllib.request.Request(
        url, data=json.dumps({"license_number": license_number}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read().decode())["status"] == "valid_license"
    except Exception as e:  # non-2xx raises HTTPError; plus URLError/JSON
        logger.error("License backend validation failed: %s", e)
        return False


def is_valid_license(license_number: str | None) -> bool:
    """With ``BOA_LICENSE_BACKEND`` set the key is checked against that
    backend; without it only its shape (``aca_`` prefix, 18 characters)."""
    if not license_number:
        return False
    backend = env_str("BOA_LICENSE_BACKEND")
    if backend:
        return _validate_license_online(license_number, backend)
    return license_number.startswith("aca_") and len(license_number) == 18


def _expand_bca(models: set[str]) -> set[str]:
    # the bca pipeline runs body_parts/body_regions itself and needs the
    # total segmentation for vertebra windows
    if "bca" in models:
        models = models | {"total"}
        models.discard("body_parts")
        models.discard("body_regions")
    return models


def resolve_models(
    spec: str | None, strict: bool = False,
    license_number: str | None = None,
    license_valid: bool | None = None,
) -> set[str]:
    """Turn a ``+``-separated model spec into the set of models to run.

    ``license_valid`` passes a verdict the caller already has, instead of a
    second (possibly remote) check."""
    if not spec or spec.lower() == "all":
        selected = set(ALL_MODELS)
        if (is_valid_license(license_number) if license_valid is None
                else license_valid):
            selected |= LICENSE_MODELS
        return _expand_bca(selected)

    selected = set()
    unknown = []
    for token in spec.split("+"):
        name = token.replace("-", "_")
        if name in AVAILABLE_MODELS:
            selected.add(name)
        else:
            unknown.append(name)
    if unknown:
        choices = ", ".join(sorted(AVAILABLE_MODELS))
        if strict:
            raise ValueError(
                f"unrecognized model name(s) {sorted(unknown)}; "
                f"choose from: {choices}")
        logger.error("Skipping unrecognized model name(s) %s (choose from: %s)",
                     sorted(unknown), choices)
    return _expand_bca(selected)


#: accelerator spellings that all mean the card
_ACCELERATOR_ALIASES = frozenset({"gpu", "cuda", "tpu"})


def resolve_device(device: str | None = None) -> str:
    """Normalize a device spec to ``cuda[:idx]`` or ``cpu``.

    ``gpu`` and ``tpu`` map to ``cuda`` (the rewrite is logged); the index
    comes from the spec or ``NVIDIA_ID``; with no spec, ``DEVICE`` or
    ``cuda``. Whether CUDA is there is checked where the device is used
    (`boa_tpu_torch/device.py`), which raises without it."""
    requested = device or os.environ.get("DEVICE", "cuda")
    kind, _, index = requested.partition(":")
    kind = kind.lower()
    if kind in _ACCELERATOR_ALIASES:
        if kind != "cuda":
            logger.info("Device %r requested; using CUDA.", requested)
        kind = "cuda"
    elif kind != "cpu":
        raise ValueError(f"unknown device {kind!r}")
    index = index or os.environ.get("NVIDIA_ID", "")
    return f"{kind}:{index}" if index else kind
