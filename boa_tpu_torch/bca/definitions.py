"""BCA label semantics as enums, built from the data tables.

Counterpart of `boa_tpu/bca/definitions.py`: 11 body regions, 7 body parts,
7 tissues, the HU ranges and the tissue = HU-range ∩ body-region rules.
"""

from __future__ import annotations

import enum

from boa_tpu_torch.tasks import class_maps

BodyRegion = enum.IntEnum("BodyRegion", class_maps.bca_body_regions())
BodyPart = enum.IntEnum("BodyPart", class_maps.bca_body_parts())
Tissue = enum.IntEnum("Tissue", class_maps.bca_tissues())

HU_RANGES: dict[str, tuple[float, float]] = class_maps.bca_hu_ranges()

# [(tissue, (hu_lo, hu_hi), region)]
TISSUE_RULES: list[tuple[Tissue, tuple[float, float], BodyRegion]] = [
    (Tissue[r["tissue"]], HU_RANGES[r["hu_range"]], BodyRegion[r["region"]])
    for r in class_maps.bca_tissue_rules()
]

ADIPOSE_TISSUES = (Tissue.IMAT, Tissue.SAT, Tissue.VAT, Tissue.PAT, Tissue.EAT)
