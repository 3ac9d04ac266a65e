"""BCA measurements JSON -> the three BCA tables of the workbook.

Counterpart of `boa_tpu/compute/bca_metrics.py` (body_organ_analysis
`compute/bca_metrics.py:8-117`): the aggregated table walks 30 body-region
row groups (whole scan, cavities, vertebra levels C1-L5) with and without
extremities; the two per-slice tables carry one row per axial slice. The
tables are (columns, rows) with pandas' column order and None where pandas
has NaN.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

from boa_tpu_torch.io.xlsx import Table, records_table
from boa_tpu_torch.utils.misc import convert_name


#: display names of the aggregation groups, in workbook row order
BODY_REGIONS = [
    "Whole Scan", "Abdominal Cavity", "Thoracic Cavity", "Ventral Cavity",
    "Mediastinum", "Pericardium",
    "L5", "L4", "L3", "L2", "L1",
    "T12", "T11", "T10", "T9", "T8", "T7", "T6", "T5", "T4", "T3", "T2", "T1",
    "C7", "C6", "C5", "C4", "C3", "C2", "C1",
]


def change_aggregated_name(name: str) -> str:
    """Display name -> bca-measurements.json aggregation key."""
    return name.lower().replace(" ", "_").replace("-", "_")


def _tissue_label(tissue: str) -> str:
    """JSON tissue key -> workbook column (acronyms uppercased)."""
    return tissue.capitalize() if tissue in ("bone", "muscle") else tissue.upper()


def _stat_label(stat: str) -> str:
    """JSON stat key -> workbook row label with its unit suffix."""
    unit = "_HU" if "hu" in stat else "_mL"
    return stat.split("_")[0].capitalize() + unit


def _group_rows(body_part: str, table: dict[str, dict[str, Any]]) -> list[dict[str, Any]]:
    """Rows of one aggregation group: one per stat, tissue values as
    columns (the JSON stores {tissue: {stat: value}})."""
    tissues = list(table)
    stats = list(table[tissues[0]]) if tissues else []
    rows = []
    for stat in stats:
        row: dict[str, Any] = {"BodyPart": body_part, "Present": True,
                               "AggregationType": _stat_label(stat)}
        for tissue in tissues:
            row[_tissue_label(tissue)] = table[tissue].get(stat)
        rows.append(row)
    return rows


def _slice_table(slice_records: list[dict[str, Any]]) -> Table:
    columns, rows = records_table(slice_records)
    return (["SliceNumber"] + [_tissue_label(c) for c in columns],
            [[i, *row] for i, row in enumerate(rows, 1)])


def compute_bca_metrics(output_path: Path) -> tuple[Table, Table, Table]:
    """(aggregated, per-slice, per-slice without extremities) tables."""
    with (Path(output_path) / "bca-measurements.json").open() as of:
        measurements = json.load(of)

    aggregated = measurements["aggregated"]
    rows: list[dict[str, Any]] = []
    for display_name in BODY_REGIONS:
        key = change_aggregated_name(display_name)
        part_name = convert_name(key)
        if key not in aggregated:
            rows.append({"BodyPart": part_name, "Present": False})
            rows.append({"BodyPart": f"{part_name}_NoExtremities", "Present": False})
            continue
        rows += _group_rows(part_name, aggregated[key]["measurements"])
        rows += _group_rows(f"{part_name}_NoExtremities",
                            aggregated[key]["measurements_no_extremities"])

    # the leading columns first, even if the first group is absent
    columns, _ = records_table(rows)
    lead = ["BodyPart", "Present", "AggregationType"]
    columns = [c for c in lead if c in columns] + [c for c in columns if c not in lead]
    return ((columns, [[r.get(c) for c in columns] for r in rows]),
            _slice_table(measurements["slices"]),
            _slice_table(measurements["slices_no_extremities"]))
