"""Minimal XLSX writer and reader, without pandas or any spreadsheet package.

Counterpart of `boa_tpu/io/xlsx.py`: the OOXML SpreadsheetML subset that
BOA's `output.xlsx` needs (several sheets, shared strings, number, string
and bool cells, a bold and a bold + fill + wrapped format, horizontal
merges). The writer gives the reference's package parts byte for byte for
the same cells. Tables are plain column and row lists: `add_table` takes
what `DataFrame.to_excel` took, `records_table` builds one from a list of
dicts as `pandas.DataFrame(records)` does, and `read_xlsx_sheet_table`
reads one back.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterable
from xml.sax.saxutils import escape

import numpy as np

_CT = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheets}
<Override PartName="/xl/styles.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.styles+xml"/>
<Override PartName="/xl/sharedStrings.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sharedStrings+xml"/>
</Types>"""

_STYLES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<styleSheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">
<fonts count="2"><font><sz val="11"/><name val="Calibri"/></font>
<font><b/><sz val="11"/><name val="Calibri"/></font></fonts>
<fills count="3"><fill><patternFill patternType="none"/></fill>
<fill><patternFill patternType="gray125"/></fill>
<fill><patternFill patternType="solid"><fgColor rgb="FFFFF2CC"/><bgColor indexed="64"/></patternFill></fill></fills>
<borders count="1"><border/></borders>
<cellStyleXfs count="1"><xf/></cellStyleXfs>
<cellXfs count="3"><xf xfId="0"/>
<xf fontId="1" xfId="0" applyFont="1"/>
<xf fontId="1" fillId="2" xfId="0" applyFont="1" applyFill="1" applyAlignment="1">
<alignment horizontal="center" wrapText="1"/></xf></cellXfs>
</styleSheet>"""

#: a table of the workbook: (column names, rows of cell values)
Table = tuple[list[str], list[list[Any]]]

FMT_NONE = 0
FMT_BOLD = 1
FMT_WARNING = 2  # bold, #FFF2CC fill, centered, wrapped — the cnr banner


def _col_name(idx: int) -> str:
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


@dataclass
class Sheet:
    name: str
    rows: list[list[tuple[Any, int]]] = field(default_factory=list)  # (value, fmt)
    merges: list[str] = field(default_factory=list)

    def add_row(self, values, fmt: int = FMT_NONE) -> None:
        self.rows.append([(v, fmt) for v in values])

    def merge_row(self, row: int, col_start: int, col_end: int) -> None:
        self.merges.append(
            f"{_col_name(col_start)}{row + 1}:{_col_name(col_end)}{row + 1}")


class Workbook:
    def __init__(self) -> None:
        self.sheets: list[Sheet] = []

    def add_sheet(self, name: str) -> Sheet:
        s = Sheet(name=name)
        self.sheets.append(s)
        return s

    def add_table(self, columns: list, rows: Iterable[list], name: str,
                  startrow: int = 0) -> Sheet:
        """A new sheet with `startrow` empty rows, a bold header row of the
        column names and one row per entry of `rows` (None, NaN and ±inf as
        empty cells): the reference's `add_dataframe` without the index."""
        s = self.add_sheet(name)
        for _ in range(startrow):
            s.add_row([])
        s.add_row([str(c) for c in columns], FMT_BOLD)
        for row in rows:
            s.add_row(row)
        return s

    # ------------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        strings: dict[str, int] = {}

        def sref(sv: str) -> int:
            return strings.setdefault(sv, len(strings))

        sheet_xmls = []
        for sheet in self.sheets:
            rows_xml = []
            for r, row in enumerate(sheet.rows):
                cells = []
                for c, (v, fmt) in enumerate(row):
                    ref = f"{_col_name(c)}{r + 1}"
                    style = f' s="{fmt}"' if fmt else ""
                    if v is None or (isinstance(v, (float, np.floating))
                                     and not np.isfinite(v)):
                        # NaN AND ±inf (np.floating included): a literal
                        # <v>inf</v> makes Excel call the workbook corrupt
                        if fmt:
                            cells.append(f'<c r="{ref}"{style}/>')
                        continue
                    if isinstance(v, (bool, np.bool_)):
                        cells.append(
                            f'<c r="{ref}"{style} t="b"><v>{int(v)}</v></c>')
                    elif isinstance(v, (int, np.integer)):
                        cells.append(f'<c r="{ref}"{style}><v>{int(v)}</v></c>')
                    elif isinstance(v, (float, np.floating)):
                        cells.append(
                            f'<c r="{ref}"{style}><v>{float(v)!r}</v></c>')
                    else:
                        cells.append(f'<c r="{ref}"{style} t="s">'
                                     f"<v>{sref(str(v))}</v></c>")
                rows_xml.append(f'<row r="{r + 1}">' + "".join(cells) + "</row>")
            merge = ""
            if sheet.merges:
                merge = (f'<mergeCells count="{len(sheet.merges)}">'
                         + "".join(f'<mergeCell ref="{m}"/>' for m in sheet.merges)
                         + "</mergeCells>")
            sheet_xmls.append(
                '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                '<worksheet xmlns="http://schemas.openxmlformats.org/'
                'spreadsheetml/2006/main"><sheetData>'
                + "".join(rows_xml) + "</sheetData>" + merge + "</worksheet>")

        sst = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
               f'<sst xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
               f'count="{len(strings)}" uniqueCount="{len(strings)}">'
               + "".join(f"<si><t xml:space=\"preserve\">{escape(sv)}</t></si>"
                         for sv in strings)
               + "</sst>")

        wb_sheets = "".join(
            f'<sheet name="{escape(s.name)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
            for i, s in enumerate(self.sheets))
        workbook = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                    '<workbook xmlns="http://schemas.openxmlformats.org/'
                    'spreadsheetml/2006/main" xmlns:r="http://schemas.'
                    'openxmlformats.org/officeDocument/2006/relationships">'
                    f"<sheets>{wb_sheets}</sheets></workbook>")
        n = len(self.sheets)
        wb_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                   '<Relationships xmlns="http://schemas.openxmlformats.org/'
                   'package/2006/relationships">'
                   + "".join(
                       f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
                       f'openxmlformats.org/officeDocument/2006/relationships/'
                       f'worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
                       for i in range(n))
                   + f'<Relationship Id="rId{n + 1}" Type="http://schemas.'
                     'openxmlformats.org/officeDocument/2006/relationships/'
                     'styles" Target="styles.xml"/>'
                   + f'<Relationship Id="rId{n + 2}" Type="http://schemas.'
                     'openxmlformats.org/officeDocument/2006/relationships/'
                     'sharedStrings" Target="sharedStrings.xml"/>'
                   + "</Relationships>")
        root_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                     '<Relationships xmlns="http://schemas.openxmlformats.org/'
                     'package/2006/relationships"><Relationship Id="rId1" '
                     'Type="http://schemas.openxmlformats.org/officeDocument/'
                     '2006/relationships/officeDocument" '
                     'Target="xl/workbook.xml"/></Relationships>')
        ct = _CT.format(sheets="".join(
            f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
            f'ContentType="application/vnd.openxmlformats-officedocument.'
            f'spreadsheetml.worksheet+xml"/>' for i in range(n)))

        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", ct)
            z.writestr("_rels/.rels", root_rels)
            z.writestr("xl/workbook.xml", workbook)
            z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
            z.writestr("xl/styles.xml", _STYLES)
            z.writestr("xl/sharedStrings.xml", sst)
            for i, xml in enumerate(sheet_xmls):
                z.writestr(f"xl/worksheets/sheet{i + 1}.xml", xml)


# ---------------------------------------------------------------------------
# reader (tests / downstream consumers without openpyxl)
# ---------------------------------------------------------------------------


def read_xlsx(path: str | Path) -> dict[str, list[list[Any]]]:
    """Read back a (simple) xlsx into {sheet_name: rows of python values}."""
    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
          "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships"}
    with zipfile.ZipFile(path) as z:
        shared: list[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", ns):
                shared.append("".join(t.text or "" for t in si.iter(
                    "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}t")))
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        rels = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        rel_map = {rel.get("Id"): rel.get("Target")
                   for rel in rels.iter("{http://schemas.openxmlformats.org/"
                                        "package/2006/relationships}Relationship")}
        out: dict[str, list[list[Any]]] = {}
        for sh in wb.find("m:sheets", ns):
            name = sh.get("name")
            target = rel_map[sh.get(f"{{{ns['r']}}}id")]
            root = ET.fromstring(z.read("xl/" + target.lstrip("/")))
            rows: list[list[Any]] = []
            for row in root.iter(
                    "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}row"):
                r: list[Any] = []
                for c in row:
                    ref = c.get("r")
                    col = 0
                    for ch in re.match(r"([A-Z]+)", ref).group(1):
                        col = col * 26 + ord(ch) - 64
                    col -= 1
                    while len(r) < col:
                        r.append(None)
                    v = c.find("m:v", ns)
                    if v is None:
                        r.append(None)
                    elif c.get("t") == "s":
                        r.append(shared[int(v.text)])
                    elif c.get("t") == "b":
                        r.append(bool(int(v.text)))
                    else:
                        val = float(v.text)
                        r.append(int(val) if val.is_integer() else val)
                rows.append(r)
            out[name] = rows
    return out


def read_xlsx_sheet_table(path: str | Path, sheet: str, header_row: int = 0) -> Table:
    """(columns, rows) of a sheet with the given row as header, each row
    padded with None to the header's width (`pd.read_excel`'s shape)."""
    rows = read_xlsx(path)[sheet]
    header = rows[header_row]
    width = len(header)
    return header, [r + [None] * (width - len(r)) for r in rows[header_row + 1:]]


def records_table(records: Iterable[dict[str, Any]]) -> Table:
    """(columns, rows) of a list of dicts, as `pandas.DataFrame(records)`
    lays it out: columns in the order they first appear, None where a
    record lacks one."""
    records = list(records)
    columns = list(dict.fromkeys(k for rec in records for k in rec))
    return columns, [[rec.get(c) for c in columns] for rec in records]
