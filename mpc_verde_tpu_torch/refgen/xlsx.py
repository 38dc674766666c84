"""Minimal stdlib xlsx reader AND writer (zipfile + ElementTree); the
port's own copy of ``mpc_verde_tpu.refgen.xlsx``, so that either package
reads what the other writes.

The reference commits its IPOPT/MATLAB golden trajectories as xlsx
(``Casadi/1/2/3exemplo.xlsx`` written at ``multiple_shooting_casadi.py:334``,
``single_shooting_v2.py:301``, ``mpctools/multiple_shooting_mpctools.py:150``;
``Inverted_pendulum/Pend_data.xlsx`` read by ``ploting.py``) and exports new
runs the same way (``single_shooting_v2.py:292-301``, ``Phiref.py:379-381``).
A tiny reader, needing no openpyxl, handles the subset those files use —
one sheet, inline or shared strings, numeric cells — and ``write_xlsx``
emits the same subset (header row as inline strings, numeric data cells) so
exports round-trip through ``read_xlsx`` and open in Excel/pandas.
"""
from __future__ import annotations

import re
import zipfile
import xml.etree.ElementTree as ET

import numpy as np

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _col_index(ref: str) -> int:
    """'B12' -> column index 1."""
    m = re.match(r"([A-Z]+)", ref)
    idx = 0
    for ch in m.group(1):
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_xlsx(path: str, sheet: str = "xl/worksheets/sheet1.xml"):
    """Read the first worksheet into a dict of column-name -> float array.

    Row 1 is the header; non-numeric data cells become NaN.  A leading
    unnamed index column (pandas ``to_excel`` default) is kept under ``""``.
    """
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.iter(f"{_NS}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        root = ET.fromstring(z.read(sheet))
        rows = []
        for row in root.iter(f"{_NS}row"):
            cells = {}
            for c in row.iter(f"{_NS}c"):
                ref = c.get("r", "A1")
                t = c.get("t", "n")
                if t == "inlineStr":
                    txt = "".join(tt.text or "" for tt in c.iter(f"{_NS}t"))
                    cells[_col_index(ref)] = txt
                else:
                    v = c.find(f"{_NS}v")
                    if v is None or v.text is None:
                        continue
                    if t == "s":
                        cells[_col_index(ref)] = shared[int(v.text)]
                    else:
                        cells[_col_index(ref)] = v.text
            rows.append(cells)

    if not rows:
        return {}
    header_row = rows[0]
    ncol = max(max(r.keys(), default=0) for r in rows) + 1
    names = [str(header_row.get(i, "")) for i in range(ncol)]
    out = {}
    for i, name in enumerate(names):
        vals = []
        for r in rows[1:]:
            v = r.get(i, None)
            try:
                vals.append(float(v))
            except (TypeError, ValueError):
                vals.append(np.nan)
        out[name] = np.asarray(vals)
    return out


def _col_name(idx: int) -> str:
    """0 -> 'A', 27 -> 'AB' (inverse of ``_col_index``)."""
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;"))


def write_xlsx(path: str, columns: dict, index: bool = True):
    """Write ``columns`` (name -> 1-D array) as a one-sheet xlsx.

    ``index=True`` prepends an unnamed 0..n-1 index column, matching the
    pandas ``to_excel`` default shape of the reference's committed goldens
    (``Casadi/single_shooting_v2.py:292-301`` / ``Phiref.py:379-381``) —
    ``read_xlsx`` surfaces it under the ``""`` key.  Header cells are inline
    strings; data cells numeric.  NaN becomes an empty cell (read back as
    NaN, like the reference's pandas round-trip).
    """
    names = list(columns.keys())
    cols = []
    for k in names:
        try:
            cols.append(np.asarray(columns[k], dtype=float).ravel())
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"write_xlsx supports numeric columns only; column {k!r} "
                "is not convertible to float (read_xlsx can read string "
                "cells, but the writer does not emit them)") from e
    n = max((len(c) for c in cols), default=0)
    if index:
        names = [""] + names
        cols = [np.arange(n, dtype=float)] + cols

    parts = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>']
    cells = "".join(
        f'<c r="{_col_name(j)}1" t="inlineStr"><is><t>{_esc(str(name))}</t>'
        f"</is></c>" for j, name in enumerate(names))
    parts.append(f'<row r="1">{cells}</row>')
    for i in range(n):
        cells = []
        for j, col in enumerate(cols):
            if i >= len(col) or not np.isfinite(col[i]):
                continue
            v = col[i]
            # int repr only within exact-f64 range: 1e300.is_integer() is
            # True but a 301-digit integer cell breaks some xlsx consumers
            txt = (repr(int(v))
                   if float(v).is_integer() and abs(v) < 2.0 ** 53
                   else repr(float(v)))
            cells.append(f'<c r="{_col_name(j)}{i + 2}"><v>{txt}</v></c>')
        parts.append(f'<row r="{i + 2}">{"".join(cells)}</row>')
    parts.append("</sheetData></worksheet>")
    sheet = "".join(parts)

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return path
