"""An XLSX workbook read the plain way, with ``zipfile`` and ElementTree,
as the Office Open XML spec lays it out: ``xl/workbook.xml`` names the
sheets, its relationships give each sheet's part, and every cell sits at
the column and row of its ``r`` reference.  Numbers come back as float,
strings as str, booleans as bool, an absent cell as None."""

from __future__ import annotations

import posixpath
import re
import xml.etree.ElementTree as ET
import zipfile

MAIN = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
REL = "{http://schemas.openxmlformats.org/package/2006/relationships}"
DOC_REL = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}"
_REF = re.compile(r"([A-Z]+)(\d+)$")


def _col_index(letters: str) -> int:
    n = 0
    for ch in letters:
        n = n * 26 + (ord(ch) - 64)
    return n - 1


def _text(el) -> str:
    """The text of an ``<is>`` or ``<si>`` element, its runs joined."""
    return "".join(t.text or "" for t in el.iter(MAIN + "t"))


def _value(c, shared):
    t = c.get("t", "n")
    if t == "inlineStr":
        is_ = c.find(MAIN + "is")
        return _text(is_) if is_ is not None else ""
    v = c.find(MAIN + "v")
    if v is None or v.text is None:
        return None
    if t == "s":
        return shared[int(v.text)]
    if t == "b":
        return v.text.strip() == "1"
    if t in ("str", "e"):
        return v.text
    return float(v.text)


def _grid(root, shared) -> list:
    cells = {}
    for c in root.iter(MAIN + "c"):
        m = _REF.match(c.get("r", ""))
        if m is None:
            raise ValueError(f"a cell without a reference: {ET.tostring(c)[:80]!r}")
        cells[(int(m.group(2)) - 1, _col_index(m.group(1)))] = _value(c, shared)
    if not cells:
        return []
    n_rows = 1 + max(r for r, _ in cells)
    n_cols = 1 + max(c for _, c in cells)
    grid = [[None] * n_cols for _ in range(n_rows)]
    for (r, c), v in cells.items():
        grid[r][c] = v
    return grid


def read(path: str) -> dict:
    """{sheet name: rows}, each row a list of cell values, in sheet order."""
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        shared = []
        if "xl/sharedStrings.xml" in names:
            shared = [_text(si) for si in
                      ET.fromstring(zf.read("xl/sharedStrings.xml")).iter(MAIN + "si")]
        rels = {r.get("Id"): r.get("Target") for r in
                ET.fromstring(zf.read("xl/_rels/workbook.xml.rels")).iter(REL + "Relationship")}
        out = {}
        for sh in ET.fromstring(zf.read("xl/workbook.xml")).iter(MAIN + "sheet"):
            target = rels[sh.get(DOC_REL + "id")]
            part = target.lstrip("/") if target.startswith("/") else \
                posixpath.normpath(posixpath.join("xl", target))
            out[sh.get("name")] = _grid(ET.fromstring(zf.read(part)), shared)
    return out
