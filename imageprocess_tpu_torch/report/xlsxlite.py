"""Self-contained XLSX writer and reader (the port's copy; no openpyxl).

Writes the minimal Office Open XML SpreadsheetML package: workbook,
worksheets with inline strings, relationships, content types.  Multiple
sheets, str / int / float / bool cells, NaN -> blank; Excel, LibreOffice
and pandas read the files back.  ``read_xlsx`` reads inline and shared
strings, booleans and numbers.
"""

from __future__ import annotations

import math
import os
import re
import zipfile
from typing import Dict, Iterable, List, Sequence

import numpy as np

_XML_ESCAPES = {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;"}
# XML 1.0 forbids control chars other than \t \n \r — one stray \x08 in a
# cell string would make the whole workbook unreadable
_XML_BAD = re.compile(r'[&<>"]|[\x00-\x08\x0b\x0c\x0e-\x1f]')


def _esc(s: str) -> str:
    return _XML_BAD.sub(lambda m: _XML_ESCAPES.get(m.group(0), ""), s)


# 0-based column index -> A, B, ..., AA, ...; precomputed far beyond any
# sheet this library writes (mutation-free: a check-then-append memo could
# corrupt refs under concurrent write_xlsx calls)
def _make_col_refs(n: int) -> List[str]:
    refs = []
    for i in range(1, n + 1):
        ref = ""
        while i:
            i, rem = divmod(i - 1, 26)
            ref = chr(ord("A") + rem) + ref
        refs.append(ref)
    return refs


_COL_REFS = _make_col_refs(1024)


def _col_ref(idx: int) -> str:
    if idx < len(_COL_REFS):
        return _COL_REFS[idx]
    return _make_col_refs(idx + 1)[idx]


def _needs_preserve(s: str) -> bool:
    # Excel trims inline-string whitespace on load unless told to preserve
    # (openpyxl adds the attribute conditionally for the same reason)
    return s[:1].isspace() or s[-1:].isspace()


def _str_cell(ref: str, s: str) -> str:
    sp = ' xml:space="preserve"' if _needs_preserve(s) else ""
    return f'<c r="{ref}" t="inlineStr"><is><t{sp}>{_esc(s)}</t></is></c>'


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, np.generic):
        # numpy scalars must unwrap BEFORE the type checks: repr of
        # np.float64 under numpy>=2 is 'np.float64(x)' (invalid in <v>),
        # and np.int64 would fall through and be written as a TEXT cell
        value = value.item()
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int,)) and not isinstance(value, bool):
        return f'<c r="{ref}"><v>{value}</v></c>'
    if isinstance(value, float):
        if math.isnan(value):
            return ""
        if math.isinf(value):
            value = "Infinity" if value > 0 else "-Infinity"
            return f'<c r="{ref}" t="inlineStr"><is><t>{value}</t></is></c>'
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    return _str_cell(ref, str(value))


def _sheet_xml(rows: Iterable[Sequence]) -> str:
    # hot loop: exact-type fast paths for the common float/int/str cells
    # (NaN blanks); anything exotic (numpy scalars, inf, bool) drops to
    # _cell_xml.  Profiling showed the per-cell generic path dominated the
    # workbook write at bench shapes.
    body: List[str] = []
    refs = _COL_REFS
    n_refs = len(refs)
    for r, row in enumerate(rows, 1):
        parts: List[str] = []
        for c, v in enumerate(row):
            if v is None:
                continue
            cr = refs[c] if c < n_refs else _col_ref(c)
            tv = type(v)
            if tv is float:
                if v == v and not math.isinf(v):  # v == v: not NaN
                    parts.append(f'<c r="{cr}{r}"><v>{v!r}</v></c>')
                elif math.isinf(v):
                    parts.append(_cell_xml(f"{cr}{r}", v))
            elif tv is int:
                parts.append(f'<c r="{cr}{r}"><v>{v}</v></c>')
            elif tv is str:
                if _needs_preserve(v):  # rare: route through _str_cell
                    parts.append(_str_cell(f"{cr}{r}", v))
                else:  # inline template: the hot no-preserve fast path
                    parts.append(
                        f'<c r="{cr}{r}" t="inlineStr"><is><t>{_esc(v)}</t></is></c>')
            else:
                parts.append(_cell_xml(f"{cr}{r}", v))
        body.append(f'<row r="{r}">{"".join(parts)}</row>')
    return (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{''.join(body)}</sheetData></worksheet>"
    )


_INVALID_SHEET = re.compile(r"[\\/?*\[\]:]")


def write_xlsx(path: str, sheets: Dict[str, Iterable[Sequence]]) -> None:
    """Write ``{sheet_name: rows}`` (rows = iterable of cell sequences) to
    *path* atomically."""
    names: List[str] = []
    seen = set()
    for i, n in enumerate(sheets):
        base = _INVALID_SHEET.sub("_", n)[:31] or f"Sheet{i+1}"
        name, k = base, 2
        # sanitization can collapse distinct inputs to one name; duplicate
        # sheet names make the workbook invalid, so de-dup with a numeric
        # suffix kept inside the 31-char limit
        while name.lower() in seen:
            suffix = f"_{k}"
            name = base[: 31 - len(suffix)] + suffix
            k += 1
        seen.add(name.lower())
        names.append(name)
    sheet_entries = "".join(
        f'<sheet name="{_esc(n)}" sheetId="{i+1}" r:id="rId{i+1}"/>'
        for i, n in enumerate(names)
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f"<sheets>{sheet_entries}</sheets></workbook>"
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i+1}" '
            'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" '
            f'Target="worksheets/sheet{i+1}.xml"/>'
            for i in range(len(names))
        )
        + "</Relationships>"
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" '
        'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" '
        'ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" '
        'ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        + "".join(
            f'<Override PartName="/xl/worksheets/sheet{i+1}.xml" '
            'ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
            for i in range(len(names))
        )
        + "</Types>"
    )

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", content_types)
        zf.writestr("_rels/.rels", root_rels)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, rows in enumerate(sheets.values()):
            zf.writestr(f"xl/worksheets/sheet{i+1}.xml", _sheet_xml(rows))
    os.replace(tmp, path)


def read_xlsx(path: str) -> Dict[str, List[List]]:
    """Minimal reader for xlsx workbooks: inline strings (our writer),
    shared strings (openpyxl/xlsxwriter output, e.g. the reference's
    committed golden masters), booleans and numerics."""
    import xml.etree.ElementTree as ET

    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
          "r": "http://schemas.openxmlformats.org/officeDocument/2006/relationships"}
    out: Dict[str, List[List]] = {}
    with zipfile.ZipFile(path) as zf:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            sst = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in sst.findall("m:si", ns):
                shared.append("".join(t.text or ""
                                      for t in si.iter(
                                          "{%s}t" % ns["m"])))
        wb = ET.fromstring(zf.read("xl/workbook.xml"))
        rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
        rel_map = {
            rel.get("Id"): rel.get("Target")
            for rel in rels.findall(
                "{http://schemas.openxmlformats.org/package/2006/relationships}Relationship"
            )
        }
        for sheet in wb.find("m:sheets", ns).findall("m:sheet", ns):
            name = sheet.get("name")
            target = rel_map[sheet.get(
                "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}id")]
            # rel targets may be workbook-relative ("worksheets/sheet1.xml")
            # or package-absolute ("/xl/worksheets/sheet1.xml")
            member = (target.lstrip("/") if target.startswith("/")
                      else "xl/" + target)
            ws = ET.fromstring(zf.read(member))
            rows = []
            for row in ws.find("m:sheetData", ns).findall("m:row", ns):
                cells: Dict[int, object] = {}
                for c in row.findall("m:c", ns):
                    ref = c.get("r")
                    col = 0
                    for ch in ref:
                        if ch.isalpha():
                            col = col * 26 + (ord(ch.upper()) - ord("A") + 1)
                        else:
                            break
                    col -= 1
                    t = c.get("t")
                    if t == "inlineStr":
                        tnode = c.find("m:is/m:t", ns)
                        cells[col] = tnode.text if tnode is not None else ""
                    elif t == "str":  # formula cached string
                        v = c.find("m:v", ns)
                        cells[col] = v.text if v is not None else ""
                    else:
                        v = c.find("m:v", ns)
                        if v is None or v.text is None:
                            cells[col] = None
                        elif t == "s":
                            cells[col] = shared[int(v.text)]
                        elif t == "b":
                            cells[col] = bool(int(v.text))
                        else:
                            num = float(v.text)
                            cells[col] = int(num) if num.is_integer() else num
                width = max(cells) + 1 if cells else 0
                rows.append([cells.get(i) for i in range(width)])
            out[name] = rows
    return out
