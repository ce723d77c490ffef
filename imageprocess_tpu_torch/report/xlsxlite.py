"""Self-contained XLSX writer and reader (the port's copy; no openpyxl).

Writes the minimal Office Open XML SpreadsheetML package: workbook,
worksheets with inline strings, relationships, content types.  Multiple
sheets, str / int / float / bool cells, NaN -> blank; Excel, LibreOffice
and pandas read the files back.  ``read_xlsx`` reads inline and shared
strings, booleans and numbers.

A table's worksheet is made column by column: each cell's text once
(``Column``), then each row from one template per row shape
(``sheet_xml``, ``pivot_xml``).  A member of ``THREADED`` bytes or more
is deflated and checksummed on a thread of its own while the next is
made (zlib lets go of the interpreter lock);
the archive is the one ``zipfile`` writes with ``ZIP_DEFLATED`` at
zlib's default level.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
import struct
import sys
import threading
import time
import zipfile
import zlib
from itertools import zip_longest
from string import ascii_uppercase
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_XML_ESCAPES = {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;"}
# XML 1.0 forbids control chars other than \t \n \r — one stray \x08 in a
# cell string would make the whole workbook unreadable
_XML_BAD = re.compile(r'[&<>"]|[\x00-\x08\x0b\x0c\x0e-\x1f]')


def _esc(s: str) -> str:
    return _XML_BAD.sub(lambda m: _XML_ESCAPES.get(m.group(0), ""), s)


def _col_refs(n: int) -> List[str]:
    """The references of the first *n* columns: A, ..., Z, AA, ..., ZZ,
    AAA, ..."""
    refs: List[str] = []
    level = [""]
    while len(refs) < n:
        need = n - len(refs)
        # the next width's references, from as many of this width's as it takes
        level = [p + c for p in level[:-(-need // 26)] for c in ascii_uppercase]
        refs += level[:need]
    return refs


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


# What a cell's text is in its row's template: a number inside <v>, a
# string inside <is><t>, the cell's whole XML after its reference, or no
# cell at all (None, NaN: its text is "")
NUM, STR, BODY, NONE = range(4)
# "\0" stands for the row's number: no cell text holds one (``_esc``
# drops it), and templates are ``%`` formats, so texts stay out of them
_PIECES = ('<c r="{ref}\0"><v>%s</v></c>',
           '<c r="{ref}\0" t="inlineStr"><is><t>%s</t></is></c>',
           '<c r="{ref}\0%s',
           "%s")


def _cell_text(v):
    """(kind, text) of one cell: exact floats, ints and plain strings by
    the fast kinds, anything else through ``_cell_xml``."""
    tv = type(v)
    if (tv is float and v - v == 0) or tv is int:   # v - v == 0: finite
        return NUM, repr(v)
    if tv is str and not _needs_preserve(v):
        return STR, _esc(v)
    xml = _cell_xml("", v)
    return (BODY, xml[len('<c r="'):]) if xml else (NONE, "")


class Column:
    """The cell texts of one column, each made once and shared by every
    sheet that shows the column: ``kinds`` is one kind for every cell or a
    list of one per cell, ``texts`` one text per cell ("" where there is
    no cell)."""

    __slots__ = ("kinds", "texts")

    def __init__(self, kinds, texts: List[str]):
        self.kinds, self.texts = kinds, texts

    @classmethod
    def of(cls, values: Sequence) -> "Column":
        """The texts of *values*' cells: a column of one plain type in one
        pass of C calls, any other cell by ``_cell_text``."""
        types = set(map(type, values))
        if types == {float}:
            total = sum(values)         # finite unless a value is NaN or +-inf
            if total - total == 0:
                return cls(NUM, list(map(float.__repr__, values)))
        elif types == {int}:
            return cls(NUM, list(map(int.__repr__, values)))
        elif types == {str} and not _XML_BAD.search("".join(values)) and not any(
                map(_needs_preserve, set(values))):
            return cls(STR, list(values))       # nothing to escape or to keep
        if len(types) == 1 and types <= {str, bool, type(None)}:
            memo = {v: _cell_text(v) for v in set(values)}  # few distinct values
            pairs = list(map(memo.__getitem__, values))
        else:
            pairs = list(map(_cell_text, values))
        if not pairs:
            return cls(NONE, [])
        kinds, texts = map(list, zip(*pairs))
        return cls(kinds[0] if kinds.count(kinds[0]) == len(kinds) else kinds, texts)

    @property
    def numbers(self) -> bool:
        """Whether every cell is a finite number, its text the value's repr."""
        return self.kinds == NUM

    def kind(self, i: int) -> int:
        """The kind of cell *i*."""
        return self.kinds if type(self.kinds) is int else self.kinds[i]


def _row_template(kinds) -> str:
    return ('<row r="\0">' + "".join(_PIECES[k].format(ref=ref)
                                     for ref, k in zip(_col_refs(len(kinds)), kinds))
            + "</row>")


def _rows_of(rows: Iterable[Tuple[Sequence[int], Sequence[str]]], first: int) -> str:
    """The ``<row>`` elements of rows given as (kinds, texts), numbered
    from *first*: a row is its shape's template ``%`` its texts, with its
    number put in."""
    templates: Dict[tuple, str] = {}
    out = []
    for r, (kinds, texts) in enumerate(rows, first):
        kinds = tuple(kinds)
        tmpl = templates.get(kinds)
        if tmpl is None:
            tmpl = templates[kinds] = _row_template(kinds)
        out.append((tmpl % tuple(texts)).replace("\0", str(r)))
    return "".join(out)


def _row_cells(values: Sequence) -> Tuple[List[int], List[str]]:
    """(kinds, texts) of one row of values."""
    pairs = list(map(_cell_text, values))
    return [k for k, _ in pairs], [t for _, t in pairs]


_SHEET_HEAD = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
               '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
               "<sheetData>")
_SHEET_TAIL = "</sheetData></worksheet>"


def sheet_xml(header: Sequence, columns: Sequence[Column], order: Sequence[int]) -> str:
    """A worksheet: the values *header* as its first row, then *columns*'
    cells at the table rows *order*."""
    if columns:
        n = len(columns[0].texts)
        kinds = list(zip(*[c.kinds if type(c.kinds) is list else [c.kinds] * n
                           for c in columns]))
        texts = list(zip(*[c.texts for c in columns]))
    else:
        kinds = texts = [()] * (max(order, default=-1) + 1)
    rows = [_row_cells(header)] + [(kinds[i], texts[i]) for i in order]
    return _SHEET_HEAD + _rows_of(rows, 1) + _SHEET_TAIL


def pivot_xml(corner, heads: Column, head_at: Sequence[int], keys: Sequence,
              values: Column, at: Sequence[Sequence[Optional[int]]]) -> str:
    """A pivot worksheet: a header of the value *corner* and *heads*'
    cells at the table rows *head_at*, then a row a key of *keys*: the
    key, and *values*' cells at the table rows of its list in *at* (no
    cell where that is None)."""
    kind, text = _cell_text(corner)
    rows = [([kind] + [heads.kind(i) for i in head_at],
             [text] + [heads.texts[i] for i in head_at])]
    for key, idx in zip(keys, at):
        kind, text = _cell_text(key)
        rows.append(([kind] + [NONE if i is None else values.kind(i) for i in idx],
                     [text] + ["" if i is None else values.texts[i] for i in idx]))
    return _SHEET_HEAD + _rows_of(rows, 1) + _SHEET_TAIL


def _sheet_xml(rows: Iterable[Sequence]) -> str:
    """A worksheet of rows of values (short rows end in blank cells).  Its
    first row, a header as a rule, is made apart, so that the columns
    below it are each of one type."""
    rows = list(rows)
    if not rows:
        return _SHEET_HEAD + _SHEET_TAIL
    body = rows[1:]
    return sheet_xml(rows[0], [Column.of(v) for v in zip_longest(*body)],
                     range(len(body)))


# A member this large or larger is deflated on a thread of its own.  On an
# H100 host zlib deflates this much XML in about 1.5 ms, while starting a
# thread costs the calling thread about 0.7 ms: smaller members gain less
# than that and deflate inline
THREADED = 64 * 1024


def _deflate(data: bytes):
    """(CRC-32, raw deflate stream) of *data*, as ``zipfile`` makes them.
    The deflate goes first: on a thread each call's return waits for the
    interpreter lock, and this one then only holds up the short CRC."""
    packed = zlib.compress(data, zlib.Z_DEFAULT_COMPRESSION, wbits=-15)
    return zlib.crc32(data), packed


class _Deflating(threading.Thread):
    def __init__(self, data: bytes):
        super().__init__(name="xlsx-deflate", daemon=True)
        self.data, self.error = data, None
        self.start()

    def run(self):
        try:
            self.out = _deflate(self.data)
        except BaseException as e:  # noqa: BLE001 -- raised again in result()
            self.error = e

    def result(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.out


class Member:
    """One part of the package, made before ``write_xlsx`` takes it: its
    bytes, and when they are ``THREADED`` or more, their deflate and CRC
    already running on a thread of their own.  A worksheet made this way
    iterates as its rows of values (*rows*, called), as ``write_xlsx``'s
    other sheets are given."""

    def __init__(self, xml: str, rows: Optional[Callable[[], Iterable[Sequence]]] = None):
        self.data = xml.encode("utf-8")
        self.threaded = len(self.data) >= THREADED
        self._rows = rows
        self._deflating = _Deflating(self.data) if self.threaded else None

    def packed(self):
        """(CRC-32, deflated bytes), once they are made."""
        return self._deflating.result() if self._deflating else _deflate(self.data)

    def __iter__(self):
        return iter(self._rows() if self._rows else ())


# zipfile's layout for a member written by ZipFile.writestr(name, data):
# version 2.0, no flags, deflate, no extra field, -rw------- on a Unix host
_LOCAL = struct.Struct("<4s2B4HL2L2H")
_CENTRAL = struct.Struct("<4s4B4HL2L5H2L")
_END = struct.Struct("<4s4H2LH")
_VERSION, _DEFLATED = 20, zipfile.ZIP_DEFLATED
_SYSTEM = 0 if sys.platform == "win32" else 3
_ATTR = 0o600 << 16
_LIMIT = zipfile.ZIP64_LIMIT


def _zip_bytes(members) -> List[bytes]:
    """The archive of (name, ``Member``) pairs, in order, or None where it
    needs ZIP64 records."""
    dt = time.localtime(time.time())[:6]
    dosdate = (dt[0] - 1980) << 9 | dt[1] << 5 | dt[2]
    dostime = dt[3] << 11 | dt[4] << 5 | (dt[5] // 2)
    out, central, offset = [], [], 0
    for name, m in members:
        crc, packed = m.packed()
        fname, size = name.encode("ascii"), len(m.data)
        if size * 1.05 > _LIMIT or offset > _LIMIT:
            return None
        head = (_VERSION, 0, 0, _DEFLATED, dostime, dosdate, crc, len(packed), size,
                len(fname))
        out += (_LOCAL.pack(b"PK\x03\x04", *head, 0), fname, packed)
        central.append(_CENTRAL.pack(b"PK\x01\x02", _VERSION, _SYSTEM, *head, 0, 0, 0, 0,
                                     _ATTR, offset) + fname)
        offset += _LOCAL.size + len(fname) + len(packed)
    cd = b"".join(central)
    if offset + len(cd) > _LIMIT:
        return None
    return out + [cd, _END.pack(b"PK\x05\x06", 0, 0, len(members), len(members), len(cd),
                                offset, 0)]


_INVALID_SHEET = re.compile(r"[\\/?*\[\]:]")


def write_xlsx(path: str, sheets: Dict[str, Iterable[Sequence]]) -> None:
    """Write ``{sheet_name: rows}`` (rows = iterable of cell sequences, or
    a ``Member`` made ahead) to *path* atomically."""
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

    members = [("[Content_Types].xml", Member(content_types)),
               ("_rels/.rels", Member(root_rels)),
               ("xl/workbook.xml", Member(workbook)),
               ("xl/_rels/workbook.xml.rels", Member(wb_rels))]
    for i, rows in enumerate(sheets.values()):
        members.append((f"xl/worksheets/sheet{i+1}.xml",
                        rows if isinstance(rows, Member) else Member(_sheet_xml(rows))))
    chunks = _zip_bytes(members)      # every member is deflated before a byte is written
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    try:
        if chunks is None:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
                for name, m in members:
                    zf.writestr(name, m.data)
        else:
            with open(tmp, "wb") as f:
                f.writelines(chunks)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


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
