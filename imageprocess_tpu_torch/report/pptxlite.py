"""Self-contained PPTX writer (no python-pptx dependency; the port's copy
of ``imageprocess_tpu/report/pptxlite.py``).

Minimal Office Open XML PresentationML package: presentation + one slide
master/layout/theme (fixed boilerplate) + blank slides carrying pictures and
text boxes.  Feature set = what ``Make_FRET_timelapsePPT`` needs
(src/FRET/Make_FRET_timelapsePPT.py:100-188): 16:9 slide size, add_picture
with left/top/width (height from the image aspect), add_textbox.

Geometry is in EMU (914400 per inch).
"""

from __future__ import annotations

import os
import re
import zipfile
from typing import List, Optional, Tuple

# picture ext -> MIME: the ONE source for both the package's Default
# content-type declarations (save()) and add_picture's extension check —
# a mismatch either rejects a supported format or ships a .pptx
# PowerPoint calls corrupt
_PICTURE_MIME = {"png": "image/png", "jpg": "image/jpeg",
                 "jpeg": "image/jpeg", "tif": "image/tiff",
                 "tiff": "image/tiff"}
_PICTURE_EXTENSIONS = set(_PICTURE_MIME)

EMU_PER_INCH = 914400
EMU_PER_CM = 360000


def inches(v: float) -> int:
    return int(round(v * EMU_PER_INCH))


def cm(v: float) -> int:
    return int(round(v * EMU_PER_CM))


class Picture:
    def __init__(self, path: str, left: int, top: int, width: int, height: int):
        self.path = path
        self.left, self.top, self.width, self.height = left, top, width, height


class TextBox:
    def __init__(self, text: str, left: int, top: int, width: int, height: int):
        self.text = text
        self.left, self.top, self.width, self.height = left, top, width, height


class Slide:
    def __init__(self):
        self.pictures: List[Picture] = []
        self.texts: List[TextBox] = []

    def add_picture(self, path: str, left: int, top: int,
                    width: Optional[int] = None, height: Optional[int] = None):
        from PIL import Image

        ext = os.path.splitext(path)[1].lstrip(".").lower()
        if ext not in _PICTURE_EXTENSIONS:
            # the package only declares content types for these — any
            # other extension would zip fine but PowerPoint rejects the
            # whole .pptx as corrupt on open
            raise ValueError(
                f"unsupported picture extension {ext!r}: the deck's "
                f"content types cover {sorted(_PICTURE_EXTENSIONS)}")
        with Image.open(path) as im:
            w_px, h_px = im.size
        if width is None and height is None:
            width = inches(w_px / 96.0)
        if width is not None and height is None:
            height = int(round(width * h_px / w_px))
        elif height is not None and width is None:
            width = int(round(height * w_px / h_px))
        pic = Picture(path, left, top, int(width), int(height))
        self.pictures.append(pic)
        return pic

    def add_textbox(self, text: str, left: int, top: int, width: int, height: int):
        tb = TextBox(text, left, top, width, height)
        self.texts.append(tb)
        return tb


class Presentation:
    """API-compatible-enough stand-in for pptx.Presentation."""

    def __init__(self, slide_width: int = inches(13.333),
                 slide_height: int = inches(7.5)):
        self.slide_width = slide_width
        self.slide_height = slide_height
        self.slides: List[Slide] = []

    def add_slide(self) -> Slide:
        s = Slide()
        self.slides.append(s)
        return s

    # --- serialization -----------------------------------------------------

    def save(self, path: str) -> None:
        media: List[Tuple[str, str]] = []  # (zip name, source path)
        media_index = {}
        for s in self.slides:
            for p in s.pictures:
                if p.path not in media_index:
                    ext = os.path.splitext(p.path)[1].lstrip(".").lower() or "png"
                    name = f"ppt/media/image{len(media) + 1}.{ext}"
                    media.append((name, p.path))
                    media_index[p.path] = name

        n = len(self.slides)
        ct = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
              '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
              '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
              '<Default Extension="xml" ContentType="application/xml"/>'
              + "".join(f'<Default Extension="{e}" ContentType="{m}"/>'
                        for e, m in sorted(_PICTURE_MIME.items())) +
              '<Override PartName="/ppt/presentation.xml" ContentType="application/vnd.openxmlformats-officedocument.presentationml.presentation.main+xml"/>'
              '<Override PartName="/ppt/slideMasters/slideMaster1.xml" ContentType="application/vnd.openxmlformats-officedocument.presentationml.slideMaster+xml"/>'
              '<Override PartName="/ppt/slideLayouts/slideLayout1.xml" ContentType="application/vnd.openxmlformats-officedocument.presentationml.slideLayout+xml"/>'
              '<Override PartName="/ppt/theme/theme1.xml" ContentType="application/vnd.openxmlformats-officedocument.theme+xml"/>']
        for i in range(1, n + 1):
            ct.append(f'<Override PartName="/ppt/slides/slide{i}.xml" '
                      'ContentType="application/vnd.openxmlformats-officedocument.presentationml.slide+xml"/>')
        ct.append("</Types>")

        root_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                     '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
                     '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="ppt/presentation.xml"/>'
                     '</Relationships>')

        sld_ids = "".join(
            f'<p:sldId id="{256 + i}" r:id="rId{i + 2}"/>' for i in range(n)
        )
        presentation = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<p:presentation xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main" '
            'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships" '
            'xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main">'
            '<p:sldMasterIdLst><p:sldMasterId id="2147483648" r:id="rId1"/></p:sldMasterIdLst>'
            f'<p:sldIdLst>{sld_ids}</p:sldIdLst>'
            f'<p:sldSz cx="{self.slide_width}" cy="{self.slide_height}"/>'
            f'<p:notesSz cx="{self.slide_height}" cy="{self.slide_width}"/>'
            '</p:presentation>')

        pres_rels = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                     '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
                     '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/slideMaster" Target="slideMasters/slideMaster1.xml"/>']
        for i in range(n):
            pres_rels.append(
                f'<Relationship Id="rId{i + 2}" '
                'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/slide" '
                f'Target="slides/slide{i + 1}.xml"/>')
        pres_rels.append("</Relationships>")

        master = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                  '<p:sldMaster xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main" '
                  'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships" '
                  'xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main">'
                  '<p:cSld><p:spTree><p:nvGrpSpPr><p:cNvPr id="1" name=""/><p:cNvGrpSpPr/><p:nvPr/></p:nvGrpSpPr>'
                  '<p:grpSpPr><a:xfrm><a:off x="0" y="0"/><a:ext cx="0" cy="0"/>'
                  '<a:chOff x="0" y="0"/><a:chExt cx="0" cy="0"/></a:xfrm></p:grpSpPr>'
                  '</p:spTree></p:cSld>'
                  '<p:clrMap bg1="lt1" tx1="dk1" bg2="lt2" tx2="dk2" accent1="accent1" '
                  'accent2="accent2" accent3="accent3" accent4="accent4" accent5="accent5" '
                  'accent6="accent6" hlink="hlink" folHlink="folHlink"/>'
                  '<p:sldLayoutIdLst><p:sldLayoutId id="2147483649" r:id="rId1"/></p:sldLayoutIdLst>'
                  '</p:sldMaster>')
        master_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                       '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
                       '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/slideLayout" Target="../slideLayouts/slideLayout1.xml"/>'
                       '<Relationship Id="rId2" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/theme" Target="../theme/theme1.xml"/>'
                       '</Relationships>')
        layout = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                  '<p:sldLayout xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main" '
                  'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships" '
                  'xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main" type="blank">'
                  '<p:cSld><p:spTree><p:nvGrpSpPr><p:cNvPr id="1" name=""/><p:cNvGrpSpPr/><p:nvPr/></p:nvGrpSpPr>'
                  '<p:grpSpPr/></p:spTree></p:cSld>'
                  '<p:clrMapOvr><a:overrideClrMapping bg1="lt1" tx1="dk1" bg2="lt2" tx2="dk2" '
                  'accent1="accent1" accent2="accent2" accent3="accent3" accent4="accent4" '
                  'accent5="accent5" accent6="accent6" hlink="hlink" folHlink="folHlink"/></p:clrMapOvr>'
                  '</p:sldLayout>')
        layout_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                       '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
                       '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/slideMaster" Target="../slideMasters/slideMaster1.xml"/>'
                       '</Relationships>')
        theme = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                 '<a:theme xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main" name="Min">'
                 '<a:themeElements>'
                 '<a:clrScheme name="Min"><a:dk1><a:sysClr val="windowText" lastClr="000000"/></a:dk1>'
                 '<a:lt1><a:sysClr val="window" lastClr="FFFFFF"/></a:lt1>'
                 '<a:dk2><a:srgbClr val="44546A"/></a:dk2><a:lt2><a:srgbClr val="E7E6E6"/></a:lt2>'
                 '<a:accent1><a:srgbClr val="4472C4"/></a:accent1><a:accent2><a:srgbClr val="ED7D31"/></a:accent2>'
                 '<a:accent3><a:srgbClr val="A5A5A5"/></a:accent3><a:accent4><a:srgbClr val="FFC000"/></a:accent4>'
                 '<a:accent5><a:srgbClr val="5B9BD5"/></a:accent5><a:accent6><a:srgbClr val="70AD47"/></a:accent6>'
                 '<a:hlink><a:srgbClr val="0563C1"/></a:hlink><a:folHlink><a:srgbClr val="954F72"/></a:folHlink>'
                 '</a:clrScheme>'
                 '<a:fontScheme name="Min"><a:majorFont><a:latin typeface="Calibri"/><a:ea typeface=""/><a:cs typeface=""/></a:majorFont>'
                 '<a:minorFont><a:latin typeface="Calibri"/><a:ea typeface=""/><a:cs typeface=""/></a:minorFont></a:fontScheme>'
                 '<a:fmtScheme name="Min"><a:fillStyleLst><a:solidFill><a:schemeClr val="phClr"/></a:solidFill>'
                 '<a:solidFill><a:schemeClr val="phClr"/></a:solidFill><a:solidFill><a:schemeClr val="phClr"/></a:solidFill></a:fillStyleLst>'
                 '<a:lnStyleLst><a:ln><a:solidFill><a:schemeClr val="phClr"/></a:solidFill></a:ln>'
                 '<a:ln><a:solidFill><a:schemeClr val="phClr"/></a:solidFill></a:ln>'
                 '<a:ln><a:solidFill><a:schemeClr val="phClr"/></a:solidFill></a:ln></a:lnStyleLst>'
                 '<a:effectStyleLst><a:effectStyle><a:effectLst/></a:effectStyle><a:effectStyle><a:effectLst/></a:effectStyle>'
                 '<a:effectStyle><a:effectLst/></a:effectStyle></a:effectStyleLst>'
                 '<a:bgFillStyleLst><a:solidFill><a:schemeClr val="phClr"/></a:solidFill>'
                 '<a:solidFill><a:schemeClr val="phClr"/></a:solidFill><a:solidFill><a:schemeClr val="phClr"/></a:solidFill></a:bgFillStyleLst>'
                 '</a:fmtScheme></a:themeElements></a:theme>')

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("[Content_Types].xml", "".join(ct))
            zf.writestr("_rels/.rels", root_rels)
            zf.writestr("ppt/presentation.xml", presentation)
            zf.writestr("ppt/_rels/presentation.xml.rels", "".join(pres_rels))
            zf.writestr("ppt/slideMasters/slideMaster1.xml", master)
            zf.writestr("ppt/slideMasters/_rels/slideMaster1.xml.rels", master_rels)
            zf.writestr("ppt/slideLayouts/slideLayout1.xml", layout)
            zf.writestr("ppt/slideLayouts/_rels/slideLayout1.xml.rels", layout_rels)
            zf.writestr("ppt/theme/theme1.xml", theme)
            for name, src in media:
                zf.write(src, name)
            for i, slide in enumerate(self.slides, 1):
                zf.writestr(f"ppt/slides/slide{i}.xml",
                            self._slide_xml(slide, media_index))
                zf.writestr(f"ppt/slides/_rels/slide{i}.xml.rels",
                            self._slide_rels(slide, media_index))
        os.replace(tmp, path)

    def _slide_rels(self, slide: Slide, media_index) -> str:
        rels = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
                '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/slideLayout" Target="../slideLayouts/slideLayout1.xml"/>']
        seen = {}
        rid = 2
        for p in slide.pictures:
            if p.path in seen:
                continue
            seen[p.path] = rid
            target = "../" + media_index[p.path][4:]  # strip "ppt/"
            rels.append(
                f'<Relationship Id="rId{rid}" '
                'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/image" '
                f'Target="{target}"/>')
            rid += 1
        rels.append("</Relationships>")
        return "".join(rels)

    def _slide_xml(self, slide: Slide, media_index) -> str:
        import re as _re

        def esc(s):
            return _re.sub(r"[&<>]", lambda m: {"&": "&amp;", "<": "&lt;",
                                                ">": "&gt;"}[m.group(0)], s)

        shapes = []
        sid = 2
        seen = {}
        rid = 2
        for p in slide.pictures:
            if p.path not in seen:
                seen[p.path] = rid
                rid += 1
            r = seen[p.path]
            shapes.append(
                f'<p:pic><p:nvPicPr><p:cNvPr id="{sid}" name="Picture {sid}"/>'
                '<p:cNvPicPr/><p:nvPr/></p:nvPicPr>'
                f'<p:blipFill><a:blip r:embed="rId{r}"/><a:stretch><a:fillRect/></a:stretch></p:blipFill>'
                f'<p:spPr><a:xfrm><a:off x="{p.left}" y="{p.top}"/>'
                f'<a:ext cx="{p.width}" cy="{p.height}"/></a:xfrm>'
                '<a:prstGeom prst="rect"><a:avLst/></a:prstGeom></p:spPr></p:pic>')
            sid += 1
        for tbox in slide.texts:
            shapes.append(
                f'<p:sp><p:nvSpPr><p:cNvPr id="{sid}" name="TextBox {sid}"/>'
                '<p:cNvSpPr txBox="1"/><p:nvPr/></p:nvSpPr>'
                f'<p:spPr><a:xfrm><a:off x="{tbox.left}" y="{tbox.top}"/>'
                f'<a:ext cx="{tbox.width}" cy="{tbox.height}"/></a:xfrm>'
                '<a:prstGeom prst="rect"><a:avLst/></a:prstGeom></p:spPr>'
                f'<p:txBody><a:bodyPr/><a:lstStyle/><a:p><a:r><a:t>{esc(tbox.text)}</a:t></a:r></a:p></p:txBody></p:sp>')
            sid += 1
        return ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                '<p:sld xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main" '
                'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships" '
                'xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main">'
                '<p:cSld><p:spTree><p:nvGrpSpPr><p:cNvPr id="1" name=""/>'
                '<p:cNvGrpSpPr/><p:nvPr/></p:nvGrpSpPr><p:grpSpPr/>'
                + "".join(shapes) +
                '</p:spTree></p:cSld></p:sld>')


def read_pptx_summary(path: str) -> dict:
    """Round-trip check helper: slide count, picture count per slide,
    texts."""
    import xml.etree.ElementTree as ET

    ns = {"p": "http://schemas.openxmlformats.org/presentationml/2006/main",
          "a": "http://schemas.openxmlformats.org/drawingml/2006/main"}
    out = {"slides": [], "media": []}
    def _slide_no(n: str) -> int:
        m = re.search(r"slide(\d+)\.xml$", n)
        return int(m.group(1)) if m else 0

    with zipfile.ZipFile(path) as zf:
        # numeric order: lexicographic sorting would put slide10 before
        # slide2 and misreport decks with >= 10 slides
        names = sorted((n for n in zf.namelist()
                        if n.startswith("ppt/slides/slide")
                        and n.endswith(".xml")), key=_slide_no)
        out["media"] = [n for n in zf.namelist() if n.startswith("ppt/media/")]
        for n in names:
            root = ET.fromstring(zf.read(n))
            pics = root.findall(".//p:pic", ns)
            texts = [t.text for t in root.findall(".//a:t", ns)]
            out["slides"].append({"pictures": len(pics), "texts": texts})
    return out
