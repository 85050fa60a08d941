"""Minimal native PDF text extraction.

Counterpart of ``pathway_tpu/xpacks/llm/_pdf.py`` (stdlib only, copied so the port
imports nothing of that package). The reference's PypdfParser delegates to the pypdf
library, which is not assumed here, so this extracts the common machine-generated PDF
shape: FlateDecode (zlib) content streams with literal-string text operators
(``(...) Tj``, ``[(...) ...] TJ``, ``'``) inside BT/ET blocks. Scanned or
exotically-encoded PDFs need OCR/vision parsing instead.
"""

from __future__ import annotations

import re
import zlib

_STREAM_RE = re.compile(
    rb"<<(?P<dict>.*?)>>\s*stream\r?\n(?P<data>.*?)endstream", re.DOTALL
)
_TEXT_BLOCK_RE = re.compile(rb"BT(.*?)ET", re.DOTALL)
# literal string followed by a show operator; also TJ arrays and ' / "
_SHOW_RE = re.compile(
    rb"""
    \((?P<lit>(?:\\.|[^\\()])*)\)\s*(?:Tj|'|") |
    \[(?P<arr>(?:\\.|[^\]])*)\]\s*TJ |
    (?P<newline>T\*|Td|TD)
    """,
    re.VERBOSE | re.DOTALL,
)
_ARR_LIT_RE = re.compile(rb"\((?P<lit>(?:\\.|[^\\()])*)\)")

_ESCAPES = {
    b"n": b"\n",
    b"r": b"\r",
    b"t": b"\t",
    b"b": b"\b",
    b"f": b"\f",
    b"(": b"(",
    b")": b")",
    b"\\": b"\\",
}


def _decode_literal(raw: bytes) -> str:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            if nxt.isdigit():  # octal escape, up to 3 digits
                digits = raw[i + 1 : i + 4]
                m = re.match(rb"[0-7]{1,3}", digits)
                if m:
                    out.append(int(m.group(), 8) & 0xFF)
                    i += 1 + len(m.group())
                    continue
            i += 2
            out += nxt
            continue
        out += c
        i += 1
    return out.decode("latin-1")


def _stream_text(content: bytes) -> str:
    pieces: list[str] = []
    for block in _TEXT_BLOCK_RE.findall(content):
        line: list[str] = []
        for m in _SHOW_RE.finditer(block):
            if m.group("newline") is not None:
                if line:
                    pieces.append("".join(line))
                    line = []
                continue
            if m.group("lit") is not None:
                line.append(_decode_literal(m.group("lit")))
            elif m.group("arr") is not None:
                for lit in _ARR_LIT_RE.finditer(m.group("arr")):
                    line.append(_decode_literal(lit.group("lit")))
        if line:
            pieces.append("".join(line))
    return "\n".join(p for p in pieces if p.strip())


def extract_pdf_text(data: bytes) -> str:
    """Text of all content streams, in document order."""
    if not data.lstrip().startswith(b"%PDF"):
        raise ValueError("not a PDF (missing %PDF header)")
    texts: list[str] = []
    for m in _STREAM_RE.finditer(data):
        raw = m.group("data")
        if b"FlateDecode" in m.group("dict"):
            length = re.search(rb"/Length\s+(\d+)", m.group("dict"))
            candidates = []
            if length is not None:
                # the dict's /Length bounds the exact payload — immune to
                # compressed bytes that happen to end in EOL characters
                candidates.append(raw[: int(length.group(1))])
            candidates.append(raw)
            # at most one trailing EOL belongs to the stream framing
            candidates.append(re.sub(rb"\r?\n\Z", b"", raw))
            for candidate in candidates:
                try:
                    raw = zlib.decompress(candidate)
                    break
                except zlib.error:
                    continue
            else:
                continue
        text = _stream_text(raw)
        if text:
            texts.append(text)
    return "\n".join(texts)
