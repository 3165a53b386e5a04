"""Minimal pure-NumPy FITS reader/writer.

The reference stack reads/writes MUSE hyperspectral cubes through
``astropy.io.fits`` (reference: deconv3d's HyperspectralCube layer; see
SURVEY.md §2 "Cube data model").  astropy is not available in this image, and
the subset of FITS that MUSE cubes use is small and stable: uncompressed
primary + IMAGE extensions, BITPIX in {8,16,32,64,-32,-64}, big-endian data,
2880-byte blocks, 80-character header cards.  This module implements exactly
that subset, pure NumPy, both directions.

Layout conventions handled:
  * MUSE pipeline cubes: empty primary + ``DATA`` and ``STAT`` image
    extensions (STAT holds the per-voxel *variance*).
  * "Simple" cubes: data directly in the primary HDU.

Not supported (raises): tile compression, random groups, variable-length
arrays, CONTINUE cards.  These never occur in MUSE cube products.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_BITPIX = {
    np.dtype("uint8"): 8,
    np.dtype("int16"): 16,
    np.dtype("int32"): 32,
    np.dtype("int64"): 64,
    np.dtype("float32"): -32,
    np.dtype("float64"): -64,
}


@dataclasses.dataclass
class HDU:
    """One header-data unit: a header mapping plus an optional ndarray.

    ``header`` preserves insertion order; ``data`` is in C order with the FITS
    NAXIS1 axis last (i.e. a MUSE cube comes out as ``[nlambda, ny, nx]``).
    """

    header: Dict[str, Any]
    data: Optional[np.ndarray] = None

    @property
    def name(self) -> str:
        return str(self.header.get("EXTNAME", "")).strip().upper()


# ---------------------------------------------------------------------------
# Header card parsing / formatting
# ---------------------------------------------------------------------------

def _parse_value(raw: str) -> Any:
    """Parse the value field of a FITS card (without the comment)."""
    s = raw.strip()
    if not s:
        return None
    if s.startswith("'"):
        # FITS string: quoted, '' is an escaped quote.
        out = []
        i = 1
        while i < len(s):
            c = s[i]
            if c == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(c)
            i += 1
        return "".join(out).rstrip()
    if s == "T":
        return True
    if s == "F":
        return False
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s.replace("D", "E").replace("d", "e"))
    except ValueError:
        return s


def _parse_header(block_bytes: bytes) -> Dict[str, Any]:
    header: Dict[str, Any] = {}
    text = block_bytes.decode("ascii", errors="replace")
    for off in range(0, len(text), CARD):
        card = text[off : off + CARD]
        key = card[:8].strip()
        if key == "END":
            break
        if key in ("", "COMMENT", "HISTORY"):
            continue
        if card[8:10] != "= ":
            continue
        body = card[10:]
        # Strip inline comment: a '/' outside of a quoted string.
        in_str = False
        val_part = body
        i = 0
        while i < len(body):
            c = body[i]
            if c == "'":
                in_str = not in_str
            elif c == "/" and not in_str:
                val_part = body[:i]
                break
            i += 1
        header[key] = _parse_value(val_part)
    return header


def _format_card(key: str, value: Any, comment: str = "") -> str:
    if isinstance(value, bool):
        val = "T" if value else "F"
        body = f"{val:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        body = f"{float(value):>20.14G}"
    elif value is None:
        body = " " * 20
    else:
        s = str(value).replace("'", "''")
        body = f"'{s:<8}'"
    card = f"{key:<8}= {body}"
    if comment:
        card += f" / {comment}"
    return card[:CARD].ljust(CARD)


def _serialize_header(cards: List[str]) -> bytes:
    text = "".join(cards) + "END".ljust(CARD)
    pad = (-len(text)) % BLOCK
    return (text + " " * pad).encode("ascii")


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _read_hdu(buf: bytes, pos: int) -> tuple[Optional[HDU], int]:
    if pos >= len(buf):
        return None, pos
    # Header: consume 2880-byte blocks until one contains the END card.
    hdr_end = pos
    header_bytes = b""
    while True:
        block = buf[hdr_end : hdr_end + BLOCK]
        if len(block) < BLOCK:
            if not header_bytes and not block.strip():
                return None, len(buf)
            raise ValueError("Truncated FITS header")
        header_bytes += block
        hdr_end += BLOCK
        text = block.decode("ascii", errors="replace")
        if any(
            text[o : o + 8].strip() == "END" for o in range(0, BLOCK, CARD)
        ):
            break
    header = _parse_header(header_bytes)

    naxis = int(header.get("NAXIS", 0))
    data = None
    data_end = hdr_end
    if naxis > 0:
        shape_fits = [int(header[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
        count = int(np.prod(shape_fits)) if shape_fits else 0
        if count > 0:
            bitpix = int(header["BITPIX"])
            dtype = _BITPIX_DTYPE.get(bitpix)
            if dtype is None:
                raise ValueError(f"Unsupported BITPIX {bitpix}")
            nbytes = count * dtype.itemsize
            raw = buf[hdr_end : hdr_end + nbytes]
            if len(raw) < nbytes:
                raise ValueError("Truncated FITS data segment")
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape_fits[::-1])
            bscale = header.get("BSCALE", 1)
            bzero = header.get("BZERO", 0)
            if bscale != 1 or bzero != 0:
                arr = arr.astype(np.float64) * bscale + bzero
            else:
                arr = arr.astype(dtype.newbyteorder("="))
            data = arr
            data_end = hdr_end + nbytes + ((-nbytes) % BLOCK)
    return HDU(header=header, data=data), data_end


def read(path: str) -> List[HDU]:
    """Read all HDUs of a FITS file."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf[:6] == b"SIMPLE":
        raise ValueError(f"{path}: not a FITS file (no SIMPLE card)")
    hdus: List[HDU] = []
    pos = 0
    while pos < len(buf):
        hdu, pos = _read_hdu(buf, pos)
        if hdu is None:
            break
        hdus.append(hdu)
    return hdus


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _hdu_bytes(hdu: HDU, primary: bool) -> bytes:
    cards: List[str] = []
    data = hdu.data
    if data is not None:
        dtype = np.dtype(data.dtype)
        if dtype not in _DTYPE_BITPIX:
            data = data.astype(np.float32)
            dtype = data.dtype
        bitpix = _DTYPE_BITPIX[dtype]
        naxis = data.ndim
    else:
        bitpix = 8
        naxis = 0
    if primary:
        cards.append(_format_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_format_card("XTENSION", "IMAGE", "image extension"))
    cards.append(_format_card("BITPIX", bitpix))
    cards.append(_format_card("NAXIS", naxis))
    if data is not None:
        for i, n in enumerate(reversed(data.shape)):
            cards.append(_format_card(f"NAXIS{i + 1}", int(n)))
    if not primary:
        cards.append(_format_card("PCOUNT", 0))
        cards.append(_format_card("GCOUNT", 1))
    skip = {"SIMPLE", "XTENSION", "BITPIX", "NAXIS", "PCOUNT", "GCOUNT"}
    skip |= {f"NAXIS{i}" for i in range(1, 10)}
    for key, value in hdu.header.items():
        if key.upper() in skip:
            continue
        cards.append(_format_card(key, value))
    out = _serialize_header(cards)
    if data is not None:
        big = data.astype(np.dtype(data.dtype).newbyteorder(">"))
        raw = big.tobytes()
        pad = (-len(raw)) % BLOCK
        out += raw + b"\x00" * pad
    return out


def write(path: str, hdus: List[HDU]) -> None:
    """Write HDUs to a FITS file (first HDU becomes the primary)."""
    with open(path, "wb") as f:
        for i, hdu in enumerate(hdus):
            f.write(_hdu_bytes(hdu, primary=(i == 0)))


# ---------------------------------------------------------------------------
# Cube-level helpers (MUSE conventions)
# ---------------------------------------------------------------------------

def find_cube_hdus(hdus: List[HDU]) -> tuple[HDU, Optional[HDU]]:
    """Locate the (data, variance) HDUs in a MUSE-style file.

    Preference order: EXTNAME DATA / STAT (MUSE pipeline products), otherwise
    the first HDU carrying a 3-D array.
    """
    data_hdu = None
    stat_hdu = None
    for hdu in hdus:
        if hdu.name == "DATA" and hdu.data is not None:
            data_hdu = hdu
        elif hdu.name in ("STAT", "VARIANCE") and hdu.data is not None:
            stat_hdu = hdu
    if data_hdu is None:
        for hdu in hdus:
            if hdu.data is not None and hdu.data.ndim == 3:
                data_hdu = hdu
                break
    if data_hdu is None:
        raise ValueError("No 3-D data HDU found in FITS file")
    return data_hdu, stat_hdu


def spectral_wcs(header: Dict[str, Any]) -> tuple[float, float, float]:
    """Extract (crval, cdelt, crpix) of the spectral (3rd) axis."""
    crval = float(header.get("CRVAL3", 0.0))
    cdelt = header.get("CDELT3", header.get("CD3_3", 1.0))
    cdelt = float(cdelt) if cdelt else 1.0
    crpix = float(header.get("CRPIX3", 1.0))
    return crval, cdelt, crpix
