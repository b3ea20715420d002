"""Minimal self-contained FITS I/O (port of ``nestfit_tpu/cube/fits_io.py``;
NumPy only, kept as the port's own copy).

The subset of the FITS standard the system needs: single-HDU primary
images, float/int data, 80-char header cards in 2880-byte blocks,
big-endian data.
"""

import numpy as np

_BLOCK = 2880
_CARD = 80

_BITPIX_DTYPE = {
    8: np.uint8, 16: ">i2", 32: ">i4", 64: ">i8",
    -32: ">f4", -64: ">f8",
}


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.startswith("'"):
        end = raw.rfind("'")
        return raw[1:end].rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        if any(c in raw for c in ".eEdD") and not raw.lstrip("+-").isdigit():
            return float(raw.replace("D", "E").replace("d", "e"))
        return int(raw)
    except ValueError:
        return raw


def _format_card(key: str, value, comment: str = "") -> bytes:
    key = key.upper()[:8]
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        body = f"{key:<8}= {value:>20.13E}"
    elif value is None:
        body = f"{key:<8}="
    else:
        s = str(value).replace("'", "''")
        body = f"{key:<8}= '{s:<8}'"
    if comment:
        body = f"{body} / {comment}"
    return body[:_CARD].ljust(_CARD).encode("ascii")


def read_fits(path):
    """Read a primary-HDU FITS image.

    Returns
    -------
    data : np.ndarray
        Native-endian array with numpy axis order (NAXISn, ..., NAXIS1).
    header : dict
    """
    header = {}
    with open(path, "rb") as fh:
        # header blocks
        raw = b""
        while True:
            block = fh.read(_BLOCK)
            if len(block) != _BLOCK:
                raise ValueError("truncated FITS header")
            raw += block
            if b"END     " in block or block.rstrip(b" ").endswith(b"END"):
                cards = [raw[i:i + _CARD].decode("ascii", "replace")
                         for i in range(0, len(raw), _CARD)]
                if any(c.startswith("END") for c in cards):
                    break
        for card in cards:
            key = card[:8].strip()
            if key in ("", "COMMENT", "HISTORY"):
                continue
            if key == "END":
                break
            if card[8:10] != "= ":
                continue
            header[key] = _parse_value(card[10:].split(" / ")[0])
        bitpix = header["BITPIX"]
        naxis = header["NAXIS"]
        shape = [header[f"NAXIS{i}"] for i in range(1, naxis + 1)]
        count = int(np.prod(shape)) if shape else 0
        dtype = np.dtype(_BITPIX_DTYPE[bitpix])
        data = np.frombuffer(
            fh.read(count * dtype.itemsize), dtype=dtype, count=count
        )
        # FITS order: NAXIS1 varies fastest -> numpy shape reversed
        data = data.reshape(shape[::-1])
        data = data.astype(data.dtype.newbyteorder("="))
        # BLANK marks undefined pixels of integer data (FITS 4.0
        # sec. 5.3); map them to NaN like astropy does
        blank_mask = None
        if "BLANK" in header and data.dtype.kind in "iu":
            blank_mask = data == header["BLANK"]
        if "BSCALE" in header or "BZERO" in header:
            data = data * header.get("BSCALE", 1.0) + header.get("BZERO", 0.0)
        if blank_mask is not None and blank_mask.any():
            data = data.astype(np.float64, copy=False)
            data[blank_mask] = np.nan
    return data, header


def write_fits(path, data, header=None, overwrite=True):
    """Write a primary-HDU FITS image (float32/float64 data)."""
    import os
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    data = np.asarray(data)
    if data.dtype == np.float64:
        bitpix, dt = -64, ">f8"
    else:
        data = data.astype(np.float32)
        bitpix, dt = -32, ">f4"
    cards = [
        _format_card("SIMPLE", True, "conforms to FITS standard"),
        _format_card("BITPIX", bitpix),
        _format_card("NAXIS", data.ndim),
    ]
    for i, n in enumerate(reversed(data.shape)):
        cards.append(_format_card(f"NAXIS{i + 1}", n))
    reserved = {"SIMPLE", "BITPIX", "NAXIS"} | {
        f"NAXIS{i}" for i in range(1, 10)
    }
    for k, v in (header or {}).items():
        if k.upper() in reserved:
            continue
        try:
            if isinstance(v, float) and not np.isfinite(v):
                continue
            cards.append(_format_card(k, v))
        except (ValueError, TypeError):
            continue
    cards.append("END".ljust(_CARD).encode("ascii"))
    raw = b"".join(cards)
    raw += b" " * (-len(raw) % _BLOCK)
    body = data.astype(dt).tobytes()
    body += b"\x00" * (-len(body) % _BLOCK)
    with open(path, "wb") as fh:
        fh.write(raw)
        fh.write(body)
