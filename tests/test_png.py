"""PNG codec tests (capability parity with pkg/despair/png_test.go:12-317:
round-trips, gray/RGB/RGBA variants, invalid files)."""

import numpy as np
import pytest

from steroscopic_hardware_tpu.io.png import PNGError, read_png, write_png


@pytest.mark.parametrize(
    "shape",
    [(7, 5), (32, 48), (1, 1), (480, 640)],
)
def test_gray_roundtrip(shape, rng):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(read_png(write_png(None, img)), img)


@pytest.mark.parametrize("nchan", [2, 3, 4])
def test_color_roundtrip(nchan, rng):
    img = rng.integers(0, 256, (21, 17, nchan), dtype=np.uint8)
    assert np.array_equal(read_png(write_png(None, img)), img)


def test_gray16_roundtrip(rng):
    img = rng.integers(0, 65536, (9, 13), dtype=np.uint16)
    assert np.array_equal(read_png(write_png(None, img)), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode_filtered(img, ftype):
    """Independent PNG encoder that applies ONE scanline filter type
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth, PNG spec 9.2) to every row
    of an 8-bit image with ``bpp`` bytes per pixel."""
    import struct
    import zlib

    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    rows = img.reshape(h, w * bpp).astype(int)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        out = []
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append((cur[i] - pred) & 0xFF)
        raw += bytes([ftype]) + bytes(out)

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_decode_reference_testdata(ftype, rng):
    """Decode PNGs built here with each of the five scanline filters, in
    the layouts the reference's testdata used: RGBA (L_00001.png), RGB
    (the Middlebury im0.png) and 8-bit gray (the fixture pairs)."""
    for shape in [(24, 31, 4), (17, 23, 3), (20, 33)]:
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = read_png(_encode_filtered(img, ftype))
        assert got.dtype == np.uint8
        assert np.array_equal(got.reshape(img.shape), img), (ftype, shape)


def test_invalid_file(tmp_path):
    p = tmp_path / "bad.png"
    p.write_bytes(b"not a png at all")
    with pytest.raises(PNGError):
        read_png(str(p))


def test_file_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (15, 23), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    assert np.array_equal(read_png(path), img)
