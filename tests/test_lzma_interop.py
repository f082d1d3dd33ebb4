"""LZMA interop against the REFERENCE's own encoded streams.

Round 1 only round-tripped the stdlib wrapper through itself; these tests
prove container compatibility with the reference implementation
(``pkg/lzma``) the way its own suite does: the embedded golden
byte-vectors of ``pkg/lzma/decoder_test.go:13-60`` (both known-size and
unknown-size header modes) must decode to the exact raw strings.

The reverse direction (our encoder -> compatible container) is checked
structurally: classic .lzma header layout plus decodability in both size
modes.
"""

import pytest

from steroscopic_hardware_tpu.io import lzma_codec

# Embedded golden vectors from the reference's pkg/lzma/decoder_test.go
# (lzmaTests, encoder_test.go:124-186) — the container bit-contract.
GOLDEN = [
    # (desc, raw, lzma bytes)
    (
        "empty, size known",
        b"",
        bytes([
            0x5D, 0x00, 0x00, 0x10, 0x00, 0x00, 0x00, 0x00,
            0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
            0x00, 0x00,
        ]),
    ),
    (
        "empty, size unknown",
        b"",
        bytes([
            0x5D, 0x00, 0x00, 0x10, 0x00, 0xFF, 0xFF, 0xFF,
            0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0x00, 0x83, 0xFF,
            0xFB, 0xFF, 0xFF, 0xC0, 0x00, 0x00, 0x00,
        ]),
    ),
    (
        "hello world, size known",
        b"hello world\n",
        bytes([
            0x5D, 0x00, 0x00, 0x10, 0x00, 0x0C, 0x00, 0x00,
            0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x34, 0x19,
            0x49, 0xEE, 0x8D, 0xE9, 0x17, 0x89, 0x3A, 0x33,
            0x5F, 0xFC, 0xAC, 0xF7, 0x20, 0x00,
        ]),
    ),
    (
        "hello world, size unknown",
        b"hello world\n",
        bytes([
            0x5D, 0x00, 0x00, 0x10, 0x00, 0xFF, 0xFF, 0xFF,
            0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0x00, 0x34, 0x19,
            0x49, 0xEE, 0x8D, 0xE9, 0x17, 0x89, 0x3A, 0x33,
            0x5F, 0xFC, 0xB2, 0x09, 0x82, 0x2F, 0xFF, 0xFD,
            0xE2, 0x80, 0x00,
        ]),
    ),
]


@pytest.mark.parametrize("desc,raw,blob", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_decode_reference_golden_vectors(desc, raw, blob):
    assert lzma_codec.decompress(blob) == raw


def test_our_streams_use_the_reference_container():
    """Structural compatibility of our encoder's output: classic .lzma
    13-byte header (props byte with valid lc/lp/pb, little-endian dict
    size, 8-byte size field: 0xFF..FF unknown / exact length known), and
    decodable in both modes."""
    payload = b"connerohnesorge" * 3  # encoder_test.go:82 payload
    for level in (1, 5, 9):
        blob = lzma_codec.compress(payload, level=level)
        props = blob[0]
        assert props < 9 * 5 * 5  # lc/lp/pb in range (0x5d default)
        assert blob[5:13] == b"\xff" * 8
        assert lzma_codec.decompress(blob) == payload

        known = lzma_codec.compress_known_size(payload, level=level)
        assert int.from_bytes(known[5:13], "little") == len(payload)
        assert lzma_codec.decompress(known) == payload
