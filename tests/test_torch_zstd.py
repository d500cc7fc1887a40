"""PyTorch port: the zstd decoder (``checkpoint/zstd.py``, a binding to the
system's libzstd) held to the ``zstandard`` module byte for byte on every
kind of frame, corrupt frames refused, and its CRC-32C held to
``google_crc32c``."""

from __future__ import annotations

import functools
import struct

import numpy as np
import pytest
import zstandard

from omnilingual_asr_torch.checkpoint import zstd

LEVELS = (1, 3, 19, -5)
KINDS = ("empty", "zeros", "text", "f32", "f16_widened")


@functools.lru_cache(maxsize=None)
def _data(kind: str, big: bool = False) -> bytes:
    rng = np.random.default_rng(0)
    n = (1 << 19) if big else (1 << 16)          # float32 elements
    if kind == "empty":
        return b""
    if kind == "zeros":
        return bytes(4 * n * (4 if big else 1))
    if kind == "text":
        words = [b"checkpoint", b"orbax", b"zarr", b"the", b"of", b"and",
                 b"\xc3\xa9t\xc3\xa9", b"\n", b"tensor", b"layer", b"0.5"]
        idx = rng.integers(0, len(words), 4 * n // 5)
        return b" ".join(words[i] for i in idx)
    x = rng.standard_normal(n).astype(np.float32)
    if kind == "f16_widened":
        x = x.astype(np.float16).astype(np.float32)
    return x.tobytes()


def _compress(data: bytes, level: int, checksum: bool, size: bool) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=size).compress(data)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_matches_zstandard(kind, level):
    """Every combination of content checksum and content size, and a
    streamed compressor (no content size, blocks as they fill), decodes to
    the input exactly."""
    data = _data(kind)
    for checksum in (True, False):
        for size in (True, False):
            frame = _compress(data, level, checksum, size)
            assert zstd.decompress(frame) == data, (checksum, size)
            assert zstd.content_size(frame) == (len(data) if size else None)
    obj = zstandard.ZstdCompressor(level=level, write_checksum=True) \
        .compressobj()
    streamed = b"".join(obj.compress(data[i:i + 50_000])
                        for i in range(0, len(data), 50_000)) + obj.flush()
    assert zstd.decompress(streamed) == data


@pytest.mark.parametrize("kind", ["zeros", "f32", "text"])
def test_large_inputs_and_windows(kind):
    """A few MB at level 1 and 3, with windows beyond 128 KB, into a fixed
    destination too."""
    data = _data(kind, big=True)
    for level in (1, 3):
        frame = _compress(data, level, True, False)
        assert zstd.decompress(frame) == data
        out = np.empty(len(data), np.uint8)
        zstd.decompress_into(frame, out)
        assert out.tobytes() == data
    params = zstandard.ZstdCompressionParameters.from_level(
        3, window_log=22)
    frame = zstandard.ZstdCompressor(compression_params=params) \
        .compress(data)
    assert zstd.decompress(frame) == data


def test_concatenated_and_skippable_frames():
    """Frames one after another decode to their contents in order;
    skippable frames (any of the 16 magics) are skipped."""
    a, b, c = _data("text")[:70_000], _data("f32")[:9_000], b""
    skip = struct.pack("<II", 0x184D2A5B, 5) + b"hello"
    frames = (_compress(a, 3, True, True) + skip
              + _compress(b, 1, False, False) + _compress(c, 1, True, True)
              + struct.pack("<II", 0x184D2A50, 0))
    assert zstd.decompress(frames) == a + b + c
    assert zstd.content_size(frames) is None


def _rare(name: str) -> bytes:
    """Inputs whose frames take a decoder's rarer paths: 16 random symbols
    give Huffman weights in direct (4-bit) form; words over several blocks
    reuse the previous block's table (treeless literals); records that
    repeat themselves shifted by a byte give a repeat offset of
    rep[0] - 1."""
    rng = np.random.default_rng(3)
    if name == "direct_weights":
        return rng.integers(0, 16, 20_000, dtype=np.uint8).tobytes()
    if name == "treeless_literals":
        words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                    dtype=np.uint8)) for _ in range(50)]
        return b" ".join(words[i] for i in rng.integers(0, 50, 60_000))
    recs = []
    for _ in range(3000):
        r = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
        recs.append(r + r[1:] + r[2:])
    return b"".join(recs)


@pytest.mark.parametrize("name,level", [("direct_weights", 3),
                                        ("treeless_literals", 1),
                                        ("repeat_offset_minus_one", 19)])
def test_rare_paths(name, level):
    data = _rare(name)
    assert zstd.decompress(_compress(data, level, True, True)) == data


def _corrupt(name: str) -> bytes:
    data = _data("f32")[:100_000]
    if name == "bad_magic":
        return b"\x29" + _compress(data, 3, True, True)[1:]
    if name == "truncated":
        frame = _compress(data, 3, True, True)
        return frame[:len(frame) // 2]
    if name == "checksum":
        frame = bytearray(_compress(data, 3, True, True))
        frame[-1] ^= 0x40
        return bytes(frame)
    if name == "beyond_declared_size":
        # A raw block longer than the frame header's content size.
        return (struct.pack("<I", 0xFD2FB528) + bytes([0x20, 4])
                + bytes([(8 << 3) | 1, 0, 0]) + b"12345678")
    if name == "compressed_beyond_declared_size":
        # A compressed frame whose header declares 1000 bytes fewer than
        # its blocks hold.
        frame = bytearray(_compress(data, 3, True, True))
        fhd = frame[4]
        at = 5 + (0 if fhd & 0x20 else 1) + (0, 1, 2, 4)[fhd & 3]
        width = ((1 if fhd & 0x20 else 0), 2, 4, 8)[fhd >> 6]
        assert width == 4
        frame[at:at + 4] = struct.pack("<I", len(data) - 1000)
        return bytes(frame)
    if name == "reserved_block":
        return (struct.pack("<I", 0xFD2FB528) + bytes([0x00, 0x00])
                + bytes([(3 << 1) | 1, 0, 0]))
    # A flipped body byte in a checksummed frame (without the checksum a
    # frame may decode to other bytes without error: RFC 8878 3.1.1).
    frame = bytearray(_compress(data, 3, True, True))
    frame[len(frame) // 2] ^= 0xFF
    return bytes(frame)


@pytest.mark.parametrize("name", ["bad_magic", "truncated", "checksum",
                                  "beyond_declared_size",
                                  "compressed_beyond_declared_size",
                                  "reserved_block", "flipped_body_byte"])
def test_corrupt_frames_raise(name):
    """Corrupt input raises ValueError (never a crash or silent output)."""
    with pytest.raises(ValueError):
        zstd.decompress(_corrupt(name))


def test_destination_size_is_enforced():
    data = _data("text")
    frame = _compress(data, 3, False, False)
    with pytest.raises(ValueError):
        zstd.decompress_into(frame, np.empty(len(data) - 1, np.uint8))
    with pytest.raises(ValueError):
        zstd.decompress_into(frame, np.empty(len(data) + 1, np.uint8))


def test_checksums():
    """CRC-32C against google_crc32c (split and whole)."""
    import google_crc32c

    for n in (0, 1, 7, 8, 9, 1000, 65_537):
        data = _data("text")[:n]
        assert zstd.crc32c(data) == google_crc32c.value(data)
        assert zstd.crc32c(data[n // 3:], zstd.crc32c(data[:n // 3])) == \
            google_crc32c.value(data)
