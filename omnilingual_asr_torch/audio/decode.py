"""In-process audio decoding for the PyTorch port: the pure-Python WAV and
AIFF paths of ``omnilingual_asr_tpu/audio/decode.py``.

The JAX package first tries its C++ ``omniaudio`` library (WAV/MP3/FLAC/
AIFF); porting that decoder is a later slice, so here only the stdlib
paths exist and other containers raise.

All decoders return ``(samples, sample_rate)`` where ``samples`` is a mono
float32 numpy array in [-1, 1].
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

# MIME map, behavior-compatible with reference gemini_pipeline.py:106-118.
MIME_TYPES = {
    ".wav": "audio/wav",
    ".mp3": "audio/mp3",
    ".aiff": "audio/aiff",
    ".aac": "audio/aac",
    ".ogg": "audio/ogg",
    ".flac": "audio/flac",
    ".m4a": "audio/mp4",
}

SUPPORTED_EXTENSIONS = set(MIME_TYPES)


def get_mime_type(file_path: Path | str) -> str:
    """MIME type by extension (reference gemini_pipeline.py:106-118)."""
    return MIME_TYPES.get(Path(file_path).suffix.lower(), "audio/wav")


# ---------------------------------------------------------------------------
# Pure-Python WAV (RIFF) parsing
# ---------------------------------------------------------------------------

def _parse_wav_header(data: bytes):
    """Parse a RIFF/WAVE header. Returns (fmt, data_offset, data_size).

    fmt = (audio_format, channels, sample_rate, bits_per_sample)
    """
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if chunk_id == b"fmt ":
            audio_format, channels, sample_rate = struct.unpack_from("<HHI", data, body)
            (bits,) = struct.unpack_from("<H", data, body + 14)
            if audio_format == 0xFFFE and chunk_size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack_from("<H", data, body + 24)
            fmt = (audio_format, channels, sample_rate, bits)
        elif chunk_id == b"data":
            if fmt is None:
                raise ValueError("WAV data chunk before fmt chunk")
            size = min(chunk_size, len(data) - body)
            return fmt, body, size
        pos = body + chunk_size + (chunk_size & 1)
    raise ValueError("WAV file has no data chunk")


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a WAV byte buffer to (mono float32, sample_rate)."""
    (audio_format, channels, sample_rate, bits), off, size = _parse_wav_header(data)
    raw = data[off:off + size]
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV audio format: {audio_format}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sample_rate


def _read_extended80(b: bytes) -> float:
    """IEEE 754 80-bit extended float (big-endian) — AIFF sampleRate field."""
    if len(b) < 10:
        raise ValueError("truncated extended float")
    (exp_sign,) = struct.unpack_from(">H", b, 0)
    (mant,) = struct.unpack_from(">Q", b, 2)
    sign = -1.0 if exp_sign & 0x8000 else 1.0
    exponent = exp_sign & 0x7FFF
    if exponent == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (exponent - 16383 - 63)


def _parse_aiff_header(data: bytes):
    """Parse AIFF/AIFC chunks. Returns (channels, n_frames, bits, sr,
    compression, ssnd_data_offset).

    Direct big-endian IFF parse — the stdlib `aifc` module was removed in
    Python 3.13 (ADVICE r1).
    """
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError("not an AIFF/AIFC file")
    pos = 12
    comm = None
    ssnd = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        body = pos + 8
        if cid == b"COMM":
            channels, n_frames, bits = struct.unpack_from(">HIH", data, body)
            sr = _read_extended80(data[body + 8:body + 18])
            compression = data[body + 18:body + 22] if size > 18 else b"NONE"
            comm = (channels, n_frames, bits, sr, compression)
        elif cid == b"SSND":
            (offset,) = struct.unpack_from(">I", data, body)
            ssnd = body + 8 + offset
        pos = body + size + (size & 1)
    if comm is None or ssnd is None:
        raise ValueError("AIFF missing COMM or SSND chunk")
    return (*comm, ssnd)


def _decode_aiff(path: Path) -> Tuple[np.ndarray, int]:
    data = path.read_bytes()
    channels, n_frames, bits, sr, compression, off = _parse_aiff_header(data)
    if compression not in (b"NONE", b"sowt"):
        raise ValueError(f"unsupported AIFC compression: {compression!r}")
    le = compression == b"sowt"  # AIFC little-endian PCM variant
    width = (bits + 7) // 8
    raw = data[off:off + n_frames * channels * width]
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2" if le else ">i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3)
        if le:
            b = b[:, ::-1]
        vals = (
            (b[:, 0].astype(np.int32) << 16)
            | (b[:, 1].astype(np.int32) << 8)
            | b[:, 2].astype(np.int32)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4" if le else ">i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported AIFF sample width: {width}")
    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels).mean(axis=1)
    sr_int = int(round(sr))
    if sr_int <= 0:
        raise ValueError("invalid AIFF sample rate")
    return np.ascontiguousarray(x, dtype=np.float32), sr_int


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def decode_audio(path: str | Path) -> Tuple[np.ndarray, int]:
    """Decode a WAV or AIFF file to (mono float32, sample_rate)."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".wav":
        return decode_wav_bytes(path.read_bytes())
    if ext in (".aiff", ".aif"):
        return _decode_aiff(path)
    raise ValueError(
        f"cannot decode {path.name!r}: the port decodes WAV and AIFF only "
        f"(the native omniaudio decoder is not ported yet)")


def get_audio_duration(audio_path: str | Path) -> float:
    """Audio duration in seconds from the WAV/AIFF header; 0.0 on any
    failure, which downstream reads as "treat as a short file"."""
    path = Path(audio_path)
    try:
        ext = path.suffix.lower()
        if ext == ".wav":
            (fmt, _, size) = _parse_wav_header(path.read_bytes())
            audio_format, channels, sample_rate, bits = fmt
            bytes_per_frame = max(1, channels * (bits // 8))
            return size / bytes_per_frame / float(sample_rate)
        if ext in (".aiff", ".aif"):
            _, n_frames, _, sr, _, _ = _parse_aiff_header(path.read_bytes())
            return n_frames / float(sr)
        return 0.0
    except (OSError, ValueError, struct.error, ZeroDivisionError):
        return 0.0
