"""In-process audio decoding for the PyTorch port: the port's own copy of
``omnilingual_asr_tpu/audio/decode.py`` (the port imports nothing of the JAX
package); keep the two in step.

Dispatch order per file:
1. the native C++ ``omniaudio`` library (WAV natively; MP3/FLAC/OGG/M4A/AAC/
   AIFF through libav where the build links it), loaded via ctypes from
   ``native_lib.py``;
2. pure-Python fallbacks (WAV/AIFF via stdlib) so the package works even
   when the native library cannot be built.

All decoders return ``(samples, sample_rate)`` where ``samples`` is a mono
float32 numpy array in [-1, 1].
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

from .native_lib import native_available, native_decode, native_duration

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
    """Decode any supported audio file to (mono float32, sample_rate).

    Replaces the ffmpeg decode path of the reference (gemini_pipeline.py:273-301)
    with in-process native decoding.
    """
    path = Path(path)
    ext = path.suffix.lower()
    if native_available():
        out = native_decode(path)
        if out is not None:
            return out
    if ext == ".wav":
        return decode_wav_bytes(path.read_bytes())
    if ext in (".aiff", ".aif"):
        return _decode_aiff(path)
    raise ValueError(
        f"cannot decode {path.name!r}: native omniaudio library unavailable "
        f"for {ext} and no pure-Python fallback exists"
    )


def get_audio_duration(audio_path: str | Path) -> float:
    """Audio duration in seconds — header-only probe where possible.

    Behavior-compatible with the reference's ffprobe wrapper
    (gemini_pipeline.py:222-240): returns 0.0 on any failure instead of
    raising, which downstream uses to mean "treat as short file".
    """
    path = Path(audio_path)
    try:
        if not path.exists():
            return 0.0
        if native_available():
            d = native_duration(path)
            if d is not None and d > 0:
                return d
        ext = path.suffix.lower()
        if ext == ".wav":
            data = path.read_bytes()
            (fmt, _, size) = _parse_wav_header(data)
            audio_format, channels, sample_rate, bits = fmt
            bytes_per_frame = max(1, channels * (bits // 8))
            return size / bytes_per_frame / float(sample_rate)
        if ext in (".aiff", ".aif"):
            _, n_frames, _, sr, _, _ = _parse_aiff_header(path.read_bytes())
            return n_frames / float(sr)
        if ext == ".mp3":
            return _mp3_duration_estimate(path)
        # Unknown container: decode fully as a last resort.
        samples, sr = decode_audio(path)
        return len(samples) / float(sr)
    except Exception:
        return 0.0


_MP3_BITRATES_V1L3 = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320]
_MP3_BITRATES_V2L3 = [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160]
_MP3_RATES = {3: [44100, 48000, 32000], 2: [22050, 24000, 16000], 0: [11025, 12000, 8000]}


def _skip_id3(data: bytes) -> int:
    if data[:3] == b"ID3" and len(data) > 10:
        size = (
            (data[6] & 0x7F) << 21
            | (data[7] & 0x7F) << 14
            | (data[8] & 0x7F) << 7
            | (data[9] & 0x7F)
        )
        return 10 + size
    return 0


def _mp3_duration_estimate(path: Path) -> float:
    """Estimate MP3 duration from the first frame header (Xing/VBRI-aware
    for VBR, bitrate extrapolation for CBR)."""
    data = path.read_bytes()
    pos = _skip_id3(data)
    n = len(data)
    while pos + 4 <= n:
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            h1 = data[pos + 1]
            version = (h1 >> 3) & 0x3  # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
            layer = (h1 >> 1) & 0x3
            if version == 1 or layer != 1:  # only Layer III
                pos += 1
                continue
            h2 = data[pos + 2]
            br_idx = (h2 >> 4) & 0xF
            sr_idx = (h2 >> 2) & 0x3
            if br_idx in (0, 15) or sr_idx == 3:
                pos += 1
                continue
            sr = _MP3_RATES[version][sr_idx]
            mpeg1 = version == 3
            bitrate = (_MP3_BITRATES_V1L3 if mpeg1 else _MP3_BITRATES_V2L3)[br_idx] * 1000
            samples_per_frame = 1152 if mpeg1 else 576
            # Xing/Info header: frame count at a version/mode-dependent
            # offset (side-info size: MPEG1 32 B stereo / 17 B mono;
            # MPEG2 17 B stereo / 9 B mono).
            h3 = data[pos + 3]
            mode = (h3 >> 6) & 0x3
            side_len = (32 if mode != 3 else 17) if mpeg1 else \
                (17 if mode != 3 else 9)
            xing_off = pos + 4 + side_len
            if data[xing_off:xing_off + 4] in (b"Xing", b"Info"):
                flags = struct.unpack_from(">I", data, xing_off + 4)[0]
                if flags & 1:
                    frames = struct.unpack_from(">I", data, xing_off + 8)[0]
                    return frames * samples_per_frame / float(sr)
            audio_bytes = n - pos
            return audio_bytes * 8.0 / bitrate if bitrate else 0.0
        pos += 1
    return 0.0
