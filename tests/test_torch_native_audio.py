"""PyTorch port: native audio decoding (``audio/native_lib.py`` and the
port's own ``audio/native/omniaudio.cpp``) against the JAX package's.

Both libraries are built here with g++ from their own sources. Every input
is generated from a numpy seed: WAVs of each sample format the C++ parser
reads (16 kHz mono int16, 44.1 kHz stereo int16, 8-bit, 24-bit, 32-bit int,
32-bit and 64-bit float, ``WAVE_FORMAT_EXTENSIBLE``, an odd-sized extra
chunk before the data), synthetic MP3 frame headers and ID3 tags. The
port's samples, rates and durations must equal the JAX package's exactly.
"""

from __future__ import annotations

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from omnilingual_asr_torch.audio import decode as port_decode
from omnilingual_asr_torch.audio import native_lib as port_native
from omnilingual_asr_torch.config import PipelineConfig
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_tpu.audio import decode as jax_decode
from omnilingual_asr_tpu.audio import native_lib as jax_native

REPO = Path(__file__).resolve().parents[1]
SEED = 20_261_017
SR_ENGINE = 16_000


@pytest.fixture(autouse=True)
def native_libraries():
    """Both libraries, built at first use (not while this module is
    imported)."""
    if not (port_native.native_available()
            and jax_native.native_available()):
        pytest.skip("g++ cannot build the native omniaudio library here")


def _riff(fmt_body: bytes, data: bytes, extra: bytes = b"") -> bytes:
    chunks = b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body + extra
    chunks += b"data" + struct.pack("<I", len(data)) + data
    if len(data) & 1:
        chunks += b"\0"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _fmt(tag: int, channels: int, sr: int, bits: int) -> bytes:
    block = channels * bits // 8
    return struct.pack("<HHIIHH", tag, channels, sr, sr * block, block, bits)


def _extensible(subformat: int, channels: int, sr: int, bits: int) -> bytes:
    guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    return (_fmt(0xFFFE, channels, sr, bits)
            + struct.pack("<HHI", 22, bits, 3 if channels == 2 else 4)
            + struct.pack("<H", subformat) + guid_tail)


def _wav_cases():
    """name -> WAV bytes, from one seed."""
    rng = np.random.default_rng(SEED)

    def noise(n, scale):
        return rng.standard_normal(n) * scale

    i16 = lambda n: np.clip(noise(n, 6000), -32768, 32767).astype("<i2")
    cases = {}
    cases["mono16_16k"] = _riff(_fmt(1, 1, 16000, 16), i16(16000).tobytes())
    cases["stereo16_44k1"] = _riff(_fmt(1, 2, 44100, 16),
                                   i16(2 * 22050).tobytes())
    cases["u8_8k"] = _riff(
        _fmt(1, 1, 8000, 8),
        np.clip(noise(8001, 40) + 128, 0, 255).astype(np.uint8).tobytes())
    v24 = np.clip(noise(2 * 12000, 2e6), -(1 << 23),
                  (1 << 23) - 1).astype(np.int32)
    b24 = np.stack([(v24 >> s) & 0xFF for s in (0, 8, 16)],
                   axis=1).astype(np.uint8).tobytes()
    cases["s24_stereo_24k"] = _riff(_fmt(1, 2, 24000, 24), b24)
    cases["s32_mono_16k"] = _riff(
        _fmt(1, 1, 16000, 32),
        np.clip(noise(16000, 4e8), -2**31, 2**31 - 1).astype("<i4").tobytes())
    cases["f32_stereo_22k05"] = _riff(
        _fmt(3, 2, 22050, 32), noise(2 * 11025, 0.2).astype("<f4").tobytes())
    cases["f64_mono_16k"] = _riff(_fmt(3, 1, 16000, 64),
                                  noise(8000, 0.2).astype("<f8").tobytes())
    cases["extensible_s16_stereo_48k"] = _riff(
        _extensible(1, 2, 48000, 16), i16(2 * 24000).tobytes())
    cases["extensible_f32_mono_16k"] = _riff(
        _extensible(3, 1, 16000, 32), noise(16000, 0.2).astype("<f4").tobytes())
    # An odd-sized LIST chunk (5 bytes + 1 pad byte) between fmt and data.
    cases["odd_chunk_mono16_16k"] = _riff(
        _fmt(1, 1, 16000, 16), i16(12345).tobytes(),
        extra=b"LIST" + struct.pack("<I", 5) + b"INFOx\0")
    return cases


WAV_CASES = _wav_cases()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_wavs")
    out = {}
    for name, data in WAV_CASES.items():
        (d / f"{name}.wav").write_bytes(data)
        out[name] = d / f"{name}.wav"
    return out


@pytest.mark.parametrize("name", sorted(WAV_CASES))
def test_native_decode_equals_jax(wavs, name):
    """Same samples and rate as the JAX package's library, exactly, at the
    file's rate and resampled to the engine's."""
    for target in (0, SR_ENGINE):
        got = port_native.native_decode(wavs[name], target_sr=target)
        want = jax_native.native_decode(wavs[name], target_sr=target)
        assert got is not None and want is not None
        assert got[1] == want[1]
        assert got[0].dtype == want[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("name", sorted(WAV_CASES))
def test_decode_audio_equals_jax(wavs, name):
    got_x, got_sr = port_decode.decode_audio(wavs[name])
    want_x, want_sr = jax_decode.decode_audio(wavs[name])
    assert got_sr == want_sr
    np.testing.assert_array_equal(got_x, want_x)
    # The native parser reads what the Python one reads, to float32
    # rounding of the channel mean.
    py_x, py_sr = port_decode.decode_wav_bytes(wavs[name].read_bytes())
    assert py_sr == got_sr and len(py_x) == len(got_x)
    np.testing.assert_allclose(got_x, py_x, rtol=0, atol=2e-7)


@pytest.mark.parametrize("name", sorted(WAV_CASES))
def test_duration_equals_jax(wavs, name):
    got = port_decode.get_audio_duration(wavs[name])
    assert got == jax_decode.get_audio_duration(wavs[name])
    assert got == port_native.native_duration(wavs[name]) > 0


def _load_audio(engine_cls, path):
    eng = engine_cls.__new__(engine_cls)
    eng.config = PipelineConfig()
    return eng._load_audio(path)


def test_engine_load_audio_equals_jax_at_8k(tmp_path):
    """The engine's decode + resample of an 8 kHz file equals the JAX
    engine's, exactly (with libav both resample in libswresample)."""
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine

    rng = np.random.default_rng(SEED + 1)
    pcm = np.clip(rng.standard_normal(8000 * 3) * 5000, -32768,
                  32767).astype("<i2")
    p = tmp_path / "a8k.wav"
    p.write_bytes(_riff(_fmt(1, 1, 8000, 16), pcm.tobytes()))
    got = _load_audio(TranscriptionEngine, p)
    want = _load_audio(JaxEngine, p)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert abs(len(got) - 3 * SR_ENGINE) <= 64


def test_engine_load_audio_resamples_wav_only_build(tmp_path, monkeypatch):
    """A WAV-only build returns the file's own rate; the port's engine then
    resamples those samples with ``audio/resample.py`` (the JAX engine
    would pass them on at 8 kHz)."""
    from omnilingual_asr_torch import engine as port_engine
    from omnilingual_asr_torch.audio.resample import resample

    rng = np.random.default_rng(SEED + 2)
    pcm = np.clip(rng.standard_normal(8000) * 5000, -32768,
                  32767).astype("<i2")
    p = tmp_path / "b8k.wav"
    p.write_bytes(_riff(_fmt(1, 1, 8000, 16), pcm.tobytes()))
    native = port_native.native_decode(p)           # the file's own rate
    monkeypatch.setattr(port_engine, "native_decode",
                        lambda path, target_sr=0: native)
    got = _load_audio(TranscriptionEngine, p)
    np.testing.assert_array_equal(got, resample(native[0], 8000, SR_ENGINE))


def test_missing_and_garbage_raise_as_jax(tmp_path):
    junk = tmp_path / "junk.mp3"
    junk.write_bytes(b"not audio at all" * 100)
    junk_wav = tmp_path / "junk.wav"
    junk_wav.write_bytes(b"RIFF\0\0\0\0WAVEjunk" * 10)
    for path in (tmp_path / "nope.mp3", tmp_path / "nope.wav", junk,
                 junk_wav):
        assert port_native.native_decode(path) is None
        assert jax_native.native_decode(path) is None
        assert port_native.native_duration(path) is None
        with pytest.raises(Exception) as got:
            port_decode.decode_audio(path)
        with pytest.raises(Exception) as want:
            jax_decode.decode_audio(path)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
        assert port_decode.get_audio_duration(path) == \
            jax_decode.get_audio_duration(path) == 0.0


# ---------------------------------------------------------------------------
# MP3: frame headers, ID3, and (with libav) decoding
# ---------------------------------------------------------------------------

def _id3(size: int) -> bytes:
    syncsafe = bytes([(size >> s) & 0x7F for s in (21, 14, 7, 0)])
    return b"ID3\x04\x00\x00" + syncsafe + b"\0" * size


def _mp3_frames(n: int, *, mpeg1: bool = True, xing_frames=None,
                junk: bytes = b"") -> bytes:
    """``n`` silent Layer III frames (zero side info and main data), mono:
    MPEG-1 128 kb/s at 44.1 kHz or MPEG-2 64 kb/s at 22.05 kHz. With
    ``xing_frames`` the first frame carries a Xing header."""
    if mpeg1:
        hdr, size, side = bytes([0xFF, 0xFB, 0x90, 0xC0]), 417, 17
    else:
        hdr, size, side = bytes([0xFF, 0xF3, 0x80, 0xC0]), 208, 9
    frame = hdr + b"\0" * (size - 4)
    out = bytearray(junk)
    for i in range(n):
        f = bytearray(frame)
        if i == 0 and xing_frames is not None:
            f[4 + side:4 + side + 12] = (b"Xing" + struct.pack(">I", 1)
                                         + struct.pack(">I", xing_frames))
        out += f
    return bytes(out)


MP3_CASES = {
    "cbr_mpeg1": _id3(37) + _mp3_frames(60),
    "cbr_mpeg2": _mp3_frames(40, mpeg1=False),
    "xing_mpeg1": _id3(10) + _mp3_frames(30, xing_frames=1234),
    "junk_then_frames": _mp3_frames(20, junk=b"\xff\x00\xff\xe2\x12" * 3),
    "layer2_only": bytes([0xFF, 0xFD, 0x90, 0xC0]) + b"\0" * 400,
    "no_frames": _id3(5) + b"\x00" * 300,
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(MP3_CASES))
def test_skip_id3_and_mp3_estimate_equal_jax(tmp_path, name):
    data = MP3_CASES[name]
    assert port_decode._skip_id3(data) == jax_decode._skip_id3(data)
    p = tmp_path / f"{name}.mp3"
    p.write_bytes(data)
    got = port_decode._mp3_duration_estimate(p)
    assert got == jax_decode._mp3_duration_estimate(p)
    if name == "xing_mpeg1":
        assert got == 1234 * 1152 / 44100
    if name == "cbr_mpeg1":
        assert got == pytest.approx(60 * 417 * 8 / 128000)


def test_mp3_decode_equals_jax(tmp_path):
    """With libav linked, both libraries decode the same MP3 to the same
    samples and durations; the WAV-only build skips this case."""
    if not port_native.native_build().libav:
        pytest.skip("the native library was built without libav (WAV only)")
    p = tmp_path / "silence.mp3"
    p.write_bytes(MP3_CASES["cbr_mpeg1"])
    for target in (0, SR_ENGINE):
        got = port_native.native_decode(p, target_sr=target)
        want = jax_native.native_decode(p, target_sr=target)
        assert got is not None and want is not None
        assert got[1] == want[1] == (target or 44100)
        np.testing.assert_array_equal(got[0], want[0])
    x, sr = port_decode.decode_audio(p)
    assert abs(len(x) - 60 * 1152) <= 1152 and not np.any(x)
    assert port_decode.get_audio_duration(p) == \
        jax_decode.get_audio_duration(p) > 0


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------

def test_library_builds_in_build_dir_only():
    """The library lives under ``omnilingual_asr_torch/_build/``, keyed by
    the source's hash; the source directory holds only the source."""
    info = port_native.native_build()
    assert info.lib_path.is_file()
    assert info.lib_path.parent.parent == port_native.BUILD_ROOT
    assert info.lib_path.parent == port_native.build_dir()
    native_dir = REPO / "omnilingual_asr_torch" / "audio" / "native"
    assert sorted(p.name for p in native_dir.iterdir()) == ["omniaudio.cpp"]
    assert port_native.SOURCE.parent == native_dir


def test_flag_chain_falls_back_to_wav_only(tmp_path, monkeypatch):
    """A flag set that does not compile falls through to the next one, as
    in the JAX loader: here to the WAV-only build."""
    monkeypatch.setattr(port_native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(port_native, "_flag_chain",
                        lambda: [["-fno-such-flag"], []])
    info = port_native.build()
    assert info is not None and not info.cached and not info.libav
    assert info.flags == [] and info.lib_path.parent.parent == tmp_path
    again = port_native.build()
    assert again.cached and again.lib_path == info.lib_path


def test_no_flag_set_compiles(tmp_path, monkeypatch):
    monkeypatch.setattr(port_native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(port_native, "_flag_chain",
                        lambda: [["-fno-such-flag"]])
    assert port_native.build() is None
    assert not list(tmp_path.rglob("*.so"))


def test_disable_native_falls_back_to_python(tmp_path):
    """``OMNIASR_DISABLE_NATIVE`` turns the library off: WAV still decodes
    through the Python parser, MP3 raises as in JAX."""
    p = tmp_path / "m.wav"
    p.write_bytes(WAV_CASES["stereo16_44k1"])
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "from omnilingual_asr_torch.audio import decode, native_lib\n"
        "assert not native_lib.native_available()\n"
        "assert native_lib.native_build() is None\n"
        "x, sr = decode.decode_audio(%r)\n"
        "y, _ = decode.decode_wav_bytes(open(%r, 'rb').read())\n"
        "assert sr == 44100 and np.array_equal(x, y)\n"
        "try:\n"
        "    decode.decode_audio(%r)\n"
        "except ValueError as e:\n"
        "    print(e)\n" % (str(REPO), str(p), str(p), str(tmp_path / "a.mp3")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"OMNIASR_DISABLE_NATIVE": "1", "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr
    assert "native omniaudio library unavailable for .mp3" in out.stdout
