"""PyTorch port: one ``TranscriptionEngine`` serving several threads at once.

The server runs up to four transcriptions at once on one engine, one thread
each. The port's decoders replay a CUDA graph over static buffers shared by
every decode of one shape, so the engine holds one lock around the work
that shares device state: the batched device program and the decoders.

On the CPU the decoders run eagerly; here they rehearse the card's graph
path instead (``GreedyDecoder._capture`` patched to replay the step over
the shared static buffers), which is where two unlocked threads overwrite
each other's inputs and read each other's tokens. A tiny config with a
random text translator and summarizer keeps the test small.
"""

from __future__ import annotations

import dataclasses
import io
import sys
import threading
import time
import warnings
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_torch.models import translation as ptr

torch.set_num_threads(2)

SEED = 31_337
SECONDS = (3.0, 5.5, 8.0, 12.5)     # four different files


class _Replay:
    """Stands in for a captured graph: replays the step over the decode
    state's static buffers, as the card's graph does."""

    def __init__(self, decoder, state):
        self.decoder, self.state = decoder, state

    def replay(self):
        self.decoder._step(self.state)
        time.sleep(0)               # let another thread run between steps


def _wav(path: Path, seconds: float, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16_000)
    t = np.arange(n) / 16_000
    x = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
         * (1 + np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
         + 0.05 * rng.standard_normal(n))
    pcm = np.clip(x * 32767, -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.tobytes())
    path.write_bytes(buf.getvalue())
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("threads")
    return [_wav(d / f"f{i}.wav", s, SEED + i)
            for i, s in enumerate(SECONDS)]


@pytest.fixture(scope="module")
def engine():
    # No LID confidence gate: every segment of the random model gets its
    # argmax language, so the non-English ones go to the translator.
    cfg = tiny_config()
    cfg = cfg.replace(decode=dataclasses.replace(cfg.decode,
                                                 lid_conf_threshold=0.0))
    gen = torch.Generator().manual_seed(SEED)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOM-INIT")
        eng = TranscriptionEngine(
            config=cfg, device="cpu", speaker_mode="inline",
            translator_params=ptr.text_translator_init(gen, cfg, n_layers=2),
            summarizer_params=ptr.translator_init(gen, cfg, n_layers=2))
    eng._translator.use_graph = True
    eng._summarizer.decoder.use_graph = True
    return eng


@pytest.fixture(autouse=True)
def rehearsed_graphs(monkeypatch):
    monkeypatch.setattr(ptr.GreedyDecoder, "_capture",
                        lambda self, s: _Replay(self, s))


@pytest.fixture(scope="module")
def alone(engine, files):
    """Each file transcribed alone, and the decoder of every decode."""
    calls = []
    plain = ptr.GreedyDecoder.decode

    def counted(self, *a, **kw):
        calls.append(self)
        return plain(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptr.GreedyDecoder, "_capture",
                   lambda self, s: _Replay(self, s))
        mp.setattr(ptr.GreedyDecoder, "decode", counted)
        results = [engine.transcribe(p).to_dict() for p in files]
    return results, calls


def test_files_decode_something(engine, files, alone):
    """The files give the decoders work: translated segments and a summary
    decode on every file."""
    results, calls = alone
    assert all(r["segments"] for r in results)
    assert sum(c is engine._translator for c in calls) >= len(files)
    assert sum(c is engine._summarizer.decoder for c in calls) == len(files)
    assert any(s["translation"] for r in results for s in r["segments"])


def test_four_threads_equal_alone(engine, files, alone):
    """Four threads transcribe four files on one engine; each result equals
    the same file transcribed alone, exactly."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)        # switch threads often
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            got = list(pool.map(lambda p: engine.transcribe(p).to_dict(),
                                files, timeout=600))
    finally:
        sys.setswitchinterval(interval)
    assert got == alone[0]


def test_device_work_is_exclusive(engine, files, monkeypatch):
    """At most one thread at a time runs the device program or a decode,
    and each of them runs under the engine's lock."""
    inside, peak, unlocked = [0], [0], []
    guard = threading.Lock()

    def tracked(fn):
        def run(*a, **kw):
            with guard:
                inside[0] += 1
                peak[0] = max(peak[0], inside[0])
                if not engine._device_lock.locked():
                    unlocked.append(fn.__name__)
            try:
                time.sleep(0.002)
                return fn(*a, **kw)
            finally:
                with guard:
                    inside[0] -= 1
        return run

    monkeypatch.setattr(engine, "_process", tracked(engine._process))
    monkeypatch.setattr(ptr.GreedyDecoder, "decode",
                        tracked(ptr.GreedyDecoder.decode))
    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(engine.transcribe, files, timeout=600))
    assert peak[0] == 1
    assert unlocked == []


def test_lock_is_free_between_requests(engine, files):
    engine.transcribe(files[0])
    assert not engine._device_lock.locked()
    with pytest.raises(Exception):
        engine.transcribe(files[0].with_name("missing.wav"))
    assert not engine._device_lock.locked()
