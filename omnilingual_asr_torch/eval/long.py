"""Measured long-file run through the port's engine: N hours of synthetic
audio end to end (the streamed-WAV path above the chunking threshold),
reporting wall time, CPU seconds, the real-time factor, the StageTrace
stages, the process's peak RSS during the timed run (and its RSS before
it) and the card's peak memory. The port's copy of the root
``eval_long.py``, on one card; the JAX driver's 8-chip projection models
TPU data parallelism (A10 in ROADMAP.md) and is left out.

    python -m omnilingual_asr_torch.eval.long --hours 9.5          # the card
    python -m omnilingual_asr_torch.eval.long --device cpu --tiny --hours 0.2
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import tempfile
import threading
import time
import wave
from pathlib import Path
from typing import Optional

import numpy as np

from .harness import add_device_arg, driver_config

#: The north star's wall-time target for 9.5 h of audio (BASELINE.md).
TARGET_S = 120.0
#: Interval of the resident-set samples taken during the timed run.
RSS_SAMPLE_S = 0.05


def make_long_audio(seconds: float, path: str | Path,
                    sr: int = 16000) -> str:
    """Speech-like multi-speaker audio written as 16-bit WAV, chunked so the
    writer stays under a few hundred MB of RAM."""
    rng = np.random.default_rng(0)
    n = int(seconds * sr)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        chunk = 60 * sr
        t0 = 0
        while t0 < n:
            m = min(chunk, n - t0)
            t = (t0 + np.arange(m)) / sr
            f0 = 110 + 60 * np.sin(2 * np.pi * 0.013 * t)  # slow speaker drift
            x = 0.3 * np.sin(2 * np.pi * f0 * t) \
                + 0.12 * np.sin(2 * np.pi * 2.1 * f0 * t)
            gate = (np.sin(2 * np.pi * 0.21 * t) > -0.6)
            x = x * gate + 0.03 * rng.standard_normal(m)
            w.writeframes((np.clip(x, -1, 1) * 20000).astype("<i2").tobytes())
            t0 += m
    return str(path)


def warm_up(engine, folder: Path) -> None:
    """One transcribe of a batch of windows, so the timed run is steady
    state (kernels built and loaded, CUDA graphs of the decoders captured
    at their first shapes)."""
    warm = make_long_audio(engine.window_samples / 16000 * engine.batch_size,
                           folder / "warm.wav")
    engine.transcribe(warm)


def _rss_gb() -> Optional[float]:
    """The process's resident set now (Linux), None elsewhere."""
    try:
        pages = int(Path("/proc/self/statm").read_text().split()[1])
    except OSError:
        return None
    return pages * resource.getpagesize() / (1 << 30)


class _PeakRss:
    """The largest resident set sampled every RSS_SAMPLE_S within the
    block (``peak``, GB). Sampled, because ``ru_maxrss`` (and, on some
    kernels, VmHWM) carries a parent process's peak across fork and exec;
    without ``/proc`` it falls back to ``ru_maxrss``."""

    def __init__(self):
        self.peak = _rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def _sample(self):
        while not self._stop.wait(RSS_SAMPLE_S):
            self.peak = max(self.peak, _rss_gb())

    def __enter__(self):
        if self.peak is not None:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self.peak is None:
            kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            self.peak = kb / (1 << 30) * (1 if sys.platform == "darwin"
                                          else 1024)
            return
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gb())


def long_report(engine, path, seconds: float, hours: float):
    """Transcribe ``path`` (``seconds`` of audio) once, timed: the driver's
    report and the result."""
    import torch

    on_cuda = engine.device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    rss_before = _rss_gb()
    with _PeakRss() as rss:
        t0 = time.perf_counter()
        c0 = time.process_time()
        result = engine.transcribe(path)
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
    trace = engine.last_trace
    stage_s = ({name: round(s, 2) for name, s in trace.stages.items()}
               if trace is not None else {})
    report = {
        "metric": "long_file_wall_s",
        "audio_hours": hours,
        "backend": (torch.cuda.get_device_name(engine.device) if on_cuda
                    else engine.device.type),
        "n_chips": 1,
        "wall_s": round(wall, 2),
        # Total process CPU seconds: on a shared host the contention-robust
        # cost of the host side, which wall time is not.
        "cpu_s": round(cpu, 2),
        "rtf": round(seconds / wall, 1),
        "stages_s": stage_s,
        "target_s": TARGET_S,
        "n_segments": len(result.segments),
        "n_speakers": len({s.speaker for s in result.segments}),
        # The process's peak RSS during this transcribe, beside its RSS
        # before it (model, CUDA context, the warm-up).
        "peak_rss_gb": round(rss.peak, 3),
        "rss_before_gb": (round(rss_before, 3) if rss_before is not None
                          else None),
        "device_peak_gb": (round(torch.cuda.max_memory_allocated(
            engine.device) / 2**30, 3) if on_cuda else None),
    }
    return report, result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hours", type=float, default=9.5)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model (mechanics run)")
    ap.add_argument("--batch-windows", type=int, default=8)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..engine import TranscriptionEngine

    seconds = args.hours * 3600
    engine = TranscriptionEngine(config=driver_config(args.tiny),
                                 batch_windows_per_device=args.batch_windows,
                                 device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        warm_up(engine, Path(tmp))
        path = make_long_audio(seconds, Path(tmp) / "long.wav")
        report, _ = long_report(engine, path, seconds, args.hours)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
