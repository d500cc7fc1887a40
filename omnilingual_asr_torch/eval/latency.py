"""Batch-1 latency: one 30 s window end to end through the port's engine
(host decode, the log-mel kernel, the conformer and heads, assembly),
reported as the median and best wall latency of ``--reps`` requests and
the median's real-time factor. The port's copy of the root
``eval_latency.py``.

The row is the flagship ``PipelineConfig()`` (d_model 512, 12 layers)
whatever release is installed: where the release's dims differ, the
flagship runs on seeded random weights (the same FLOPs and bytes as
trained ones), and the report says ``"weights": "random"``.

    python -m omnilingual_asr_torch.eval.latency             # the card
    python -m omnilingual_asr_torch.eval.latency --device cpu --tiny
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

from .harness import add_device_arg


def make_audio(path: Path, seconds: float, sr: int = 16000) -> None:
    """Speech-like audio (the JAX bench's ``make_audio``): pitch-modulated
    harmonics, noise and pauses, as 16-bit WAV."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.5 * t)
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.15 * np.sin(2 * np.pi * 2.1 * f0 * t)
    x += 0.05 * rng.standard_normal(len(t))
    gate = (np.sin(2 * np.pi * 0.25 * t) > -0.7).astype(np.float32)
    x = (x * gate * 20000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


def latency_engine(tiny: bool = False, device=None):
    """(engine, weights): the flagship row's engine at batch 1, on the
    release's weights where its dims are the flagship's, else on random
    weights from ``torch.Generator().manual_seed(cfg.seed)``."""
    import torch

    from ..config import PipelineConfig, tiny_config
    from ..engine import TranscriptionEngine
    from ..models.conformer import asr_init

    cfg = tiny_config() if tiny else PipelineConfig.from_env()
    weights = "release" if cfg.checkpoint_path else "random"
    if not tiny:
        flagship = PipelineConfig()
        if (cfg.encoder.d_model, cfg.encoder.n_layers) != (
                flagship.encoder.d_model, flagship.encoder.n_layers):
            cfg = flagship
            weights = "random"
    params = None
    if weights == "random":
        params = asr_init(torch.Generator().manual_seed(cfg.seed), cfg)
    engine = TranscriptionEngine(config=cfg, params=params,
                                 batch_windows_per_device=1, device=device)
    return engine, weights


def latency_report(engine, weights: str, wav: Path, seconds: float,
                   reps: int) -> dict:
    """Two warm-up requests, then ``reps`` timed ones: the report."""
    import torch

    engine.transcribe(wav)  # build + warm-up
    engine.transcribe(wav)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.transcribe(wav)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    best = float(min(times))
    cfg = engine.config
    dev = engine.device
    return {
        "metric": "batch1_latency_s",
        "audio_s": seconds,
        "backend": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else dev.type),
        "median_s": round(med, 4),
        "best_s": round(best, 4),
        "rtf_batch1": round(seconds / med, 1),
        "model": {"d_model": cfg.encoder.d_model,
                  "n_layers": cfg.encoder.n_layers},
        "weights": weights,
        "reps": reps,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="audio length (default: one engine window)")
    ap.add_argument("--reps", type=int, default=16)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    engine, weights = latency_engine(args.tiny, args.device)
    with tempfile.TemporaryDirectory() as tmp:
        wav = Path(tmp) / "latency.wav"
        make_audio(wav, args.seconds)
        report = latency_report(engine, weights, wav, args.seconds,
                                args.reps)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
