"""Diarization DER on synthetic multi-speaker conversations through the
port's engine: the port's copy of the root ``eval_diar.py``.

Builds conversations from the synthetic corpus (2-4 speakers, alternating
turns with gaps), runs the full engine, and scores DER (collar-based,
Hungarian speaker mapping: ``utils/metrics.der``) of the engine's
diarization against the construction-time ground truth.

    python -m omnilingual_asr_torch.eval.diar --n 16               # the card
    python -m omnilingual_asr_torch.eval.diar --device cpu --tiny --n 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import wave
from typing import Callable, List, Optional, Tuple

import numpy as np

from .harness import add_device_arg, driver_config


def make_conversation(rng, n_speakers: int, n_turns: int = 10,
                      sr: int = 16000):
    """Returns (samples, ref_turns=[(speaker_label, t0, t1)])."""
    from ..train.synth import make_example, synth_utterance

    pieces = []
    ref = []
    t = 0.0
    spk_ids = rng.integers(0, 1024, n_speakers)
    for i in range(n_turns):
        who = int(rng.integers(n_speakers))
        ex = make_example(rng, min_words=3, max_words=7, clean=True)
        # re-synthesize with the chosen fixed speaker for consistency
        x = synth_utterance(ex.text, int(spk_ids[who]),
                            seed=int(rng.integers(2**31)))
        gap = float(rng.uniform(0.2, 0.8))
        pieces.append(np.zeros(int(gap * sr), np.float32))
        t += gap
        pieces.append(x)
        ref.append((f"S{who}", t, t + len(x) / sr))
        t += len(x) / sr
    samples = np.concatenate(pieces)
    # light noise so the VAD floor is realistic
    samples = samples + 0.003 * rng.standard_normal(
        len(samples)).astype(np.float32)
    return np.clip(samples, -1, 1), ref


def write_conversation(path: str, samples: np.ndarray) -> None:
    """16-bit mono WAV at 16 kHz, as the JAX driver writes it."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((samples * 32767).astype("<i2").tobytes())


def decode_overrides(threshold: Optional[float] = None,
                     count_mode: Optional[str] = None,
                     resegment: bool = False,
                     spk_wire: Optional[str] = None,
                     spk_stride: Optional[int] = None) -> dict:
    """The ``DecodeConfig`` fields the driver's flags override."""
    over = {}
    if threshold is not None:
        over["ahc_threshold"] = threshold
    if count_mode:
        over["count_mode"] = count_mode
    if resegment:
        over["resegment"] = True
    if spk_wire:
        over["spk_wire"] = spk_wire
    if spk_stride:
        over["spk_frame_stride"] = spk_stride
    return over


def run_battery(engine, n: int, seed: int
                ) -> Tuple[float, List[dict], List[list]]:
    """(mean DER, per-conversation details, per-conversation hypothesis
    segments as (start, end, speaker)) over ``n`` conversations drawn from
    ``seed``; each is written to a temporary WAV and transcribed."""
    from ..utils.metrics import der

    rng = np.random.default_rng(seed)
    ders, details, segments = [], [], []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n):
            n_spk = int(rng.integers(2, 5))
            samples, ref = make_conversation(rng, n_spk)
            path = os.path.join(tmp, f"conv_{i}.wav")
            write_conversation(path, samples)
            result = engine.transcribe(path)
            # utils/metrics Turn = (start, end, speaker)
            hyp = [(s.start, s.end, s.speaker) for s in result.segments]
            ref_turns = [(t0, t1, spk) for spk, t0, t1 in ref]
            d = der(ref_turns, hyp)
            ders.append(d)
            segments.append(hyp)
            details.append({"conv": i, "n_spk_ref": n_spk,
                            "n_spk_hyp": len({s.speaker
                                              for s in result.segments}),
                            "der": round(d, 4)})
            os.unlink(path)
    return float(np.mean(ders)), details, segments


def diar_report(make_engine: Callable, cfg, n: int, seed: int,
                ths: Optional[List[float]] = None, count_mode=None,
                resegment: bool = False, spk_wire=None, spk_stride=None,
                ckpt=None) -> Tuple[dict, List[list]]:
    """The driver's report: one battery a threshold of ``ths`` (the
    config's own cut when None) on an engine from ``make_engine(config)``,
    the best kept; and that battery's hypothesis segments."""
    ths = ths or [None]
    runs = []
    for th in ths:
        over = decode_overrides(th, count_mode, resegment, spk_wire,
                                spk_stride)
        c = (cfg.replace(decode=dataclasses.replace(cfg.decode, **over))
             if over else cfg)
        runs.append((th, *run_battery(make_engine(c), n, seed)))
    best_th, best_der, best_details, best_segments = min(
        runs, key=lambda r: r[1])
    count_acc = float(np.mean([d["n_spk_ref"] == d["n_spk_hyp"]
                               for d in best_details]))
    report = {
        "metric": "der",
        "value": round(best_der, 4),
        "speaker_count_acc": round(count_acc, 4),
        "count_mode": count_mode or "threshold",
        "resegment": bool(resegment),
        "n_conversations": n,
        "ckpt": ckpt,
        "details": best_details,
    }
    if len(runs) > 1 or ths[0] is not None:
        report["ahc_threshold"] = best_th
    if len(runs) > 1:
        report["sweep"] = [{"th": th, "der": round(d, 4)}
                           for th, d, _, _ in runs]
    return report, best_segments


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8, help="conversations")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--th", default=None,
                    help="AHC threshold override; comma-separated values "
                         "sweep the operating point (each trunk separates "
                         "embeddings differently)")
    ap.add_argument("--count-mode", default=None,
                    choices=["threshold", "eigengap"],
                    help="speaker-count stopping rule override "
                         "(DecodeConfig.count_mode)")
    ap.add_argument("--resegment", action="store_true",
                    help="VBx-style speaker-HMM Viterbi pass over the AHC "
                         "labels (DecodeConfig.resegment)")
    ap.add_argument("--spk-wire", default=None, choices=["f16", "i8"],
                    help="speaker-frame wire dtype override (DecodeConfig"
                         ".spk_wire): DER parity check for the int8 wire")
    ap.add_argument("--spk-stride", type=int, default=None,
                    help="speaker-frame device pooling stride override "
                         "(DecodeConfig.spk_frame_stride)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..engine import TranscriptionEngine

    cfg = driver_config(args.tiny, args.ckpt)
    ths = [float(t) for t in args.th.split(",")] if args.th else None
    report, _ = diar_report(
        lambda c: TranscriptionEngine(config=c, batch_windows_per_device=4,
                                      device=args.device),
        cfg, args.n, args.seed, ths, args.count_mode, args.resegment,
        args.spk_wire, args.spk_stride, args.ckpt)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
