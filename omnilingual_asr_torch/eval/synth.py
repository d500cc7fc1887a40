"""End-to-end WER/CER on the held-out synthetic corpus (and the gettysburg
hold-out windows where the reference recording is present) through the
port's engine: decode, windows, the full result schema. The port's copy of
the root ``eval_synth.py``.

No public corpus ships with the repository, so held-out synthetic speech
(a seed space disjoint from every training stream, ``train/synth.py::
eval_set``) stands in for FLEURS until a manifest is mounted
(``eval/manifests.py`` then applies).

    python -m omnilingual_asr_torch.eval.synth --n 96          # the card
    python -m omnilingual_asr_torch.eval.synth --device cpu --tiny --n 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import wave
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .harness import EvalReport, add_device_arg, driver_config, evaluate, \
    load_manifest

QUANTIZE = {"none": False, "int8": True, "w8": "w8", "a8": "a8"}


def write_wav(path: Path, samples: np.ndarray, sr: int = 16000) -> None:
    x = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


def build_manifest(out_dir: Path, n_synth: int, include_real: bool) -> Path:
    """WAVs of ``eval_set(n_synth)`` (and the English gettysburg hold-out
    windows, where the reference recording is present) and their
    ``manifest.jsonl`` under ``out_dir``."""
    from ..train.synth import eval_set, real_corpus

    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, ex in enumerate(eval_set(n_synth)):
        if not ex.text:
            continue
        p = out_dir / f"synth_{i:04d}.wav"
        write_wav(p, ex.samples)
        lines.append({"audio": p.name, "text": ex.text,
                      "language": ex.language, "set": "synth"})
    if include_real:
        _, real_eval = real_corpus(window_s=30.0)
        for i, w in enumerate(real_eval):
            if w["language"] != "English" or not w["text"]:
                continue
            p = out_dir / f"gettysburg_heldout_{i:02d}.wav"
            write_wav(p, w["samples"])
            lines.append({"audio": p.name, "text": w["text"],
                          "language": "English", "set": "gettysburg"})
    manifest = out_dir / "manifest.jsonl"
    manifest.write_text("\n".join(json.dumps(l) for l in lines) + "\n")
    return manifest


def evaluate_sets(engine, manifest: Path, out_dir: Path
                  ) -> Tuple[Dict[str, dict], Dict[str, EvalReport]]:
    """Per-set reports (synthetic vs real speech) on one engine: the
    driver's JSON object and each set's ``EvalReport``."""
    items = load_manifest(manifest)
    out, reports = {}, {}
    for name in sorted({i["set"] for i in items}):
        sub = out_dir / f"manifest_{name}.jsonl"
        sub.write_text("\n".join(
            json.dumps(i) for i in items if i["set"] == name) + "\n")
        rep = evaluate(engine, sub)
        reports[name] = rep
        out[name] = {"wer": round(rep.wer, 4), "cer": round(rep.cer, 4),
                     "rtf": round(rep.rtf, 1), "n_files": rep.n_files,
                     "n_ref_words": rep.n_ref_words}
    return out, reports


def with_decode(cfg, beam: Optional[int] = None,
                lm_alpha: Optional[float] = None,
                word_bonus: Optional[float] = None,
                lexicon: Optional[str] = None):
    """``cfg`` with the given ``DecodeConfig`` fields replaced."""
    over = {k: v for k, v in (("beam_size", beam), ("lm_alpha", lm_alpha),
                              ("lm_word_bonus", word_bonus),
                              ("lexicon", lexicon)) if v is not None}
    if not over:
        return cfg
    return dataclasses.replace(
        cfg, decode=dataclasses.replace(cfg.decode, **over))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None, help="trained ASR checkpoint")
    ap.add_argument("--n", type=int, default=96, help="synthetic files")
    ap.add_argument("--out", default=None,
                    help="folder for the WAVs and manifests (default: a "
                         "temporary folder, removed at the end)")
    ap.add_argument("--no-real", action="store_true")
    ap.add_argument("--window-seconds", type=float, default=10.0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ingress", default=None, choices=["i16", "mulaw"],
                    help="H2D wire format (audio/codec.py); quantifies the "
                         "WER cost of 8-bit companded ingress")
    ap.add_argument("--quantize", default="none", choices=sorted(QUANTIZE),
                    help="serve quantized and measure the WER delta vs "
                         "bf16: int8 = dequant path (quantize=True), "
                         "w8/a8 = the W8A16/W8A8 kernels K4/K5 on the "
                         "card (their plain versions on the CPU; a8 "
                         "quantizes each activation row in the kernel, no "
                         "calibration needed)")
    ap.add_argument("--beam", type=int, default=None,
                    help="prefix-beam size (default: config, 1 = greedy)")
    ap.add_argument("--lm-alpha", type=float, default=None,
                    help="lexicon-LM shallow-fusion weight (ops/lexicon.py)")
    ap.add_argument("--word-bonus", type=float, default=None,
                    help="per-word insertion bonus for LM fusion")
    ap.add_argument("--lexicon", default=None,
                    help="DecodeConfig.lexicon override ('synth', "
                         "'synth_bigram', or a word-list path)")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..engine import TranscriptionEngine

    cfg = with_decode(driver_config(args.tiny, args.ckpt), args.beam,
                      args.lm_alpha, args.word_bonus, args.lexicon)
    engine = TranscriptionEngine(config=cfg,
                                 window_seconds=args.window_seconds,
                                 ingress=args.ingress,
                                 quantize=QUANTIZE[args.quantize],
                                 device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(args.out or tmp)
        manifest = build_manifest(out_dir, args.n,
                                  include_real=not args.no_real)
        out, _ = evaluate_sets(engine, manifest, out_dir)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
