"""Parity and speed evaluation harness: the port's copy of
``omnilingual_asr_tpu/eval/harness.py``.

Runs the engine over a manifest of (audio, reference-transcript) pairs and
reports corpus WER/CER, the real-time factor, and (when reference turns are
given) DER. A manifest is JSONL, one object a line:

    {"audio": "path.wav", "text": "reference transcript",
     "language": "en",                      # optional hint
     "turns": [[0.0, 2.5, "Speaker 1"], ...]}  # optional, for DER

Relative audio paths resolve against the manifest's folder. The harness
reads no network; ``eval/manifests.py`` writes manifests from corpus
layouts on disk.

    python -m omnilingual_asr_torch.eval.harness MANIFEST [--device cpu]

It also holds what the port's drivers share: ``--device`` (the card unless
the caller asks for the CPU; no driver falls back to the CPU) and the
config the JAX drivers build from ``--tiny`` and ``--ckpt``.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from ..utils.metrics import aggregate_wer, der


@dataclass
class EvalReport:
    wer: float
    cer: float
    rtf: float                       # audio seconds per wall second
    n_files: int
    n_ref_words: int
    der_mean: Optional[float] = None
    per_file: List[dict] = field(default_factory=list)

    def to_json(self) -> str:
        d = {k: v for k, v in self.__dict__.items() if k != "per_file"}
        return json.dumps(d)


def load_manifest(path: str | Path) -> List[dict]:
    items = []
    root = Path(path).parent
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        item = json.loads(line)
        audio = Path(item["audio"])
        if not audio.is_absolute():
            item["audio"] = str(root / audio)
        items.append(item)
    return items


def evaluate(engine, manifest: str | Path,
             limit: Optional[int] = None) -> EvalReport:
    """Run the engine over a manifest; returns corpus metrics."""
    items = load_manifest(manifest)
    if limit:
        items = items[:limit]
    pairs = []
    ders = []
    per_file = []
    audio_s = 0.0
    wall_s = 0.0
    for item in items:
        t0 = time.perf_counter()
        result = engine.transcribe_with_retry(
            item["audio"], language=item.get("language"))
        dt = time.perf_counter() - t0
        hyp = " ".join(s.text for s in result.segments)
        pairs.append((item["text"], hyp))
        dur = max((s.end for s in result.segments), default=0.0)
        audio_s += dur
        wall_s += dt
        row = {"audio": item["audio"], "hyp": hyp, "seconds": dt}
        if item.get("turns"):
            ref_turns = [tuple(t) for t in item["turns"]]
            hyp_turns = [(s.start, s.end, s.speaker) for s in result.segments]
            d = der(ref_turns, hyp_turns)
            ders.append(d)
            row["der"] = d
        per_file.append(row)
    agg = aggregate_wer(pairs)
    return EvalReport(
        wer=agg["wer"], cer=agg["cer"],
        rtf=audio_s / wall_s if wall_s else 0.0,
        n_files=len(items), n_ref_words=agg["n_ref_words"],
        der_mean=sum(ders) / len(ders) if ders else None,
        per_file=per_file,
    )


# ---------------------------------------------------------------------------
# What the drivers share
# ---------------------------------------------------------------------------

def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; the run "
                         "fails without one unless this is 'cpu')")


def driver_config(tiny: bool = False, ckpt: Optional[str] = None):
    """The JAX drivers' config: ``tiny_config()`` (with ``ckpt`` as its
    checkpoint) under ``--tiny``; an explicit ``--ckpt`` adopts the
    checkpoint's own ``config.json`` and bypasses release discovery; else
    ``PipelineConfig.from_env()`` (the release, when one is installed)."""
    from ..config import PipelineConfig, config_for_checkpoint, tiny_config

    if tiny:
        cfg = tiny_config()
        return cfg.replace(checkpoint_path=ckpt) if ckpt else cfg
    if ckpt:
        return config_for_checkpoint(ckpt)
    return PipelineConfig.from_env()


def main(argv=None):
    ap = argparse.ArgumentParser(description="WER/CER/DER eval harness")
    ap.add_argument("manifest")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config (random weights): a mechanics run")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..config import PipelineConfig, tiny_config
    from ..engine import TranscriptionEngine

    cfg = tiny_config() if args.tiny else PipelineConfig.from_env()
    if args.checkpoint:
        cfg = cfg.replace(checkpoint_path=args.checkpoint)
    engine = TranscriptionEngine(config=cfg, device=args.device)
    report = evaluate(engine, args.manifest, limit=args.limit)
    print(report.to_json())


if __name__ == "__main__":
    main()
