"""Classification-head quality through the port's engine: language-ID and
emotion accuracy (plus translation word accuracy with a translator, and the
neural summary's speaker count and tone with a summarizer) on held-out
synthetic utterances. The port's copy of the root ``eval_heads.py``.

The reference's schema carries per-segment ``language``, ``emotion`` and
``translation``; these are the measured numbers for the trained heads.
Held-out seeds are disjoint from every training stream (``train/synth.py::
eval_set``).

    python -m omnilingual_asr_torch.eval.heads --n 96 \
        --translator checkpoints/release/translator.npz \
        --summarizer checkpoints/release/summarizer.npz        # the card
    python -m omnilingual_asr_torch.eval.heads --device cpu --tiny --n 4
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .harness import add_device_arg, driver_config
from .synth import write_wav

#: Seeds of the real-audio channel draws and of the summary conversations
#: (disjoint from every training stream).
REAL_SEED = 88_000
SUMMARY_SEED = 77_000
SUMMARY_POOL = 64
_COUNT_WORDS = {1: ("one", "single", "1"), 2: ("two", "2"),
                3: ("three", "3"), 4: ("four", "4")}


def majority(segs, field: str) -> Optional[str]:
    """The segments' vote on ``field``, each weighted by its duration (one
    utterance has one ground-truth label; the engine may split it)."""
    w = collections.Counter()
    for s in segs:
        v = getattr(s, field, None)
        if v:
            w[v] += max(0.0, s.end - s.start)
    return w.most_common(1)[0][0] if w else None


def summary_hits(summary: Optional[str], facts: dict) -> Tuple[bool, bool]:
    """(speaker count named, tone named) in a free-text summary: the two
    facts the reference's prompt demands of one."""
    s = (summary or "").lower()
    n_spk = facts["n_speakers"]
    spk = any(w in s for w in _COUNT_WORDS.get(n_spk, (str(n_spk),)))
    return spk, facts["tone"].lower() in s


def evaluate_heads(engine, n: int, out_dir: Path, translate: bool = False,
                   summarize: bool = False) -> Tuple[dict, dict]:
    """The driver's report on ``eval_set(n)`` (and, with ``summarize``,
    ``max(4, n // 8)`` composed conversations), and its rows: each file's
    majority language and emotion and its joined translation, each
    conversation's facts and summary."""
    from ..train.synth import _channel_sim, eval_set, real_corpus

    out_dir.mkdir(parents=True, exist_ok=True)
    n_lid = n_lid_ok = n_emo = n_emo_ok = 0
    trans_words = trans_ok = 0
    confusions = collections.Counter()
    files: List[Optional[dict]] = []
    for i, ex in enumerate(eval_set(n)):
        p = out_dir / f"ex_{i:04d}.wav"
        write_wav(p, ex.samples)
        segs = engine.transcribe(p).segments
        if not segs:
            files.append(None)
            continue
        lid = majority(segs, "language")
        emo = majority(segs, "emotion")
        row = {"language": lid, "emotion": emo, "ref_language": ex.language,
               "ref_emotion": ex.emotion}
        n_lid += 1
        if lid == ex.language:
            n_lid_ok += 1
        else:
            confusions[(ex.language, lid)] += 1
        n_emo += 1
        n_emo_ok += emo == ex.emotion
        if translate and ex.translation:
            hyp = " ".join((s.translation or "") for s in segs).split()
            ref = ex.translation.split()
            trans_words += len(ref)
            trans_ok += sum(1 for a, b in zip(hyp, ref) if a == b)
            row["translation"] = " ".join(hyp)
        files.append(row)

    report = {
        "lid_acc": round(n_lid_ok / max(1, n_lid), 4),
        "emotion_acc": round(n_emo_ok / max(1, n_emo), 4),
        "n_files": n_lid,
    }
    if trans_words:
        report["translation_word_acc"] = round(trans_ok / trans_words, 4)

    # Real-acoustic rows: channel-augmented crops of the bundled real
    # recording (its EAF hold-out tail, never trained on), where present,
    # check LID-English and emotion-neutral beyond the synthesizer's
    # distribution.
    _, real_windows = real_corpus()
    if real_windows:
        rng = np.random.default_rng(REAL_SEED)
        r_lid = r_lid_ok = r_emo = r_emo_ok = 0
        for i, w in enumerate(real_windows):
            # clean + 4 independent channel draws per window (the hold-out
            # tail is short, so augmentation draws carry the sample size)
            for aug in range(5):
                x = _channel_sim(w["samples"], rng) if aug else w["samples"]
                p = out_dir / f"real_{i:02d}_{int(aug)}.wav"
                write_wav(p, x)
                segs = engine.transcribe(p).segments
                if not segs:
                    continue
                r_lid += 1
                r_lid_ok += majority(segs, "language") == w["language"]
                r_emo += 1
                r_emo_ok += majority(segs, "emotion") == "neutral"
        if r_lid:
            report["real"] = {
                "lid_en_acc": round(r_lid_ok / r_lid, 4),
                "emotion_neutral_acc": round(r_emo_ok / r_emo, 4),
                "n_windows": r_lid,
                "source": "gettysburg hold-out tail, channel-augmented",
            }

    conversations = []
    if summarize:
        # Free-text summary scoring on conversations composed with exact
        # facts (train/summary_train.py::make_conversation).
        from ..train.summary_train import (build_utterance_pool,
                                           make_conversation)

        rng = np.random.default_rng(SUMMARY_SEED)
        pool = build_utterance_pool(rng, SUMMARY_POOL)
        n_conv = max(4, n // 8)
        spk_ok = tone_ok = 0
        for i in range(n_conv):
            samples, facts = make_conversation(rng, pool)
            p = out_dir / f"conv_{i:04d}.wav"
            write_wav(p, samples)
            summary = engine.transcribe(p).summary
            spk, tone = summary_hits(summary, facts)
            spk_ok += spk
            tone_ok += tone
            conversations.append({"facts": facts, "summary": summary,
                                  "speaker_count_ok": spk, "tone_ok": tone})
        report["summary_speaker_count_acc"] = round(spk_ok / n_conv, 4)
        report["summary_tone_acc"] = round(tone_ok / n_conv, 4)
        report["summary_n_conversations"] = n_conv
    if confusions:
        report["top_lid_confusions"] = [
            {"ref": r, "hyp": h, "n": k}
            for (r, h), k in confusions.most_common(3)]
    return report, {"files": files, "conversations": conversations}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None, help="trained ASR checkpoint")
    ap.add_argument("--translator", default=None,
                    help="translator checkpoint (enables translation scoring)")
    ap.add_argument("--summarizer", default=None,
                    help="summarizer checkpoint (enables free-text summary "
                         "scoring on composed held-out conversations)")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--out", default=None,
                    help="folder for the WAVs (default: a temporary "
                         "folder, removed at the end)")
    ap.add_argument("--tiny", action="store_true")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    from ..engine import TranscriptionEngine

    engine = TranscriptionEngine(
        config=driver_config(args.tiny, args.ckpt),
        enable_translation=bool(args.translator),
        translator_path=args.translator,
        summarizer_path=args.summarizer,
        device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        report, _ = evaluate_heads(engine, args.n, Path(args.out or tmp),
                                   translate=bool(args.translator),
                                   summarize=bool(args.summarizer))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
