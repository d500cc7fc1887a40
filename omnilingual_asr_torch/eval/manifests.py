"""Manifest preparation for public ASR corpora: the port's copy of
``omnilingual_asr_tpu/eval/manifests.py``.

The eval harness (eval/harness.py) consumes JSONL
manifests: one ``{"audio", "text", "language", ...}`` object per line. This
module builds them from the on-disk layouts of the corpora the BASELINE
targets name (FLEURS WER/CER parity), so the moment a corpus is mounted the
quality numbers can be produced with two commands:

    python -m omnilingual_asr_torch.eval.manifests fleurs \
        --root /data/fleurs --lang en_us --split test --out fleurs_en.jsonl
    python -m omnilingual_asr_torch.eval.harness fleurs_en.jsonl

No downloading happens here: the functions read corpora already on disk
(the reference has no eval at all — its quality is whatever Gemini
returns).

Supported layouts:
- FLEURS (google/fleurs): {root}/{lang}/{split}.tsv (id, filename,
  raw_transcription, transcription, chars, num_samples, gender) with audio
  under {root}/{lang}/audio/{split}/.
- Common Voice: {root}/{split}.tsv (header with path/sentence columns),
  clips under {root}/clips/.
- LibriSpeech: {root}/{split}/{spk}/{chap}/{spk}-{chap}.trans.txt next to
  .flac files.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional

# FLEURS language-directory prefix -> display name in models/languages.py
_FLEURS_LANG = {
    "en": "English", "es": "Spanish", "fr": "French", "de": "German",
    "ru": "Russian", "zh": "Mandarin Chinese", "cmn": "Mandarin Chinese",
    "hi": "Hindi", "ar": "Arabic", "sw": "Swahili", "th": "Thai",
    "el": "Greek", "ka": "Georgian", "pt": "Portuguese", "it": "Italian",
    "ja": "Japanese", "ko": "Korean", "tr": "Turkish", "pl": "Polish",
    "nl": "Dutch", "vi": "Vietnamese", "id": "Indonesian",
}


def _lang_name(code: str) -> Optional[str]:
    base = code.split("_")[0].lower()
    if base in _FLEURS_LANG:
        return _FLEURS_LANG[base]
    from ..models import languages as lang_table

    i = lang_table.id_for_language(base)
    return lang_table.language_for_id(i)["name"] if i >= 0 else None


def fleurs_manifest(root: str | Path, lang: str,
                    split: str = "test") -> List[Dict]:
    """Items from a FLEURS checkout: {root}/{lang}/{split}.tsv."""
    root = Path(root)
    tsv = root / lang / f"{split}.tsv"
    audio_dir = root / lang / "audio" / split
    if not tsv.exists():
        raise FileNotFoundError(tsv)
    name = _lang_name(lang)
    items: List[Dict] = []
    with open(tsv, newline="", encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
            if len(row) < 4:
                continue
            _, filename, _raw, transcription = row[0], row[1], row[2], row[3]
            audio = audio_dir / filename
            if not audio.suffix:
                audio = audio.with_suffix(".wav")
            item = {"audio": str(audio), "text": transcription.strip()}
            if name:
                item["language"] = name
            items.append(item)
    return items


def commonvoice_manifest(root: str | Path,
                         split: str = "test") -> List[Dict]:
    """Items from a Common Voice checkout: {root}/{split}.tsv + clips/."""
    root = Path(root)
    tsv = root / f"{split}.tsv"
    if not tsv.exists():
        raise FileNotFoundError(tsv)
    items: List[Dict] = []
    with open(tsv, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t")
        for row in reader:
            path = row.get("path")
            sentence = (row.get("sentence") or "").strip()
            if not path or not sentence:
                continue
            item = {"audio": str(root / "clips" / path), "text": sentence}
            locale = (row.get("locale") or "").strip()
            if locale:
                name = _lang_name(locale)
                if name:
                    item["language"] = name
            items.append(item)
    return items


def librispeech_manifest(root: str | Path,
                         split: str = "test-clean") -> List[Dict]:
    """Items from a LibriSpeech checkout: trans.txt files next to flacs."""
    base = Path(root) / split
    if not base.exists():
        raise FileNotFoundError(base)
    items: List[Dict] = []
    for trans in sorted(base.rglob("*.trans.txt")):
        for line in trans.read_text(encoding="utf-8").splitlines():
            if " " not in line:
                continue
            utt_id, text = line.split(" ", 1)
            audio = trans.parent / f"{utt_id}.flac"
            items.append({"audio": str(audio), "text": text.strip().lower(),
                          "language": "English"})
    return items


def write_manifest(items: Iterable[Dict], out: str | Path) -> int:
    out = Path(out)
    n = 0
    with open(out, "w", encoding="utf-8") as f:
        for item in items:
            f.write(json.dumps(item, ensure_ascii=False) + "\n")
            n += 1
    return n


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Build JSONL manifests from public corpus layouts")
    ap.add_argument("corpus", choices=["fleurs", "commonvoice",
                                       "librispeech"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--lang", default="en_us",
                    help="FLEURS language directory (e.g. en_us)")
    ap.add_argument("--split", default="test")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    if args.corpus == "fleurs":
        items = fleurs_manifest(args.root, args.lang, args.split)
    elif args.corpus == "commonvoice":
        items = commonvoice_manifest(args.root, args.split)
    else:
        items = librispeech_manifest(args.root, args.split)
    n = write_manifest(items, args.out)
    print(f"wrote {n} items -> {args.out}")


if __name__ == "__main__":
    main()
