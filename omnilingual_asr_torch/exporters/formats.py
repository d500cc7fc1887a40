"""Transcript exporters: EAF (ELAN 3.0), Praat TextGrid, plain text, SRT and
JSON.

Byte-compatible with the browser exporters the reference ships
(reference public/static/app.js — buildEAF :1381-1580, buildTextGrid
:1582-1692, buildPlainText :1694-1739, buildSRT :1741-1771, JSON :1364),
including their whitespace quirks (trailing spaces in TextGrid lines) and
rounding behavior (JS Math.round = floor(x+0.5)). The EAF DATE header is
injectable so exports are testable (the reference embeds
`new Date().toISOString()` at :1565).

Input is a transcript dict in the server history-entry shape:
{file_name, summary, detected_languages: [{language, code}], audio_url,
 segments: [{start, end, speaker, text, language, language_code, languages,
             emotion, translation, words}]}.

The PyTorch port's own copy of ``omnilingual_asr_tpu/exporters/formats.py``
(the port imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import json
import math
from datetime import datetime, timezone
from typing import List, Optional


def _js_round(x: float) -> int:
    """JS Math.round: floor(x + 0.5) (ties away from zero for positives)."""
    return math.floor(x + 0.5)


def _escape_xml(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def _valid_translation(seg: dict) -> bool:
    """Translation shown iff truthy, not the literal string "null", not equal
    to the text, and not blank (reference app.js:1443, :1727)."""
    t = seg.get("translation")
    return bool(t) and t != "null" and t != seg.get("text") and t.strip() != ""


def _iso_now() -> str:
    """JS new Date().toISOString() shape: millisecond precision, Z suffix."""
    now = datetime.now(timezone.utc)
    return now.strftime("%Y-%m-%dT%H:%M:%S.") + \
        f"{now.microsecond // 1000:03d}Z"


# ---------------------------------------------------------------------------
# EAF (ELAN XML 3.0) — reference app.js:1381-1580
# ---------------------------------------------------------------------------

_EAF_ANNOTATION = """            <ANNOTATION>
                <ALIGNABLE_ANNOTATION ANNOTATION_ID="{id}" TIME_SLOT_REF1="{ts1}" TIME_SLOT_REF2="{ts2}">
                    <ANNOTATION_VALUE>{value}</ANNOTATION_VALUE>
                </ALIGNABLE_ANNOTATION>
            </ANNOTATION>"""


def build_eaf(data: dict, date: Optional[str] = None,
              include_words: bool = False) -> str:
    """include_words: also emit per-speaker `{speaker}_words` tiers with a
    `word` LINGUISTIC_TYPE — the shape of the repo's bundled golden exports
    (reference gettysburg.eaf: TIER_ID="SPEAKER_00_words",
    LINGUISTIC_TYPE_REF="word"), which the current reference SPA can no
    longer produce (Gemini returns no word timestamps; our CTC alignment
    does). Default False keeps byte-parity with the SPA's buildEAF."""
    segments = data.get("segments", [])
    ts_id = 1
    ann_id = 1
    time_slots: List[tuple] = []
    transcript_anns: List[dict] = []
    language_anns: List[dict] = []
    emotion_anns: List[dict] = []
    translation_anns: List[dict] = []
    word_anns: List[dict] = []
    speakers: List[str] = []  # insertion-ordered unique (JS Set semantics)

    has_language = any(s.get("language") for s in segments)
    has_emotion = any(s.get("emotion") for s in segments)
    has_translation = any(
        s.get("translation") and s["translation"] != "null"
        and s["translation"].strip() != "" for s in segments)

    for seg in segments:
        sp = seg["speaker"]
        if sp not in speakers:
            speakers.append(sp)
        ts1, ts2 = f"ts{ts_id}", f"ts{ts_id + 1}"
        ts_id += 2
        time_slots.append((ts1, _js_round(seg["start"] * 1000)))
        time_slots.append((ts2, _js_round(seg["end"] * 1000)))
        transcript_anns.append(dict(tier=sp, ts1=ts1, ts2=ts2,
                                    value=seg["text"], id=f"a{ann_id}"))
        ann_id += 1
        if seg.get("language"):
            language_anns.append(dict(
                tier=f"{sp}_language", ts1=ts1, ts2=ts2,
                value=seg.get("language_code") or seg["language"],
                id=f"a{ann_id}"))
            ann_id += 1
        if seg.get("emotion"):
            emotion_anns.append(dict(tier=f"{sp}_emotion", ts1=ts1, ts2=ts2,
                                     value=seg["emotion"], id=f"a{ann_id}"))
            ann_id += 1
        if _valid_translation(seg):
            translation_anns.append(dict(
                tier=f"{sp}_translation", ts1=ts1, ts2=ts2,
                value=seg["translation"], id=f"a{ann_id}"))
            ann_id += 1
        if include_words:
            for w in seg.get("words") or []:
                wts1, wts2 = f"ts{ts_id}", f"ts{ts_id + 1}"
                ts_id += 2
                time_slots.append((wts1, _js_round(w["start"] * 1000)))
                time_slots.append((wts2, _js_round(w["end"] * 1000)))
                word_anns.append(dict(tier=f"{sp}_words", ts1=wts1,
                                      ts2=wts2, value=w["word"],
                                      id=f"a{ann_id}"))
                ann_id += 1

    ts_xml = "\n".join(
        f'        <TIME_SLOT TIME_SLOT_ID="{tid}" TIME_VALUE="{t}"/>'
        for tid, t in time_slots)

    def tier_block(anns: List[dict], tier_id: str, type_ref: str,
                   required: bool) -> str:
        tier_anns = "\n".join(
            _EAF_ANNOTATION.format(id=a["id"], ts1=a["ts1"], ts2=a["ts2"],
                                   value=_escape_xml(a["value"]))
            for a in anns if a["tier"] == tier_id)
        if not tier_anns and not required:
            return ""
        return (f'        <TIER LINGUISTIC_TYPE_REF="{type_ref}" '
                f'TIER_ID="{tier_id}">\n{tier_anns}\n        </TIER>')

    transcript_tiers = "\n".join(
        tier_block(transcript_anns, sp, "transcription", required=True)
        for sp in speakers)

    additional = ""
    if has_language:
        blocks = [tier_block(language_anns, f"{sp}_language", "language", False)
                  for sp in speakers]
        additional += "\n".join(b for b in blocks if b) + "\n"
    if has_emotion:
        blocks = [tier_block(emotion_anns, f"{sp}_emotion", "emotion", False)
                  for sp in speakers]
        additional += "\n".join(b for b in blocks if b) + "\n"
    if has_translation:
        blocks = [tier_block(translation_anns, f"{sp}_translation",
                             "translation", False) for sp in speakers]
        additional += "\n".join(b for b in blocks if b)
    if include_words and word_anns:
        blocks = [tier_block(word_anns, f"{sp}_words", "word", False)
                  for sp in speakers]
        joined = "\n".join(b for b in blocks if b)
        additional = (additional + "\n" + joined) if additional.strip() \
            else joined

    ltypes = '    <LINGUISTIC_TYPE LINGUISTIC_TYPE_ID="transcription" TIME_ALIGNABLE="true"/>'
    if has_language:
        ltypes += '\n    <LINGUISTIC_TYPE LINGUISTIC_TYPE_ID="language" TIME_ALIGNABLE="true"/>'
    if has_emotion:
        ltypes += '\n    <LINGUISTIC_TYPE LINGUISTIC_TYPE_ID="emotion" TIME_ALIGNABLE="true"/>'
    if has_translation:
        ltypes += '\n    <LINGUISTIC_TYPE LINGUISTIC_TYPE_ID="translation" TIME_ALIGNABLE="true"/>'
    if include_words and word_anns:
        ltypes += '\n    <LINGUISTIC_TYPE LINGUISTIC_TYPE_ID="word" TIME_ALIGNABLE="true"/>'

    if date is None:
        date = _iso_now()
    audio_url = data.get("audio_url") or ""

    return f"""<?xml version="1.0" encoding="UTF-8"?>
<ANNOTATION_DOCUMENT AUTHOR="OmniTranscribe" DATE="{date}" FORMAT="3.0" VERSION="3.0" xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" xsi:noNamespaceSchemaLocation="http://www.mpi.nl/tools/elan/EAFv3.0.xsd">
    <HEADER MEDIA_FILE="" TIME_UNITS="milliseconds">
        <MEDIA_DESCRIPTOR MEDIA_URL="{_escape_xml(audio_url)}" MIME_TYPE="audio/x-wav"/>
    </HEADER>
    <TIME_ORDER>
{ts_xml}
    </TIME_ORDER>
{transcript_tiers}
{additional}
{ltypes}
</ANNOTATION_DOCUMENT>"""


# ---------------------------------------------------------------------------
# Praat TextGrid — reference app.js:1582-1692
# ---------------------------------------------------------------------------

def build_textgrid(data: dict) -> str:
    segments = data.get("segments", [])
    max_time = 0.0
    for seg in segments:
        max_time = max(max_time, seg["end"])
    speakers: List[str] = []
    for seg in segments:
        if seg["speaker"] not in speakers:
            speakers.append(seg["speaker"])

    intervals = {sp: [] for sp in speakers}
    for seg in segments:
        words = seg.get("words") or []
        if words:
            for w in words:
                intervals[seg["speaker"]].append(
                    dict(xmin=w["start"], xmax=w["end"], text=w["word"]))
        else:
            intervals[seg["speaker"]].append(
                dict(xmin=seg["start"], xmax=seg["end"], text=seg["text"]))

    # Gap filling with empty intervals (reference :1620-1650).
    for sp in speakers:
        ivs = sorted(intervals[sp], key=lambda iv: iv["xmin"])
        filled = []
        last_end = 0.0
        for iv in ivs:
            if iv["xmin"] > last_end + 0.001:
                filled.append(dict(xmin=last_end, xmax=iv["xmin"], text=""))
            filled.append(iv)
            last_end = iv["xmax"]
        if last_end < max_time - 0.001:
            filled.append(dict(xmin=last_end, xmax=max_time, text=""))
        intervals[sp] = filled

    def fmt(t: float) -> str:
        return f"{t:.6f}"

    def esc(s: str) -> str:
        return s.replace('"', '""')

    # NOTE: trailing spaces below are deliberate — byte parity with the
    # reference's template literals (:1656-1684).
    out = (
        'File type = "ooTextFile"\n'
        'Object class = "TextGrid"\n'
        "\n"
        "xmin = 0 \n"
        f"xmax = {fmt(max_time)}\n"
        "\n"
        "tiers? <exists> \n"
        f"size = {len(speakers)}\n"
        "item []:\n"
    )
    for tier_idx, sp in enumerate(speakers):
        ivs = intervals[sp]
        out += (
            f"    item [{tier_idx + 1}]:\n"
            '        class = "IntervalTier" \n'
            f'        name = "{esc(sp)}"\n'
            "        xmin = 0 \n"
            f"        xmax = {fmt(max_time)}\n"
            f"        intervals: size = {len(ivs)}\n"
        )
        for int_idx, iv in enumerate(ivs):
            out += (
                f"        intervals [{int_idx + 1}]:\n"
                f"            xmin = {fmt(iv['xmin'])} \n"
                f"            xmax = {fmt(iv['xmax'])}\n"
                f'            text = "{esc(iv["text"])}"\n'
            )
    return out


# ---------------------------------------------------------------------------
# Plain text — reference app.js:1694-1739
# ---------------------------------------------------------------------------

def _format_time_mmss(seconds: float) -> str:
    """SPA formatTime (reference app.js:585-589): M:SS, minutes unpadded."""
    mins = int(seconds // 60)
    secs = int(seconds % 60)
    return f"{mins}:{secs:02d}"


def build_plain_text(data: dict) -> str:
    lines: List[str] = []
    if data.get("summary"):
        lines.append("=== Summary ===")
        lines.append(data["summary"])
        lines.append("")
    langs = data.get("detected_languages")
    if langs:
        lines.append("=== Detected Languages ===")
        for lang in langs:
            lines.append(f"- {lang['language']} ({lang['code']})")
        lines.append("")
    lines.append("=== Transcript ===")
    lines.append("")
    current = None
    for seg in data.get("segments", []):
        if seg["speaker"] != current:
            if current is not None:
                lines.append("")
            lines.append(f"[{seg['speaker']}]")
            current = seg["speaker"]
        lines.append(f"{_format_time_mmss(seg['start'])} {seg['text']}")
        if _valid_translation(seg):
            lines.append(f"         → {seg['translation']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# SRT — reference app.js:1741-1771
# ---------------------------------------------------------------------------

def _format_srt_time(seconds: float) -> str:
    h = int(seconds // 3600)
    m = int((seconds % 3600) // 60)
    s = int(seconds % 60)
    ms = _js_round((seconds % 1) * 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def build_srt(data: dict) -> str:
    segments = data.get("segments", [])
    lines: List[str] = []
    multi = len({s["speaker"] for s in segments}) > 1
    for index, seg in enumerate(segments, start=1):
        lines.append(str(index))
        lines.append(f"{_format_srt_time(seg['start'])} --> "
                     f"{_format_srt_time(seg['end'])}")
        if multi:
            lines.append(f"[{seg['speaker']}] {seg['text']}")
        else:
            lines.append(seg["text"])
        lines.append("")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# JSON — reference app.js:1364 (JSON.stringify(activeData, null, 2))
# ---------------------------------------------------------------------------

def build_json(data: dict) -> str:
    return json.dumps(data, indent=2, ensure_ascii=False)


EXPORTERS = {
    "eaf": build_eaf,
    "textgrid": build_textgrid,
    "txt": build_plain_text,
    "srt": build_srt,
    "json": build_json,
}


def export_transcript(data: dict, fmt: str, **kw) -> str:
    """Dispatch like the SPA's downloadTranscript (reference app.js:1336)."""
    try:
        fn = EXPORTERS[fmt.lower()]
    except KeyError:
        raise ValueError(f"unknown export format: {fmt!r}") from None
    return fn(data, **kw) if fmt.lower() == "eaf" else fn(data)
