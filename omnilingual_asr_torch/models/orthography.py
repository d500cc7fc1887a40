"""Orthography-constrained decoding.

The PyTorch port's own copy of ``omnilingual_asr_tpu/models/orthography.py`` (the port imports nothing
of the JAX package); keep the two in step.

The reference's serverless variant passes a free-text orthography hint into
the Gemini prompt (reference functions/api/_gemini.js:86-114 — a feature the
Python package lacks). Locally the hint becomes a hard constraint: the CTC
argmax is masked to UTF-8 bytes that can occur in the requested script,
plus ASCII digits/punctuation/whitespace which occur in any orthography.

Byte-level masking is conservative by construction: a lead byte is allowed
iff some allowed code point starts with it, and continuation bytes (0x80-
0xBF) are always allowed once any multi-byte script is enabled.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import VocabConfig

# Unicode ranges per script (inclusive).
SCRIPT_RANGES: Dict[str, List[Tuple[int, int]]] = {
    "latin": [(0x0041, 0x024F), (0x1E00, 0x1EFF)],
    "ipa": [(0x0041, 0x024F), (0x0250, 0x02AF), (0x02B0, 0x02FF),
            (0x0300, 0x036F)],
    "cyrillic": [(0x0400, 0x04FF), (0x0500, 0x052F)],
    "greek": [(0x0370, 0x03FF)],
    "arabic": [(0x0600, 0x06FF), (0x0750, 0x077F)],
    "hebrew": [(0x0590, 0x05FF)],
    "devanagari": [(0x0900, 0x097F)],
    "bengali": [(0x0980, 0x09FF)],
    "tamil": [(0x0B80, 0x0BFF)],
    "telugu": [(0x0C00, 0x0C7F)],
    "kannada": [(0x0C80, 0x0CFF)],
    "malayalam": [(0x0D00, 0x0D7F)],
    "sinhala": [(0x0D80, 0x0DFF)],
    "thai": [(0x0E00, 0x0E7F)],
    "lao": [(0x0E80, 0x0EFF)],
    "tibetan": [(0x0F00, 0x0FFF)],
    "myanmar": [(0x1000, 0x109F)],
    "georgian": [(0x10A0, 0x10FF)],
    "ethiopic": [(0x1200, 0x137F)],
    "khmer": [(0x1780, 0x17FF)],
    "han": [(0x4E00, 0x9FFF), (0x3400, 0x4DBF)],
    "chinese": [(0x4E00, 0x9FFF), (0x3400, 0x4DBF)],
    "hiragana": [(0x3040, 0x309F)],
    "katakana": [(0x30A0, 0x30FF)],
    "japanese": [(0x3040, 0x30FF), (0x4E00, 0x9FFF)],
    "hangul": [(0xAC00, 0xD7AF), (0x1100, 0x11FF)],
    "korean": [(0xAC00, 0xD7AF), (0x1100, 0x11FF)],
    "lisu": [(0xA4D0, 0xA4FF)],
    "cherokee": [(0x13A0, 0x13FF)],
    "armenian": [(0x0530, 0x058F)],
    "syllabics": [(0x1400, 0x167F)],  # Canadian Aboriginal
    "nko": [(0x07C0, 0x07FF)],
    "vai": [(0xA500, 0xA63F)],
    "tifinagh": [(0x2D30, 0x2D7F)],
}

# Bytes always allowed: ASCII letters only for latin-ish scripts, but
# digits, space and punctuation occur everywhere.
_ALWAYS = set(range(0x20, 0x41)) | {0x09, 0x0A} | set(range(0x5B, 0x61)) \
    | set(range(0x7B, 0x7F))


def _lead_bytes_for_range(lo: int, hi: int) -> set:
    """UTF-8 lead bytes for code points in [lo, hi] (exact: lead bytes are
    monotone in the code point within each encoding-length class)."""
    out = set()
    classes = [
        (0x00, 0x7F, lambda cp: cp),
        (0x80, 0x7FF, lambda cp: 0xC0 | (cp >> 6)),
        (0x800, 0xFFFF, lambda cp: 0xE0 | (cp >> 12)),
        (0x10000, 0x10FFFF, lambda cp: 0xF0 | (cp >> 18)),
    ]
    for clo, chi, lead in classes:
        a, b = max(lo, clo), min(hi, chi)
        if a > b:
            continue
        out |= set(range(lead(a), lead(b) + 1))
    return out


def allowed_bytes(orthography: str) -> Optional[set]:
    """Allowed byte values (0-255) for a script name; None = unrestricted."""
    key = (orthography or "").strip().lower()
    ranges = SCRIPT_RANGES.get(key)
    if not ranges:
        return None
    allowed = set(_ALWAYS)
    multibyte = False
    for lo, hi in ranges:
        if lo < 0x80:
            allowed |= set(range(max(0x41, lo), min(hi, 0x7A) + 1))
        if hi >= 0x80:
            multibyte = True
        allowed |= _lead_bytes_for_range(lo, hi)
    if multibyte:
        allowed |= set(range(0x80, 0xC0))  # continuation bytes
    return allowed


def ctc_logit_mask(orthography: Optional[str],
                   vocab: VocabConfig) -> np.ndarray:
    """Additive f32 mask [vocab_size]: 0 for allowed classes, -1e30 for
    disallowed. Blank is always allowed; padding classes always masked."""
    mask = np.full((vocab.vocab_size,), -1e30, np.float32)
    mask[vocab.blank_id] = 0.0
    allowed = allowed_bytes(orthography) if orthography else None
    for b in range(256):
        if allowed is None or b in allowed:
            mask[vocab.byte_to_id(b)] = 0.0
    return mask
