"""Real natural-language X->English pairs from installed resources.

The PyTorch port's copy of ``omnilingual_asr_tpu/train/real_pairs.py``
(numpy only), bit for bit: the text translator trainer
(``train/text_translator_train.py``) draws 20 % of its pairs from here
where the resources exist. Two sources:

- **gettext catalogs** (``humanize``'s ``.po`` files): human-translated
  time and number phrases ("hace %d minutos" <-> "%d minutes ago"),
  plural forms included (``msgid_plural``/``msgstr[k]``);
- **CLDR via babel**: per-locale display names (languages, territories,
  months, weekdays) and duration unit patterns ("{0} horas" <->
  "{0} hours").

Either package may be missing (the card's machine is not known to have
them): each loader then returns nothing, :func:`build_real_corpus` an
empty corpus, and the trainer runs without real pairs, as the reference
does. Pairs are split train/held-out by a stable hash of the English
target template, so every rendering of one phrase lands on one side and
the held-out metric measures generalization, not recall.
"""

from __future__ import annotations

import hashlib
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

# CLDR-only additions beyond whatever .po catalogs are installed.
# Chosen for script diversity; every entry must be a babel locale id.
CLDR_EXTRA_LOCALES = [
    "sw", "hi", "th", "ta", "te", "am", "yo", "zu", "ms", "ro", "cs",
    "bg", "sr", "hr", "lt", "lv", "et", "az", "kk", "mn", "ne", "si",
    "km", "lo", "my", "ka", "hy", "gl", "is", "ga", "mt", "cy",
]

_PLACEHOLDER = re.compile(r"%\((\w+)\)[ds]|%[ds]|\{0\}")


def _norm_placeholders(s: str) -> str:
    """Normalize every numeric placeholder form to '{0}'."""
    return _PLACEHOLDER.sub("{0}", s)


def _po_language(po_path: Path) -> str:
    """Locale id from .../locale/<id>/LC_MESSAGES/x.po."""
    return po_path.parent.parent.name


def _parse_po(text: str) -> List[dict]:
    """Minimal .po reader: plain and plural entries; msgctxt entries are
    skipped (they are morpheme fragments like ordinal suffixes, not
    translatable phrases)."""
    entries: List[dict] = []
    cur: dict = {}
    key = None

    def flush():
        nonlocal cur
        if cur.get("msgid"):
            entries.append(cur)
        cur = {}

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            if not line:
                flush()
            continue
        m = re.match(r'^(msgctxt|msgid_plural|msgid|msgstr(?:\[(\d+)\])?)'
                     r'\s+"(.*)"$', line)
        if m:
            tag, idx, val = m.group(1), m.group(2), m.group(3)
            if tag.startswith("msgstr["):
                key = f"msgstr[{idx}]"
            else:
                key = tag
            cur[key] = cur.get(key, "") + val
        elif line.startswith('"') and key is not None:
            cur[key] = cur.get(key, "") + line.strip('"')
    flush()
    return [e for e in entries if "msgctxt" not in e]


def _unescape(s: str) -> str:
    return (s.replace("\\n", " ").replace('\\"', '"')
            .replace("\\t", " ").strip())


def load_po_pairs() -> Dict[str, List[Tuple[str, str]]]:
    """(foreign, english) template pairs per locale id from every
    installed humanize .po catalog. Plural handling: msgid ↔ msgstr[0]
    is the n=1 form for nplurals<=2 catalogs (the only ones used), and
    msgid_plural ↔ msgstr[1] the n>1 form."""
    try:
        import humanize
    except ImportError:  # pragma: no cover
        return {}
    locdir = Path(humanize.__file__).parent / "locale"
    if not locdir.is_dir():  # pragma: no cover
        return {}
    out: Dict[str, List[Tuple[str, str]]] = {}
    for po in sorted(locdir.glob("*/LC_MESSAGES/*.po")):
        lang = _po_language(po)
        pairs: List[Tuple[str, str]] = []
        header = po.read_text(encoding="utf-8", errors="replace")
        two_forms = "nplurals=2" in header
        for e in _parse_po(header):
            mid = _unescape(e.get("msgid", ""))
            if not mid:
                continue
            if "msgid_plural" in e:
                s0 = _unescape(e.get("msgstr[0]", ""))
                if s0:
                    pairs.append((s0, mid))
                if two_forms:
                    s1 = _unescape(e.get("msgstr[1]", ""))
                    mpl = _unescape(e["msgid_plural"])
                    if s1 and mpl:
                        pairs.append((s1, mpl))
            else:
                s = _unescape(e.get("msgstr", ""))
                if s:
                    pairs.append((s, mid))
        pairs = [(a, b) for a, b in
                 ((_norm_placeholders(a), _norm_placeholders(b))
                  for a, b in pairs)
                 # Identity pairs teach copying, which the byte decoder
                 # already does for English passthrough; drop them.
                 if a != b]
        if pairs:
            out.setdefault(lang, []).extend(pairs)
    return out


def load_cldr_pairs(locale_id: str,
                    max_names: int = 400) -> List[Tuple[str, str]]:
    """(foreign, english) pairs for one locale from babel's CLDR data:
    language + territory display names, month/weekday names, and duration
    unit patterns (as '{0}'-templates)."""
    try:
        from babel import Locale, UnknownLocaleError
    except ImportError:  # pragma: no cover
        return []
    try:
        loc = Locale.parse(locale_id)
        en = Locale("en")
    except (UnknownLocaleError, ValueError):
        return []
    pairs: List[Tuple[str, str]] = []

    def add_names(theirs: dict, ours: dict, cap: int):
        n = 0
        for k in sorted(theirs.keys() & ours.keys()):
            a, b = str(theirs[k]).strip(), str(ours[k]).strip()
            if a and b and a != b:
                pairs.append((a, b))
                n += 1
                if n >= cap:
                    break

    add_names(loc.languages, en.languages, max_names)
    add_names(loc.territories, en.territories, max_names)
    for field in ("months", "days"):
        try:
            theirs = getattr(loc, field)["format"]["wide"]
            ours = getattr(en, field)["format"]["wide"]
            add_names(dict(theirs), dict(ours), 31)
        except Exception:
            pass
    # Duration unit patterns: '{0} horas' ↔ '{0} hours'.
    try:
        their_units = loc._data.get("unit_patterns", {})
        en_units = en._data.get("unit_patterns", {})
        for unit, forms in sorted(their_units.items()):
            if not unit.startswith("duration-"):
                continue
            for count in ("one", "other"):
                a = forms.get("long", {}).get(count)
                b = en_units.get(unit, {}).get("long", {}).get(count)
                if a and b and str(a) != str(b):
                    pairs.append((str(a), str(b)))
    except Exception:
        pass
    return pairs


def _locale_iso(locale_id: str) -> str:
    return locale_id.split("_")[0].split("-")[0]


def build_real_corpus(extra_locales: Optional[List[str]] = None,
                      heldout_every: int = 10,
                      heldout_by: str = "template") -> dict:
    """All pair sources merged, split train/held-out by a stable hash.

    heldout_by="template" (default): the hash is over
    the normalized ENGLISH target template, so every variant of a phrase —
    all 60+ locales' renderings, singular and plural forms — lands on ONE
    side. Under the old per-pair split, "1 hora"↔"{0} hour" could be
    held out while "{0} hour" still trained through 59 sibling locales;
    held-out accuracy partly measured that near-duplicate leak. (A split
    by literal source *package* is not usable here: there are exactly
    two pair sources — humanize gettext and babel CLDR — and holding out
    a whole package makes the held-out vocabulary disjoint from training,
    which no translator can pass.) heldout_by="pair" keeps the legacy
    split for comparability.

    Returns {"train": {iso: [(src,tgt)...]}, "heldout": same,
    "n_train": int, "n_heldout": int, "languages": [iso...]}.
    """
    by_lang: Dict[str, List[Tuple[str, str]]] = {}
    po = load_po_pairs()
    for locale_id, pairs in po.items():
        by_lang.setdefault(_locale_iso(locale_id), []).extend(pairs)
    locales = sorted(set(list(po.keys())
                         + (extra_locales if extra_locales is not None
                            else CLDR_EXTRA_LOCALES)))
    for locale_id in locales:
        iso = _locale_iso(locale_id)
        if iso == "en":
            continue
        by_lang.setdefault(iso, []).extend(load_cldr_pairs(locale_id))
    train: Dict[str, List[Tuple[str, str]]] = {}
    heldout: Dict[str, List[Tuple[str, str]]] = {}
    for iso, pairs in by_lang.items():
        seen = set()
        for src, tgt in pairs:
            if (src, tgt) in seen:
                continue
            # Placeholder balance: some catalogs fold the number into one
            # side only ("thousand" ↔ "%d হাজার") and CLDR 'one' forms may
            # omit it ("دقيقة" ↔ "{0} minute"); such pairs would train the
            # model to hallucinate or drop numbers.
            if src.count("{0}") != tgt.count("{0}"):
                continue
            seen.add((src, tgt))
            if heldout_by == "template":
                key = f"tpl|{_norm_placeholders(tgt).lower().strip()}"
            else:
                key = f"{iso}|{src}|{tgt}"
            h = int.from_bytes(hashlib.md5(key.encode()).digest()[:4], "big")
            (heldout if h % heldout_every == 0 else train).setdefault(
                iso, []).append((src, tgt))
    return {
        "train": train,
        "heldout": heldout,
        "n_train": sum(len(v) for v in train.values()),
        "n_heldout": sum(len(v) for v in heldout.values()),
        "languages": sorted(set(train) | set(heldout)),
    }


def draw_real_pair(rng: np.random.Generator, corpus: dict,
                   split: str = "train") -> Tuple[str, str]:
    """One (foreign, english) pair: pick a language uniformly, a pair
    uniformly within it, fill '{0}' with a sampled integer, and with some
    probability join two pairs into a longer span (transcripts are often
    multi-phrase)."""
    pool = corpus[split]
    langs = sorted(pool.keys())

    def one() -> Tuple[str, str]:
        lang = langs[int(rng.integers(len(langs)))]
        src, tgt = pool[lang][int(rng.integers(len(pool[lang])))]
        if "{0}" in src:
            n = str(int(rng.integers(2, 1000)))
            src, tgt = src.replace("{0}", n), tgt.replace("{0}", n)
        return src, tgt

    a_src, a_tgt = one()
    if rng.random() < 0.3:
        b_src, b_tgt = one()
        return f"{a_src} {b_src}", f"{a_tgt} {b_tgt}"
    return a_src, a_tgt
