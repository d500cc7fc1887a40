"""Phonetically-grounded English synthesis (round-3 real-speech push).

The base synthetic corpus (train/synth.py) renders every language —
including English — as a per-character formant cipher: each grapheme gets a
fixed, randomly-assigned acoustic unit. That makes the corpus perfectly
learnable but teaches the model grapheme acoustics that share nothing with
real English phonetics, so transfer to real recordings (the 13 s of
gettysburg training windows) is limited to what those 13 s alone provide
(held-out gettysburg CER ~0.75 at d256, TRAINING_NOTES.md).

This module replaces the English branch with a small rule-based
text-to-phoneme front end (NRL-style letter-to-sound rules + an exceptions
dictionary for irregular common words) and a Klatt-style phoneme formant
synthesizer with coarticulated formant transitions. The goal is NOT natural
speech; it is that the acoustic-phonetic mapping of synthetic English
(vowel formant targets, stop bursts + aspiration, fricative noise bands,
nasal murmurs, formant transitions) matches real English closely enough
that the scarce real windows anchor the decoder instead of carrying it.

Reference behavior being replaced: transcription of arbitrary real English
audio (reference gemini_pipeline.py:512-530). Formant targets follow the
classic Peterson-Barney/Hillenbrand vowel tables and Klatt's consonant
specs (public phonetics data, re-derived here).

Contract with train/synth.py:
  - ``g2p(word) -> [(phones, char_lo, char_hi)]`` chunks each word;
  - ``synth_utterance_en(...)`` mirrors ``synth_utterance``'s signature and
    per-character ``word_spans`` semantics (frame CE / LID labels depend on
    every char of the text getting a sample span).

The PyTorch port's own copy of ``omnilingual_asr_tpu/train/synth_english.py``
(numpy only): every English draw of ``train/synth.py`` renders through it,
so the port's synthetic batches equal the JAX module's. Keep the two in
step.
"""

from __future__ import annotations

import numpy as np
from typing import Dict, List, Optional, Sequence, Tuple

SAMPLE_RATE = 16000

# ---------------------------------------------------------------------------
# Phoneme inventory: acoustic targets
# ---------------------------------------------------------------------------
# kind: vowel | diph | stop | fric | affr | nasal | liquid | glide | sil | asp
# Vowels/diphthongs: (F1, F2, F3) targets (Hz), adult-male reference frame
# (speaker formant_scale shifts them). Stops/fricatives: (burst/noise center,
# bandwidth). Durations in ms, pre rate-scaling.

VOWELS: Dict[str, Tuple[Tuple[float, float, float], float]] = {
    # phone: ((F1, F2, F3), dur_ms)
    "IY": ((270, 2290, 3010), 110.0),
    "IH": ((390, 1990, 2550), 80.0),
    "EH": ((530, 1840, 2480), 90.0),
    "AE": ((660, 1720, 2410), 120.0),
    "AA": ((730, 1090, 2440), 120.0),
    "AO": ((570, 840, 2410), 120.0),
    "UH": ((440, 1020, 2240), 80.0),
    "UW": ((300, 870, 2240), 110.0),
    "AH": ((640, 1190, 2390), 80.0),
    "ER": ((490, 1350, 1690), 110.0),   # low F3 = rhotic
}

DIPHTHONGS: Dict[str, Tuple[str, str, float]] = {
    # phone: (start-vowel, end-vowel, dur_ms) — targets borrowed from above
    "EY": ("EH", "IY", 130.0),
    "AY": ("AA", "IY", 150.0),
    "OY": ("AO", "IY", 150.0),
    "AW": ("AA", "UH", 150.0),
    "OW": ("AO", "UH", 130.0),
}

# Stop burst spectral centers by place; voiced stops add a low voice bar.
STOPS: Dict[str, Tuple[float, float, bool]] = {
    # phone: (burst_center_hz, burst_bw, voiced)
    "P": (800, 900, False), "B": (800, 900, True),
    "T": (4000, 1500, False), "D": (4000, 1500, True),
    "K": (2200, 1000, False), "G": (2200, 1000, True),
}

FRICS: Dict[str, Tuple[float, float, bool, float]] = {
    # phone: (noise_center, bw, voiced, gain)
    "F": (5500, 2500, False, 0.18), "V": (5500, 2500, True, 0.18),
    "TH": (5800, 2800, False, 0.14), "DH": (5800, 2800, True, 0.16),
    "S": (6300, 1600, False, 0.35), "Z": (6300, 1600, True, 0.30),
    "SH": (3600, 1400, False, 0.35), "ZH": (3600, 1400, True, 0.30),
    "HH": (1500, 2800, False, 0.10),
}

AFFRICATES: Dict[str, Tuple[str, str]] = {"CH": ("T", "SH"),
                                          "JH": ("D", "ZH")}

NASALS: Dict[str, Tuple[Tuple[float, float, float], float]] = {
    # murmur: low F1, damped mid; F2 hints at place
    "M": ((250, 1000, 2200), 70.0),
    "N": ((250, 1450, 2400), 70.0),
    "NG": ((250, 1900, 2500), 85.0),
}

LIQUIDS: Dict[str, Tuple[Tuple[float, float, float], float]] = {
    "L": ((360, 1100, 2600), 70.0),
    "R": ((420, 1200, 1600), 80.0),    # the low-F3 English /r/
}

GLIDES: Dict[str, Tuple[Tuple[float, float, float], float]] = {
    "W": ((300, 700, 2200), 60.0),
    "Y": ((280, 2200, 2900), 60.0),
}

_VOICED_SONORANT = (set(VOWELS) | set(DIPHTHONGS) | set(NASALS)
                    | set(LIQUIDS) | set(GLIDES))
ALL_PHONES = (_VOICED_SONORANT | set(STOPS) | set(FRICS) | set(AFFRICATES)
              | {"SIL"})


def _vowel_targets(ph: str) -> Tuple[float, float, float]:
    if ph in VOWELS:
        return VOWELS[ph][0]
    if ph in NASALS:
        return NASALS[ph][0]
    if ph in LIQUIDS:
        return LIQUIDS[ph][0]
    if ph in GLIDES:
        return GLIDES[ph][0]
    if ph in DIPHTHONGS:
        return VOWELS[DIPHTHONGS[ph][0]][0]
    return (500.0, 1500.0, 2500.0)


# ---------------------------------------------------------------------------
# G2P: exceptions dictionary + letter-to-sound rules
# ---------------------------------------------------------------------------
# Exceptions cover the irregular high-frequency words of the shared lexicon
# (train/synth.py ENGLISH_WORDS) + gettysburg vocabulary; everything else
# goes through the rules. Accuracy target is consistency, not correctness —
# the ASR needs a stable spelling<->sound mapping shaped like English.

_EXCEPTIONS: Dict[str, str] = {w: p for w, p in (
    ("the", "DH AH"), ("of", "AH V"), ("to", "T UW"), ("was", "W AH Z"),
    ("is", "IH Z"), ("as", "AE Z"), ("his", "HH IH Z"), ("has", "HH AE Z"),
    ("you", "Y UW"), ("your", "Y AO R"), ("one", "W AH N"),
    ("once", "W AH N S"), ("two", "T UW"), ("who", "HH UW"),
    ("what", "W AH T"), ("want", "W AA N T"), ("watch", "W AA CH"),
    ("water", "W AO T ER"), ("wash", "W AA SH"), ("said", "S EH D"),
    ("says", "S EH Z"), ("have", "HH AE V"), ("give", "G IH V"),
    ("live", "L IH V"), ("love", "L AH V"), ("move", "M UW V"),
    ("above", "AH B AH V"), ("come", "K AH M"), ("some", "S AH M"),
    ("done", "D AH N"), ("none", "N AH N"), ("gone", "G AO N"),
    ("were", "W ER"), ("where", "W EH R"), ("there", "DH EH R"),
    ("here", "HH IY R"), ("are", "AA R"), ("or", "AO R"),
    ("for", "F AO R"), ("word", "W ER D"), ("work", "W ER K"),
    ("world", "W ER L D"), ("would", "W UH D"), ("could", "K UH D"),
    ("should", "SH UH D"), ("do", "D UW"), ("does", "D AH Z"),
    ("don", "D AA N"), ("been", "B IH N"), ("busy", "B IH Z IY"),
    ("people", "P IY P AH L"), ("again", "AH G EH N"),
    ("against", "AH G EH N S T"), ("any", "EH N IY"),
    ("many", "M EH N IY"), ("pretty", "P R IH T IY"),
    ("eye", "AY"), ("eyes", "AY Z"), ("very", "V EH R IY"),
    ("every", "EH V R IY"), ("only", "OW N L IY"),
    ("great", "G R EY T"), ("earth", "ER TH"), ("early", "ER L IY"),
    ("learn", "L ER N"), ("heard", "HH ER D"), ("heart", "HH AA R T"),
    ("year", "Y IH R"), ("years", "Y IH R Z"), ("our", "AW R"),
    ("hour", "AW R"), ("four", "F AO R"), ("through", "TH R UW"),
    ("thought", "TH AO T"), ("though", "DH OW"), ("enough", "IH N AH F"),
    ("laugh", "L AE F"), ("rough", "R AH F"), ("tough", "T AH F"),
    ("night", "N AY T"), ("light", "L AY T"), ("right", "R AY T"),
    ("might", "M AY T"), ("high", "HH AY"), ("eight", "EY T"),
    ("weight", "W EY T"), ("height", "HH AY T"), ("own", "OW N"),
    ("know", "N OW"), ("knew", "N UW"), ("show", "SH OW"),
    ("low", "L OW"), ("grow", "G R OW"), ("slow", "S L OW"),
    ("snow", "S N OW"), ("follow", "F AA L OW"), ("yellow", "Y EH L OW"),
    ("window", "W IH N D OW"), ("how", "HH AW"), ("now", "N AW"),
    ("down", "D AW N"), ("town", "T AW N"), ("brown", "B R AW N"),
    ("flower", "F L AW ER"), ("power", "P AW ER"), ("tower", "T AW ER"),
    ("answer", "AE N S ER"), ("island", "AY L AH N D"),
    ("listen", "L IH S AH N"), ("often", "AO F AH N"),
    ("mother", "M AH DH ER"), ("father", "F AA DH ER"),
    ("fathers", "F AA DH ER Z"), ("brother", "B R AH DH ER"),
    ("other", "AH DH ER"), ("another", "AH N AH DH ER"),
    ("weather", "W EH DH ER"), ("together", "T AH G EH DH ER"),
    ("whether", "W EH DH ER"), ("machine", "M AH SH IY N"),
    ("ocean", "OW SH AH N"), ("special", "S P EH SH AH L"),
    ("sure", "SH UH R"), ("sugar", "SH UH G ER"),
    ("measure", "M EH ZH ER"), ("pleasure", "P L EH ZH ER"),
    ("usual", "Y UW ZH UH AH L"), ("usually", "Y UW ZH UH AH L IY"),
    ("question", "K W EH S CH AH N"), ("nation", "N EY SH AH N"),
    ("woman", "W UH M AH N"), ("women", "W IH M AH N"),
    ("month", "M AH N TH"), ("money", "M AH N IY"),
    ("front", "F R AH N T"), ("son", "S AH N"), ("ton", "T AH N"),
    ("won", "W AH N"), ("wonder", "W AH N D ER"), ("nothing", "N AH TH IH NG"),
    ("dozen", "D AH Z AH N"), ("cover", "K AH V ER"),
    ("color", "K AH L ER"), ("among", "AH M AH NG"),
    ("become", "B IH K AH M"), ("behind", "B IH HH AY N D"),
    ("believe", "B IH L IY V"), ("between", "B IH T W IY N"),
    ("body", "B AA D IY"), ("both", "B OW TH"), ("most", "M OW S T"),
    ("post", "P OW S T"), ("old", "OW L D"), ("cold", "K OW L D"),
    ("hold", "HH OW L D"), ("told", "T OW L D"), ("gold", "G OW L D"),
    ("find", "F AY N D"), ("kind", "K AY N D"), ("mind", "M AY N D"),
    ("child", "CH AY L D"), ("children", "CH IH L D R AH N"),
    ("wild", "W AY L D"), ("half", "HH AE F"), ("calm", "K AA M"),
    ("talk", "T AO K"), ("walk", "W AO K"), ("always", "AO L W EY Z"),
    ("also", "AO L S OW"), ("almost", "AO L M OW S T"),
    ("already", "AO L R EH D IY"), ("all", "AO L"), ("call", "K AO L"),
    ("small", "S M AO L"), ("fall", "F AO L"), ("wall", "W AO L"),
    ("ball", "B AO L"), ("warm", "W AO R M"), ("war", "W AO R"),
    ("toward", "T AO R D"), ("quarter", "K W AO R T ER"),
    ("idea", "AY D IY AH"), ("area", "EH R IY AH"),
    ("real", "R IY L"), ("really", "R IY L IY"),
    ("create", "K R IY EY T"), ("science", "S AY AH N S"),
    ("quiet", "K W AY AH T"), ("piece", "P IY S"), ("field", "F IY L D"),
    ("friend", "F R EH N D"), ("head", "HH EH D"), ("dead", "D EH D"),
    ("death", "D EH TH"), ("bread", "B R EH D"), ("ready", "R EH D IY"),
    ("heavy", "HH EH V IY"), ("weapon", "W EH P AH N"),
    ("breath", "B R EH TH"), ("meant", "M EH N T"),
    ("measure", "M EH ZH ER"), ("instead", "IH N S T EH D"),
    ("break", "B R EY K"), ("steak", "S T EY K"),
    ("in", "IH N"), ("it", "IH T"), ("if", "IH F"), ("him", "HH IH M"),
    ("did", "D IH D"), ("with", "W IH TH"), ("this", "DH IH S"),
    ("that", "DH AE T"), ("them", "DH EH M"), ("then", "DH EH N"),
    ("they", "DH EY"), ("their", "DH EH R"), ("these", "DH IY Z"),
    ("those", "DH OW Z"), ("than", "DH AE N"), ("thus", "DH AH S"),
    ("she", "SH IY"), ("he", "HH IY"), ("we", "W IY"), ("me", "M IY"),
    ("be", "B IY"), ("by", "B AY"), ("my", "M AY"), ("why", "W AY"),
    ("try", "T R AY"), ("fly", "F L AY"), ("cry", "K R AY"),
    ("dry", "D R AY"), ("sky", "S K AY"), ("multiply", "M AH L T IH P L AY"),
    ("carry", "K AE R IY"), ("marry", "M AE R IY"),
    ("city", "S IH T IY"), ("copy", "K AA P IY"),
    ("study", "S T AH D IY"), ("story", "S T AO R IY"),
    ("area", "EH R IY AH"), ("via", "V AY AH"),
    ("said", "S EH D"), ("against", "AH G EH N S T"),
    ("away", "AH W EY"), ("soldier", "S OW L JH ER"),
    ("closed", "K L OW Z D"), ("died", "D AY D"), ("dies", "D AY Z"),
    ("dying", "D AY IH NG"),
    ("young", "Y AH NG"), ("into", "IH N T UW"),
    ("spoken", "S P OW K AH N"), ("unknown", "AH N N OW N"),
    ("forgotten", "F ER G AA T AH N"), ("wear", "W EH R"),
    ("earn", "ER N"), ("courage", "K ER IH JH"),
    ("country", "K AH N T R IY"), ("duty", "D UW T IY"),
    ("holy", "HH OW L IY"), ("promise", "P R AA M IH S"),
    ("evidence", "EH V IH D AH N S"), ("committee", "K AH M IH T IY"),
    ("ceremony", "S EH R AH M OW N IY"), ("monument", "M AA N Y AH M AH N T"),
    ("general", "JH EH N ER AH L"), ("doctor", "D AA K T ER"),
    ("harbor", "HH AA R B ER"), ("record", "R EH K ER D"),
    ("built", "B IH L T"), ("rebuilt", "R IY B IH L T"),
    ("because", "B IH K AH Z"), ("history", "HH IH S T ER IY"),
    ("generation", "JH EH N ER EY SH AH N"),
    ("certain", "S ER T AH N"), ("mountain", "M AW N T AH N"),
    ("fountain", "F AW N T AH N"), ("captain", "K AE P T AH N"),
    ("course", "K AO R S"), ("four", "F AO R"), ("pour", "P AO R"),
    ("door", "D AO R"), ("floor", "F L AO R"), ("poor", "P UH R"),
    ("good", "G UH D"), ("book", "B UH K"), ("look", "L UH K"),
    ("took", "T UH K"), ("foot", "F UH T"), ("stood", "S T UH D"),
    ("wood", "W UH D"), ("wool", "W UH L"), ("full", "F UH L"),
    ("pull", "P UH L"), ("put", "P UH T"), ("push", "P UH SH"),
    ("blood", "B L AH D"), ("flood", "F L AH D"),
    ("food", "F UW D"), ("moon", "M UW N"), ("soon", "S UW N"),
    ("school", "S K UW L"), ("room", "R UW M"), ("too", "T UW"),
    ("tool", "T UW L"), ("noon", "N UW N"), ("roof", "R UW F"),
    ("group", "G R UW P"), ("soup", "S UW P"), ("you", "Y UW"),
    ("youth", "Y UW TH"), ("new", "N UW"), ("few", "F Y UW"),
    ("view", "V Y UW"), ("beauty", "B Y UW T IY"),
    ("beautiful", "B Y UW T IH F AH L"), ("use", "Y UW Z"),
    ("used", "Y UW Z D"), ("music", "M Y UW Z IH K"),
    ("human", "HH Y UW M AH N"), ("huge", "HH Y UW JH"),
    ("unit", "Y UW N IH T"), ("union", "Y UW N Y AH N"),
    ("future", "F Y UW CH ER"), ("figure", "F IH G Y ER"),
    ("picture", "P IH K CH ER"), ("nature", "N EY CH ER"),
    ("century", "S EH N CH ER IY"), ("language", "L AE NG G W AH JH"),
    ("perhaps", "P ER HH AE P S"), ("example", "IH G Z AE M P AH L"),
    ("exercise", "EH K S ER S AY Z"), ("examine", "IH G Z AE M IH N"),
    ("exact", "IH G Z AE K T"), ("oh", "OW"), ("ohio", "OW HH AY OW"),
    ("iron", "AY ER N"), ("sign", "S AY N"), ("design", "D IH Z AY N"),
    ("ago", "AH G OW"), ("ever", "EH V ER"), ("never", "N EH V ER"),
    ("even", "IY V AH N"), ("evening", "IY V N IH NG"),
    ("over", "OW V ER"), ("open", "OW P AH N"), ("most", "M OW S T"),
    ("baby", "B EY B IY"), ("lady", "L EY D IY"), ("paper", "P EY P ER"),
    ("label", "L EY B AH L"), ("table", "T EY B AH L"),
    ("able", "EY B AH L"), ("basic", "B EY S IH K"),
    ("major", "M EY JH ER"), ("radio", "R EY D IY OW"),
    ("station", "S T EY SH AH N"), ("conceived", "K AH N S IY V D"),
    ("dedicated", "D EH D IH K EY T AH D"), ("equal", "IY K W AH L"),
    ("proposition", "P R AA P AH Z IH SH AH N"),
    ("liberty", "L IH B ER T IY"), ("continent", "K AA N T IH N AH N T"),
    ("government", "G AH V ER N M AH N T"), ("govern", "G AH V ER N"),
    ("perish", "P EH R IH SH"), ("devotion", "D IH V OW SH AH N"),
    ("honored", "AA N ER D"), ("honor", "AA N ER"),
    ("vain", "V EY N"), ("brave", "B R EY V"),
    ("nobly", "N OW B L IY"), ("civil", "S IH V AH L"),
    ("engaged", "IH N G EY JH D"), ("increased", "IH N K R IY S T"),
    ("unfinished", "AH N F IH N IH SH T"),
    ("consecrate", "K AA N S AH K R EY T"),
    ("consecrated", "K AA N S AH K R EY T AH D"),
    ("hallow", "HH AE L OW"), ("struggled", "S T R AH G AH L D"),
    ("detract", "D IH T R AE K T"), ("forget", "F ER G EH T"),
    ("resting", "R EH S T IH NG"), ("final", "F AY N AH L"),
    ("fitting", "F IH T IH NG"), ("proper", "P R AA P ER"),
    ("altogether", "AO L T AH G EH DH ER"), ("larger", "L AA R JH ER"),
    ("sense", "S EH N S"), ("living", "L IH V IH NG"),
    ("rather", "R AE DH ER"), ("remaining", "R IH M EY N IH NG"),
    ("advanced", "AH D V AE N S T"), ("measure", "M EH ZH ER"),
    ("devotion", "D IH V OW SH AH N"), ("resolve", "R IH Z AA L V"),
    ("birth", "B ER TH"), ("freedom", "F R IY D AH M"),
    ("shall", "SH AE L"), ("not", "N AA T"), ("from", "F R AH M"),
)}

# Letter-to-sound rules: (grapheme, phones, context) applied longest-first.
# context: "" anywhere; "^" word-initial; "$" word-final; "V" before vowel
# letter; "C" before consonant letter; "e$" followed by final silent e.
_VOWEL_LETTERS = set("aeiouy")

_RULES: Sequence[Tuple[str, str, str]] = (
    # -- multi-letter vowels (longest first)
    ("eigh", "EY", ""), ("aigh", "EY", ""), ("ough", "AO", ""),
    ("augh", "AO", ""), ("igh", "AY", ""),
    ("tion", "SH AH N", ""), ("sion", "ZH AH N", ""),
    ("ture", "CH ER", "$"), ("tious", "SH AH S", ""),
    ("cious", "SH AH S", ""), ("cial", "SH AH L", ""),
    ("tial", "SH AH L", ""),
    ("dge", "JH", ""), ("tch", "CH", ""),
    ("ai", "EY", ""), ("ay", "EY", ""), ("ea", "IY", ""),
    ("ee", "IY", ""), ("ie", "IY", ""), ("ei", "IY", ""),
    ("oa", "OW", ""), ("oe", "OW", ""), ("ow", "OW", ""),
    ("ou", "AW", ""), ("oo", "UW", ""), ("ue", "UW", ""),
    ("ui", "UW", ""), ("oi", "OY", ""), ("oy", "OY", ""),
    ("au", "AO", ""), ("aw", "AO", ""), ("ew", "UW", ""),
    ("ar", "AA R", ""), ("er", "ER", ""), ("ir", "ER", ""),
    ("or", "AO R", ""), ("ur", "ER", ""), ("yr", "ER", ""),
    # -- consonant digraphs
    ("th", "TH", ""), ("sh", "SH", ""), ("ch", "CH", ""),
    ("ph", "F", ""), ("wh", "W", ""), ("ck", "K", ""),
    ("rh", "R", "^"), ("ey", "IY", "$"),
    ("ng", "NG", ""), ("qu", "K W", ""), ("gh", "G", "^"),
    ("gh", "", ""), ("kn", "N", "^"), ("wr", "R", "^"),
    ("mb", "M", "$"), ("gn", "N", "^"),
    # -- single letters
    ("a", "AE", ""), ("b", "B", ""), ("c", "K", ""),
    ("d", "D", ""), ("e", "EH", ""), ("f", "F", ""),
    ("g", "G", ""), ("h", "HH", ""), ("i", "IH", ""),
    ("j", "JH", ""), ("k", "K", ""), ("l", "L", ""),
    ("m", "M", ""), ("n", "N", ""),
    ("o", "OW", "$"), ("o", "AA", ""),
    ("p", "P", ""), ("r", "R", ""), ("s", "S", ""),
    ("t", "T", ""), ("u", "AH", ""), ("v", "V", ""),
    ("w", "W", ""), ("x", "K S", ""), ("y", "Y", "^"),
    ("y", "IY", "$"), ("y", "IH", ""), ("z", "Z", ""),
)

# magic-e long vowels: a_e -> EY, i_e -> AY, o_e -> OW, u_e -> UW, e_e -> IY
_LONG_VOWEL = {"a": "EY", "i": "AY", "o": "OW", "u": "UW", "e": "IY",
               "y": "AY"}
_SOFT_C_G = set("eiy")


def _is_cons(ch: str) -> bool:
    return ch.isalpha() and ch not in _VOWEL_LETTERS


#: phones that end voiceless (suffix voicing: walked -> T, named -> D)
_VOICELESS = frozenset({"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"})
#: sibilants take the syllabic plural (faces -> IH Z)
_SIBILANT = frozenset({"S", "Z", "SH", "ZH", "CH", "JH"})


def _suffix_stem(w: str) -> Optional[Tuple[str, str]]:
    """(stem, suffix_kind) for regular inflections, else None. Decomposing
    lets the stem reuse its exception/rule pronunciation ('walked' =
    exception 'walk' + T) instead of re-deriving the whole form — the
    pre-fix rules produced W AE L K T, N AE M EH S, etc."""
    n = len(w)
    if n < 4 or not any(c in _VOWEL_LETTERS for c in w[:-1]):
        return None
    if w.endswith("ied"):
        return w[:-3] + "y", "ed"            # carried -> carry + D
    if w.endswith("ies"):
        return w[:-3] + "y", "s"             # carries -> carry + Z
    if w.endswith("ed") and not w.endswith("eed"):
        stem_b = w[:-1]                      # keeps the e: close(d)
        if stem_b in _EXCEPTIONS:
            return stem_b, "ed"
        if w[:-2] in _EXCEPTIONS:
            return w[:-2], "ed"              # walk(ed)
        if (len(stem_b) >= 3 and _is_cons(stem_b[-2])
                and stem_b[-3] in _VOWEL_LETTERS):
            return stem_b, "ed"              # magic-e stem: divide(d)
        return w[:-2], "ed"
    if (w.endswith("s") and not w.endswith("ss")
            and not w.endswith("us") and not w.endswith("is")):
        return w[:-1], "s"                   # names -> name + Z
    return None


def g2p_word(word: str) -> List[Tuple[List[str], int, int]]:
    """word -> [(phones, char_lo, char_hi)] chunks covering every char.

    Lowercases internally; non-alphabetic chars become empty chunks (the
    synthesizer gives them a short silence so char spans stay total)."""
    w = word.lower()
    if w in _EXCEPTIONS:
        return [(_EXCEPTIONS[w].split(), 0, len(word))]
    split = _suffix_stem(w) if w.isalpha() else None
    if split is not None:
        stem, kind = split
        chunks = g2p_word(stem)
        phones = [p for ph, _, _ in chunks for p in ph]
        if phones:
            last = phones[-1]
            if kind == "ed":
                add = (["AH", "D"] if last in ("T", "D")
                       else ["T"] if last in _VOICELESS else ["D"])
            else:
                add = (["IH", "Z"] if last in _SIBILANT
                       else ["S"] if last in _VOICELESS else ["Z"])
            # stem chunks keep their spans clipped to the shared prefix;
            # the suffix letters carry the appended phones (plus any stem
            # phones whose chars fell entirely past the shared prefix,
            # e.g. carried -> stem "carry" whose IY sits on the 'y')
            shared = min(len(stem), len(w))
            while shared and stem[shared - 1] != w[shared - 1]:
                shared -= 1
            out: List[Tuple[List[str], int, int]] = []
            pending: List[str] = []
            for ph, lo, hi in chunks:
                lo2, hi2 = min(lo, shared), min(hi, shared)
                if hi2 <= lo2:
                    pending.extend(ph)
                elif not ph and out:
                    # silent letter (magic-e) INSIDE the inflected word:
                    # fold its chars into the previous phone chunk — an
                    # empty chunk would render as a word-internal SIL gap
                    # ("names" -> N EY M <56 ms silence> Z)
                    pph, plo, _ = out[-1]
                    out[-1] = (pph, plo, hi2)
                else:
                    out.append((list(ph), lo2, hi2))
            out.append((pending + add, shared, len(w)))
            return out
    out: List[Tuple[List[str], int, int]] = []
    i, n = 0, len(w)
    while i < n:
        ch = w[i]
        if not ch.isalpha():
            out.append(([], i, i + 1))
            i += 1
            continue
        # magic-e: V C e$  (take the long vowel, consume only V here)
        if (ch in _LONG_VOWEL and i + 2 < n and _is_cons(w[i + 1])
                and w[i + 2] == "e" and i + 3 == n):
            out.append(([_LONG_VOWEL[ch]], i, i + 1))
            i += 1
            continue
        # soft c/g before e/i/y
        if ch == "c" and i + 1 < n and w[i + 1] in _SOFT_C_G:
            out.append((["S"], i, i + 1))
            i += 1
            continue
        if ch == "g" and i + 1 < n and w[i + 1] in _SOFT_C_G and n > 2:
            out.append((["JH"], i, i + 1))
            i += 1
            continue
        # final silent e (not the only vowel)
        if (ch == "e" and i + 1 == n and n > 2
                and any(c in _VOWEL_LETTERS for c in w[:i])):
            out.append(([], i, i + 1))
            i += 1
            continue
        # final -ed: /d/ after voiced, /t/ after voiceless, /AH D/ after t,d
        if ch == "e" and i + 2 == n and w[i + 1] == "d" and n > 3:
            prev = w[i - 1]
            if prev in "td":
                out.append((["AH", "D"], i, i + 2))
            elif prev in "pkfsh" or w[i - 2:i] in ("sh", "ch"):
                out.append((["T"], i, i + 2))
            else:
                out.append((["D"], i, i + 2))
            i += 2
            continue
        # rules, longest grapheme first (table is ordered)
        matched = False
        for graph, phones, ctx in _RULES:
            L = len(graph)
            if w[i:i + L] != graph:
                continue
            if ctx == "^" and i != 0:
                continue
            if ctx == "$" and i + L != n:
                continue
            if ctx == "V" and not (i + L < n and w[i + L] in _VOWEL_LETTERS):
                continue
            if ctx == "C" and not (i + L < n and _is_cons(w[i + L])):
                continue
            out.append((phones.split() if phones else [], i, i + L))
            i += L
            matched = True
            break
        if not matched:   # unknown char: silence chunk
            out.append(([], i, i + 1))
            i += 1
    # double letters collapse (e.g. "ll", "ss" -> one phone) happen
    # naturally per-letter; merge adjacent identical single phones
    merged: List[Tuple[List[str], int, int]] = []
    for chunk in out:
        if (merged and len(chunk[0]) == 1 and len(merged[-1][0]) >= 1
                and merged[-1][0][-1] == chunk[0][0]
                and chunk[0][0] not in VOWELS
                and chunk[0][0] not in DIPHTHONGS):
            ph, lo, _ = merged[-1]
            merged[-1] = (ph, lo, chunk[2])
        else:
            merged.append((list(chunk[0]), chunk[1], chunk[2]))
    return merged


def g2p(text: str) -> List[Tuple[List[str], int, int]]:
    """Whole-text G2P: words separated by spaces; spaces become SIL chunks.
    Returned char ranges index into ``text`` and cover every character."""
    chunks: List[Tuple[List[str], int, int]] = []
    i = 0
    n = len(text)
    while i < n:
        if text[i].isspace():
            chunks.append((["SIL"], i, i + 1))
            i += 1
            continue
        j = i
        while j < n and not text[j].isspace():
            j += 1
        for (phones, lo, hi) in g2p_word(text[i:j]):
            chunks.append((phones, i + lo, i + hi))
        i = j
    return chunks


# ---------------------------------------------------------------------------
# Phoneme synthesis with coarticulated formant transitions
# ---------------------------------------------------------------------------


#: one encoder output frame at 16 kHz / hop 160 / subsample 4
_SAMPLES_PER_CTC_FRAME = 640

# ---------------------------------------------------------------------------
# Lexical stress (v2): real English reduces unstressed vowels toward schwa,
# lengthens + pitch-accents stressed nuclei, and lengthens phrase-final
# rimes. The v1 corpus rendered every vowel at its full target, which is a
# systematic mismatch with read speech (gettysburg) where function words
# and weak syllables are heavily reduced.
# ---------------------------------------------------------------------------

#: function words: never stressed, vowels reduce
_FUNCTION_WORDS = frozenset("""
a an the of to in on at by for or and but as is are was were be been am
do does did has have had he she it we they you i his her its our your
their them him me us that this these those with from than then so if
not no nor can could would should will shall may might must there
""".split())

#: words whose primary stress falls on the SECOND vowel nucleus
_SECOND_STRESS = frozenset("""
ago again against between believe become behind above about around
enough together another away upon today machine untie because before
result receive remain return report create idea event hotel advanced
unfinished increased devotion detract
""".split())

_VOWEL_NUCLEI = frozenset(VOWELS) | frozenset(DIPHTHONGS)

#: schwa target for reduction (AH)
_SCHWA = VOWELS["AH"][0]

#: vowels that resist reduction (rhotic + word-final tense vowels keep
#: their identity in real reduced speech)
_NO_REDUCE = frozenset({"ER", "AH"})


def _word_stress(phones_per_chunk: List[List[str]],
                 word: str) -> "set[Tuple[int, int]]":
    """The one stressed nucleus of a word, as {(chunk_idx, phone_idx)}
    (empty for function words): per-PHONE so multi-phone exception-dict
    chunks (e.g. "nation" -> N EY SH AH N) stress only the nucleus."""
    w = word.lower().strip(".,!?;:\"'")
    nuclei = []   # (chunk_idx, phone_idx)
    for ci, phones in enumerate(phones_per_chunk):
        for pi, ph in enumerate(phones):
            if ph in _VOWEL_NUCLEI:
                nuclei.append((ci, pi))
    if not nuclei or w in _FUNCTION_WORDS:
        return set()
    pick = 1 if (w in _SECOND_STRESS and len(nuclei) > 1) else 0
    return {nuclei[pick]}


def _phone_plan(text: str, rate_total: float):
    """Expand text -> [(phone, dur_samples, char_lo, char_hi, stress)];
    every char of the text is covered by >=1 plan entry (empty chunks get
    silence). stress: 1 = stressed nucleus chunk, 0 = unstressed, and the
    utterance-final word's entries are phrase-final lengthened.

    Each grapheme chunk is stretched to at least ~1.4 encoder frames per
    character so the CTC byte rate stays feasible even for words with far
    fewer phones than letters ("through" -> TH R UW)."""
    chunks = g2p(text)
    # group chunk indices into words (split on whitespace SIL chunks)
    words: List[List[int]] = [[]]
    for i, (_, lo, hi) in enumerate(chunks):
        if hi <= len(text) and lo < len(text) and text[lo:hi].isspace():
            if words[-1]:
                words.append([])
        else:
            words[-1].append(i)
    if words and not words[-1]:
        words.pop()
    stressed: "set[Tuple[int, int]]" = set()   # (chunk_idx, phone_idx)
    for idxs in words:
        word_text = text[chunks[idxs[0]][1]:chunks[idxs[-1]][2]]
        for (k, pi) in _word_stress([chunks[i][0] for i in idxs], word_text):
            stressed.add((idxs[k], pi))
    final_word = set(words[-1]) if words else set()

    plan: List[Tuple[str, int, int, int, int]] = []
    for ci, (phones, lo, hi) in enumerate(chunks):
        chunk_start = len(plan)
        if not phones:
            phones = ["SIL"]
            base = 30.0
        else:
            base = None
        for pj, ph in enumerate(phones):
            stress = 1 if (ci, pj) in stressed else 0
            if ph == "SIL":
                dur = base if base is not None else 80.0
            elif ph in VOWELS:
                dur = VOWELS[ph][1]
            elif ph in DIPHTHONGS:
                dur = DIPHTHONGS[ph][2]
            elif ph in NASALS:
                dur = NASALS[ph][1]
            elif ph in LIQUIDS:
                dur = LIQUIDS[ph][1]
            elif ph in GLIDES:
                dur = GLIDES[ph][1]
            elif ph in STOPS:
                dur = 70.0
            elif ph in AFFRICATES:
                dur = 110.0
            else:
                dur = 85.0
            # stress-conditioned duration: stressed nuclei lengthen,
            # unstressed vowels shorten (reduction); phrase-final word
            # lengthens its rime (classic pre-boundary lengthening)
            if ph in _VOWEL_NUCLEI:
                dur *= 1.18 if stress else 0.72
            if ci in final_word:
                dur *= 1.25
            n = max(16, int(dur / 1000.0 * SAMPLE_RATE / rate_total))
            plan.append((ph, n, lo, hi, stress))
        # CTC feasibility floor: >=1.4 frames per char in this chunk.
        # Absolute (NOT rate-scaled): labels don't shrink with fast speech.
        n_min = int((hi - lo) * 1.4 * _SAMPLES_PER_CTC_FRAME)
        have = sum(p[1] for p in plan[chunk_start:])
        if 0 < have < n_min:
            f = n_min / have
            plan[chunk_start:] = [
                (ph, int(n * f) + 1, lo2, hi2, st2)
                for (ph, n, lo2, hi2, st2) in plan[chunk_start:]]
    return plan


def _formant_amp(freqs: np.ndarray, f123, scale: float,
                 tilt: float) -> np.ndarray:
    """Lorentzian peaks, same shape family as synth._formant_envelope."""
    env = np.full_like(freqs, 0.015)
    for (f, g, bw) in zip(f123, (1.0, 0.63, 0.35), (90.0, 120.0, 180.0)):
        env += g / (1.0 + ((freqs - f * scale) / bw) ** 2)
    env *= (1.0 + freqs / 500.0) ** (-tilt)
    return env


def _noise_band(rng, n: int, center: float, bw: float) -> np.ndarray:
    noise = rng.standard_normal(n).astype(np.float32)
    spec = np.fft.rfft(noise)
    fr = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)
    band = np.exp(-0.5 * ((fr - center) / bw) ** 2)
    out = np.fft.irfft(spec * band, n).astype(np.float32)
    return out / max(np.abs(out).max(), 1e-6)


def synth_utterance_en(text: str, spk, emotion_prosody, *, seed: int = 0,
                       rate: float = 1.0, tilt: float = 1.0,
                       char_spans: Optional[list] = None) -> np.ndarray:
    """Render English text via the phoneme path.

    ``spk`` is a train.synth.Speaker; ``emotion_prosody`` the (f0_mult,
    rate_mult, energy_mult, jitter) tuple. Appends one (sample_start,
    sample_end) per character of ``text`` to ``char_spans`` (matching
    synth.synth_utterance's word_spans contract)."""
    rng = np.random.default_rng(seed)
    f0m, ratem, energym, jitter = emotion_prosody
    rate_total = rate * ratem
    plan = _phone_plan(text, rate_total)

    # formant track targets per plan entry (sonorants interpolate across
    # neighbors = coarticulation; obstruents break the chain). Unstressed
    # monophthong vowels reduce toward schwa (v2): real English centralizes
    # weak syllables, and the v1 full-target rendering was a systematic
    # mismatch with read speech.
    targets = []
    for (ph, _n, _lo, _hi, stress) in plan:
        t = _vowel_targets(ph)
        if ph in VOWELS and not stress and ph not in _NO_REDUCE:
            t = tuple(0.55 * a + 0.45 * s for a, s in zip(t, _SCHWA))
        targets.append(t)

    pieces: List[np.ndarray] = []
    # sample range per grapheme chunk; split per char afterwards
    chunk_ranges: List[List[int]] = []   # [lo, hi, s0, s1]
    total = 0
    n_plan = len(plan)
    for pi, (ph, n, lo, hi, stress) in enumerate(plan):
        decl = 1.0 - 0.25 * (pi / max(1, n_plan))
        # pitch accent on stressed nuclei, slight dip on weak syllables
        accent = 1.14 if stress else 0.97
        f0 = (spk.f0 * f0m * decl * accent
              * (1.0 + jitter * rng.standard_normal()))

        def voiced_seg(n, track_fn, gain, breath_mult=1.0):
            t_abs = (total + np.arange(n)) / SAMPLE_RATE
            vib = 1.0 + spk.vibrato_depth * np.sin(
                2 * np.pi * spk.vibrato_hz * t_abs)
            inst = f0 * vib
            phase = 2 * np.pi * np.cumsum(inst) / SAMPLE_RATE
            n_harm = int(min(28, 4300.0 // max(f0, 50.0)))
            k = np.arange(1, n_harm + 1)
            # time-varying formants: amps at 8 anchors, lerp between
            n_anchor = 8
            anchors = np.linspace(0.0, 1.0, n_anchor)
            amp_anchor = np.stack([
                _formant_amp(k * f0, track_fn(a), spk.formant_scale, tilt)
                for a in anchors])                        # [A, n_harm]
            pos = np.linspace(0.0, 1.0, n)
            ai = np.minimum((pos * (n_anchor - 1)).astype(int), n_anchor - 2)
            frac = pos * (n_anchor - 1) - ai
            amps = (amp_anchor[ai] * (1 - frac[:, None])
                    + amp_anchor[ai + 1] * frac[:, None])  # [n, n_harm]
            seg = (np.sin(phase[:, None] * k[None, :]) * amps).sum(axis=1)
            seg = seg.astype(np.float32)
            seg /= max(1.0, np.abs(seg).max())
            seg += (spk.breath * breath_mult
                    * rng.standard_normal(n).astype(np.float32))
            return seg * gain

        if ph == "SIL":
            seg = np.zeros(n, np.float32)
        elif ph in VOWELS or ph in DIPHTHONGS or ph in NASALS \
                or ph in LIQUIDS or ph in GLIDES:
            own = targets[pi]
            if ph in DIPHTHONGS:
                a_t = VOWELS[DIPHTHONGS[ph][0]][0]
                b_t = VOWELS[DIPHTHONGS[ph][1]][0]
            else:
                a_t = b_t = own
            prev_t = targets[pi - 1] if (
                pi > 0 and plan[pi - 1][0] in _VOICED_SONORANT) else a_t
            next_t = targets[pi + 1] if (
                pi + 1 < n_plan and plan[pi + 1][0] in _VOICED_SONORANT) \
                else b_t

            def track(a, a_t=a_t, b_t=b_t, prev_t=prev_t, next_t=next_t):
                # 0-0.25: prev boundary -> own start; 0.25-0.75 own
                # start -> own end; 0.75-1: own end -> next boundary
                if a < 0.25:
                    u = a / 0.25
                    lo_t = tuple(0.5 * (p + q) for p, q in zip(prev_t, a_t))
                    return tuple(l + (h - l) * u for l, h in zip(lo_t, a_t))
                if a < 0.75:
                    u = (a - 0.25) / 0.5
                    return tuple(l + (h - l) * u for l, h in zip(a_t, b_t))
                u = (a - 0.75) / 0.25
                hi_t = tuple(0.5 * (p + q) for p, q in zip(next_t, b_t))
                return tuple(l + (h - l) * u for l, h in zip(b_t, hi_t))

            if ph in VOWELS or ph in DIPHTHONGS:
                gain = 0.95 if stress else 0.78   # stress = louder nucleus
            else:
                gain = 0.55
            breath_mult = 1.0 if ph in VOWELS or ph in DIPHTHONGS else 0.6
            seg = voiced_seg(n, track, gain, breath_mult)
            if ph in NASALS:   # murmur: soften everything above ~800 Hz
                spec = np.fft.rfft(seg)
                fr = np.fft.rfftfreq(len(seg), 1.0 / SAMPLE_RATE)
                spec *= 1.0 / (1.0 + (fr / 900.0) ** 2)
                seg = np.fft.irfft(spec, len(seg)).astype(np.float32)
                m = np.abs(seg).max()
                if m > 0:
                    seg *= min(1.0, 0.5 / m)
        elif ph in STOPS:
            center, bw, voiced = STOPS[ph]
            gap = int(n * 0.5)
            burst_n = max(8, int(n * 0.2))
            asp_n = n - gap - burst_n
            closure = np.zeros(gap, np.float32)
            if voiced:   # voice bar: weak low-frequency periodicity
                t_abs = (total + np.arange(gap)) / SAMPLE_RATE
                closure = 0.08 * np.sin(
                    2 * np.pi * f0 * t_abs).astype(np.float32)
            b = _noise_band(rng, burst_n, center * spk.formant_scale, bw)
            b *= 0.55 * np.exp(-np.arange(burst_n) / (0.3 * burst_n))
            if not voiced and asp_n > 4:
                asp = _noise_band(rng, asp_n, 1800.0, 2500.0) * 0.12
            else:
                asp = np.zeros(max(asp_n, 0), np.float32)
            seg = np.concatenate([closure, b.astype(np.float32), asp])
        elif ph in AFFRICATES:
            stop_ph, fric_ph = AFFRICATES[ph]
            center, bw, _ = STOPS[stop_ph]
            fc, fbw, voiced, fgain = FRICS[fric_ph]
            gap = int(n * 0.35)
            fr_n = n - gap
            fric = _noise_band(rng, fr_n, fc * spk.formant_scale, fbw)
            fric *= fgain * 1.4
            seg = np.concatenate([np.zeros(gap, np.float32),
                                  fric.astype(np.float32)])
        elif ph in FRICS:
            fc, fbw, voiced, fgain = FRICS[ph]
            seg = _noise_band(rng, n, fc * spk.formant_scale, fbw) * fgain
            if voiced:
                t_abs = (total + np.arange(n)) / SAMPLE_RATE
                buzz = 0.5 * np.sin(2 * np.pi * f0 * t_abs)
                seg = seg * (0.6 + 0.4 * np.clip(buzz + 0.5, 0, 1)) \
                    + 0.12 * buzz.astype(np.float32)
            seg = seg.astype(np.float32)
        else:
            seg = np.zeros(n, np.float32)

        edge = min(len(seg) // 4, int(0.004 * SAMPLE_RATE))
        if edge > 0:
            w = np.hanning(2 * edge)
            seg[:edge] *= w[:edge]
            seg[-edge:] *= w[edge:]
        pieces.append(seg)
        if chunk_ranges and chunk_ranges[-1][0] == lo \
                and chunk_ranges[-1][1] == hi:
            chunk_ranges[-1][3] = total + n   # same chunk, extend
        else:
            chunk_ranges.append([lo, hi, total, total + n])
        total += n

    x = np.concatenate(pieces) if pieces else np.zeros(16, np.float32)
    x *= 0.25 * energym
    if char_spans is not None:
        # exactly one span per char, in text order: each grapheme chunk's
        # samples are split evenly across its chars (multi-phone exception
        # words included), matching synth_utterance's per-char contract
        per_char: Dict[int, Tuple[int, int]] = {}
        for lo, hi, s0, s1 in chunk_ranges:
            n_chars = max(hi - lo, 1)
            for k, ci in enumerate(range(lo, hi)):
                a = s0 + ((s1 - s0) * k) // n_chars
                z = s0 + ((s1 - s0) * (k + 1)) // n_chars
                pa, pz = per_char.get(ci, (a, a))
                per_char[ci] = (min(pa, a), max(pz, z))
        cursor = 0
        for ci in range(len(text)):
            s0, s1 = per_char.get(ci, (cursor, cursor))
            cursor = max(cursor, s1)
            char_spans.append((s0, s1))
    return x
