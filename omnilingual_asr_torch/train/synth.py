"""Synthetic multi-task speech corpus: formant-synthesized utterances with
exact transcripts, language / emotion / speaker labels and English glosses.

Why this exists: the reference outsources all model capability to the Gemini
API (reference gemini_pipeline.py:512-530) and ships no training data; this
environment has no network egress, so no public corpus (FLEURS/CommonVoice)
can be fetched either. This module gives the trainer an unbounded supervised
corpus whose acoustics are produced by a source-filter formant synthesizer —
the same mechanism class real speech uses — so every head of the model
(byte CTC, frame LID, emotion, speaker, X->English translation) learns a
genuine audio->label mapping rather than memorizing files:

- Each Unicode character is a deterministic acoustic unit (vowel-like
  harmonics through formant resonances, fricative noise bands, stop bursts,
  nasal murmurs), parameterized by a stable hash of the character. The model
  must learn the unit->UTF-8-byte mapping from sound alone.
- 8 synthetic languages over distinct scripts (Latin, Cyrillic, Greek,
  Devanagari, Arabic, Georgian, Thai) exercise multi-byte UTF-8 CTC and make
  frame-level language ID learnable; each non-English lexicon is a bijective
  cipher of the English lexicon, so the translation decoder has a real
  word-level X->English task.
- Speakers are (f0 base, vocal-tract length / formant scale, breathiness,
  vibrato) draws keyed by speaker id; emotions modulate prosody
  (f0/rate/energy/jitter) so the 4-class head (schema enum, reference
  gemini_pipeline.py:133-136) has signal.
- Augmentation: background noise at random SNR, gain, f0 declination,
  per-utterance tempo.

The two real recordings the reference ships (gettysburg.wav + word-aligned
gettysburg.eaf golden, Samuel Speaking Lisu.mp3 + samuel_lisu.eaf) are folded
in through :func:`eaf_windows` so the checkpoint also sees real speech.

The PyTorch port's own copy of ``omnilingual_asr_tpu/train/synth.py``
(numpy only; the port imports nothing of the JAX package); keep the two in
step: the port's tests hold its batches equal, element for element, to the
JAX module's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import EMOTIONS

SAMPLE_RATE = 16_000

# ---------------------------------------------------------------------------
# Scripts / languages
# ---------------------------------------------------------------------------

_LATIN = "abcdefghijklmnopqrstuvwxyz"
_CYRILLIC = "абвгдежзиклмнопрстуфхцшыэюя"
_GREEK = "αβγδεζηθικλμνξοπρστυφχψω"
_DEVANAGARI = "कखगघचछजझटडतथदधनपफबभमयरलवशसह"
_ARABIC = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي"
_GEORGIAN = "აბგდევზთიკლმნოპჟრსტუფქღყშჩცძწჭხჯჰ"
_THAI = "กขคงจฉชซญดตถทธนบปผพฟภมยรลวศษสหอฮ"


@dataclass(frozen=True)
class SynthLanguage:
    name: str          # display name matching models/languages.py
    code: str
    alphabet: str
    is_english: bool = False


LANGUAGES: Tuple[SynthLanguage, ...] = (
    SynthLanguage("English", "en", _LATIN, is_english=True),
    SynthLanguage("Swahili", "sw", _LATIN),
    SynthLanguage("Russian", "ru", _CYRILLIC),
    SynthLanguage("Greek", "el", _GREEK),
    SynthLanguage("Hindi", "hi", _DEVANAGARI),
    SynthLanguage("Arabic", "ar", _ARABIC),
    SynthLanguage("Georgian", "ka", _GEORGIAN),
    SynthLanguage("Thai", "th", _THAI),
)

# ~480 common English words: the shared semantic lexicon. Every synthetic
# language's word i is a cipher of ENGLISH_WORDS[i], giving the translation
# head an exact X->English gloss per utterance.
ENGLISH_WORDS = (
    "the of and to in is you that it he was for on are as with his they be "
    "at one have this from or had by hot word but what some we can out other "
    "were all there when up use your how said an each she which do their "
    "time if will way about many then them write would like so these her "
    "long make thing see him two has look more day could go come did number "
    "sound no most people my over know water than call first who may down "
    "side been now find any new work part take get place made live where "
    "after back little only round man year came show every good me give our "
    "under name very through just form sentence great think say help low "
    "line differ turn cause much mean before move right boy old too same "
    "tell does set three want air well also play small end put home read "
    "hand port large spell add even land here must big high such follow act "
    "why ask men change went light kind off need house picture try us again "
    "animal point mother world near build self earth father head stand own "
    "page should country found answer school grow study still learn plant "
    "cover food sun four between state keep eye never last let thought city "
    "tree cross farm hard start might story saw far sea draw left late run "
    "while press close night real life few north open seem together next "
    "white children begin got walk example ease paper group always music "
    "those both mark often letter until mile river car feet care second "
    "book carry took science eat room friend began idea fish mountain stop "
    "once base hear horse cut sure watch color face wood main enough plain "
    "girl usual young ready above ever red list though feel talk bird soon "
    "body dog family direct pose leave song measure door product black "
    "short numeral class wind question happen complete ship area half rock "
    "order fire south problem piece told knew pass since top whole king "
    "space heard best hour better true during hundred five remember step "
    "early hold west ground interest reach fast verb sing listen six table "
    "travel less morning ten simple several vowel toward war lay against "
    "pattern slow center love person money serve appear road map rain rule "
    "govern pull cold notice voice unit power town fine certain fly fall "
    "lead cry dark machine note wait plan figure star box noun field rest "
    "correct able pound done beauty drive stood contain front teach week "
    "final gave green oh quick develop ocean warm free minute strong "
    "special mind behind clear tail produce fact street inch multiply "
    "nothing course stay wheel full force blue object decide surface deep "
    "moon island foot system busy test record boat common gold possible "
    "plane stead dry wonder laugh thousand ago ran check game shape equate "
    "miss brought heat snow tire bring yes distant fill east paint language "
    "among grand ball yet wave drop heart am present heavy dance engine "
    "position arm wide sail material size vary settle speak weight general "
    "ice matter circle pair include divide syllable felt perhaps pick "
    "sudden count square reason length represent art subject region energy "
    "hunt probable bed brother egg ride cell believe fraction forest sit "
    "race window store summer train sleep prove lone leg exercise wall "
    "catch mount wish sky board joy winter written wild instrument kept "
    "glass grass cow job edge sign visit past soft fun bright gas weather "
    "month million bear finish happy hope flower clothe strange gone jump "
    "baby eight village meet root buy raise solve metal whether push seven "
    "paragraph third shall held hair describe cook floor either result "
    "burn hill safe cat century consider type law bit coast copy phrase "
    "silent tall sand soil roll temperature finger industry value fight "
    "lie beat excite natural view sense ear else quite broke case middle "
    "kill son lake moment scale loud spring observe child straight "
    "consonant nation dictionary milk speed method organ pay age section "
    "dress cloud surprise quiet stone tiny climb cool design poor lot "
    "experiment bottom key iron single stick flat twenty skin smile crease "
    "hole trade melody trip office receive row mouth exact symbol die "
    "least trouble shout except wrote seed tone join suggest clean break "
    "lady yard rise bad blow oil blood touch grew cent mix team wire cost "
    "lost brown wear garden equal sent choose fell fit flow fair bank "
    "collect save control decimal gentle woman captain practice separate "
    "difficult doctor please protect noon whose locate ring character "
    "insect caught period indicate radio spoke atom human history effect "
    "electric expect crop modern element hit student corner party supply "
    "bone rail imagine provide agree thus capital chair danger fruit rich "
    "thick soldier process operate guess necessary sharp wing create "
    "neighbor wash bat rather crowd corn compare poem string bell depend "
    "meat rub tube famous dollar stream fear sight thin triangle planet "
    "hurry chief colony clock mine tie enter major fresh search send "
    "yellow gun allow print dead spot desert suit current lift rose "
    "continue block chart hat sell success company subtract event "
    "particular deal swim term opposite wife shoe shoulder spread arrange "
    "camp invent cotton born determine quart nine truck noise level "
    "chance gather shop stretch throw shine property column molecule "
    "select wrong gray repeat require broad prepare salt nose plural "
    "anger claim continent oxygen sugar death pretty skill women season "
    "solution magnet silver thank branch match suffix especially fig "
    "afraid huge sister steel discuss forward similar guide experience "
    "score apple bought led pitch coat mass card band rope slip win "
    "dream evening condition feed tool total basic smell valley nor "
    "double seat arrive master track parent shore division sheet "
    "substance favor connect post spend chord fat glad original share "
    "station dad bread charge proper bar offer segment slave duck "
    "instant market degree populate chick dear enemy reply drink occur "
    "support speech nature range steam motion path liquid log meant "
    "quotient teeth shell neck"
).split()

N_SPEAKERS = 1024   # speaker-id space for the AAM-softmax head
LEXICON_SIZE = len(ENGLISH_WORDS)


def _hash_floats(key: str, n: int) -> np.ndarray:
    """n deterministic floats in [0, 1) from a string key (stable across
    processes/runs — no PYTHONHASHSEED dependence)."""
    out = np.empty(n, np.float64)
    i = 0
    counter = 0
    while i < n:
        h = hashlib.md5(f"{key}:{counter}".encode()).digest()
        for j in range(0, 16, 4):
            if i >= n:
                break
            out[i] = int.from_bytes(h[j:j + 4], "little") / 2**32
            i += 1
        counter += 1
    return out


# ---------------------------------------------------------------------------
# Lexicons: each language's word i is a deterministic cipher of English
# word i, built from that language's alphabet with CV(C) phonotactics.
# ---------------------------------------------------------------------------

def _build_lexicon(lang: SynthLanguage) -> List[str]:
    if lang.is_english:
        return list(ENGLISH_WORDS)
    rng = np.random.default_rng(
        int.from_bytes(hashlib.md5(lang.code.encode()).digest()[:4], "little"))
    alpha = list(lang.alphabet)
    words: List[str] = []
    seen = set()
    for i in range(LEXICON_SIZE):
        # syllable count loosely follows the English word's length
        n_syll = max(1, min(4, (len(ENGLISH_WORDS[i]) + 2) // 3))
        while True:
            w = "".join(
                alpha[rng.integers(len(alpha))]
                + alpha[rng.integers(len(alpha))]
                + (alpha[rng.integers(len(alpha))]
                   if rng.random() < 0.3 else "")
                for _ in range(n_syll))
            if w not in seen:
                seen.add(w)
                words.append(w)
                break
    return words


_LEXICONS: Dict[str, List[str]] = {}


def lexicon(lang: SynthLanguage) -> List[str]:
    if lang.code not in _LEXICONS:
        _LEXICONS[lang.code] = _build_lexicon(lang)
    return _LEXICONS[lang.code]


# ---------------------------------------------------------------------------
# Character -> acoustic unit
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Unit:
    kind: str            # vowel | nasal | fricative | stop | silence
    f: Tuple[float, float, float]   # formants (vowel/nasal) or (center, bw, -)
    dur_ms: float
    gain: float


_UNIT_CACHE: Dict[str, Unit] = {}


def unit_for_char(ch: str) -> Unit:
    """Deterministic acoustic unit for a character."""
    if ch in _UNIT_CACHE:
        return _UNIT_CACHE[ch]
    if ch.isspace():
        u = Unit("silence", (0.0, 0.0, 0.0), 90.0, 0.0)
    else:
        r = _hash_floats("unit:" + ch, 8)
        # Multi-byte UTF-8 chars (whole syllables in Devanagari/Thai/...)
        # get proportionally longer units, keeping the CTC label byte rate
        # (<=25 bytes/s at subsample 4) below the encoder frame rate —
        # otherwise alignment is infeasible for 3-byte scripts.
        width = len(ch.encode("utf-8"))
        dur_scale = {1: 1.0, 2: 1.7, 3: 2.4}.get(width, 3.0)
        kind = ("vowel", "vowel", "nasal", "fricative", "fricative",
                "stop")[int(r[0] * 6)]
        if kind in ("vowel", "nasal"):
            f1 = 250.0 + 600.0 * r[1]
            f2 = max(f1 + 300.0, 800.0 + 1700.0 * r[2])
            f3 = max(f2 + 400.0, 2200.0 + 1000.0 * r[3])
            u = Unit(kind, (f1, f2, f3), dur_scale * (70.0 + 50.0 * r[4]),
                     0.9 if kind == "vowel" else 0.45)
        elif kind == "fricative":
            center = 1200.0 + 5800.0 * r[1]
            bw = 400.0 + 1600.0 * r[2]
            u = Unit(kind, (center, bw, 0.0),
                     dur_scale * (60.0 + 50.0 * r[4]), 0.35)
        else:  # stop: gap + burst
            center = 800.0 + 4200.0 * r[1]
            u = Unit(kind, (center, 900.0, 0.0),
                     dur_scale * (55.0 + 30.0 * r[4]), 0.6)
    _UNIT_CACHE[ch] = u
    return u


# ---------------------------------------------------------------------------
# Speakers & emotions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Speaker:
    f0: float            # base pitch, Hz
    formant_scale: float  # vocal-tract length proxy
    breath: float        # noise mixed into voiced units
    vibrato_hz: float
    vibrato_depth: float  # fraction of f0


def speaker_profile(speaker_id: int) -> Speaker:
    r = _hash_floats(f"spk:{speaker_id}", 5)
    return Speaker(
        f0=float(np.exp(np.log(85.0) + r[0] * (np.log(255.0) - np.log(85.0)))),
        formant_scale=float(0.85 + 0.32 * r[1]),
        breath=float(0.02 + 0.10 * r[2]),
        vibrato_hz=float(4.0 + 3.0 * r[3]),
        vibrato_depth=float(0.005 + 0.02 * r[4]),
    )


#: Voice parameters measured from the TRAINED portion (first 75%) of the
#: bundled real English recording (gettysburg.wav): frame-autocorrelation
#: f0 median 101 Hz (IQR 93-113), dark spectrum (centroid 543 Hz < 4 kHz,
#: HF/LF 0.009). Matched-voice English draws (voice_match_p) render the
#: phoneme-English corpus in this voice so the scarce real windows and the
#: plentiful synthetic English share one acoustic frame of reference —
#: targeted domain adaptation for the reference's real-audio behavior
#: (gemini_pipeline.py:512-530). Held-out audio is never read.
GETTYSBURG_VOICE = Speaker(f0=101.0, formant_scale=1.02, breath=0.045,
                           vibrato_hz=4.3, vibrato_depth=0.007)


def matched_voice(rng: np.random.Generator) -> Speaker:
    """A per-draw perturbation of GETTYSBURG_VOICE (f0 within the measured
    IQR, slight tract-length spread) so matching doesn't collapse to one
    exact voice."""
    return Speaker(
        f0=float(GETTYSBURG_VOICE.f0 * np.exp(rng.normal(0.0, 0.07))),
        formant_scale=float(GETTYSBURG_VOICE.formant_scale
                            * np.exp(rng.normal(0.0, 0.03))),
        breath=float(GETTYSBURG_VOICE.breath * rng.uniform(0.7, 1.4)),
        vibrato_hz=float(GETTYSBURG_VOICE.vibrato_hz + rng.uniform(-0.8, 0.8)),
        vibrato_depth=float(GETTYSBURG_VOICE.vibrato_depth
                            * rng.uniform(0.7, 1.3)),
    )


# (f0_mult, rate_mult, energy_mult, jitter)
_EMOTION_PROSODY = {
    "neutral": (1.0, 1.0, 1.0, 0.01),
    "happy": (1.28, 1.15, 1.1, 0.02),
    "sad": (0.82, 0.78, 0.75, 0.005),
    "angry": (1.1, 1.12, 1.5, 0.06),
}


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def _formant_envelope(freqs: np.ndarray, formants, scale: float,
                      tilt: float = 1.0) -> np.ndarray:
    """Lorentzian resonance peaks + spectral tilt; vectorized over freqs."""
    env = np.full_like(freqs, 0.015)
    gains = (1.0, 0.63, 0.35)
    bws = (90.0, 120.0, 180.0)
    for (f, g, bw) in zip(formants, gains, bws):
        fs = f * scale
        env += g / (1.0 + ((freqs - fs) / bw) ** 2)
    # -6 dB/oct source tilt, softened by `tilt` (angry -> brighter)
    env *= (1.0 + freqs / 500.0) ** (-tilt)
    return env


def synth_utterance(text: str, speaker_id: int, emotion: str = "neutral",
                    seed: int = 0, snr_db: Optional[float] = None,
                    rate: float = 1.0,
                    word_spans: Optional[list] = None,
                    english: bool = False,
                    speaker: Optional[Speaker] = None) -> np.ndarray:
    """Render text to 16 kHz float32 mono.

    word_spans, if passed a list, is filled with (char_index_ranges ->
    (sample_start, sample_end)) per character for frame-level labels.
    ``english=True`` routes through the phonetically-grounded G2P +
    phoneme formant path (train/synth_english.py) instead of the
    per-character cipher units — same span/noise contract.
    ``speaker`` overrides the hash-derived profile (matched-voice draws).
    """
    rng = np.random.default_rng(seed)
    spk = speaker if speaker is not None else speaker_profile(speaker_id)
    f0m, ratem, energym, jitter = _EMOTION_PROSODY.get(
        emotion, _EMOTION_PROSODY["neutral"])
    tilt = 0.7 if emotion == "angry" else 1.0
    rate_total = rate * ratem

    if english:
        from .synth_english import synth_utterance_en

        x = synth_utterance_en(
            text, spk, (f0m, ratem, energym, jitter), seed=seed,
            rate=rate, tilt=tilt, char_spans=word_spans)
        if snr_db is not None:
            sig_p = float(np.mean(x ** 2)) + 1e-12
            noise_p = sig_p / (10.0 ** (snr_db / 10.0))
            x = x + rng.standard_normal(len(x)).astype(
                np.float32) * np.sqrt(noise_p)
        np.clip(x, -1.0, 1.0, out=x)
        return x.astype(np.float32)

    pieces: List[np.ndarray] = []
    n_chars = len(text)
    total = 0
    # f0 declination across the utterance
    for i, ch in enumerate(text):
        u = unit_for_char(ch)
        n = max(16, int(u.dur_ms / 1000.0 * SAMPLE_RATE / rate_total))
        start = total
        if u.kind == "silence" or u.gain == 0.0:
            seg = np.zeros(n, np.float32)
        elif u.kind in ("vowel", "nasal"):
            decl = 1.0 - 0.25 * (i / max(1, n_chars))
            f0 = spk.f0 * f0m * decl * (1.0 + jitter * rng.standard_normal())
            t = (total + np.arange(n)) / SAMPLE_RATE
            vib = 1.0 + spk.vibrato_depth * np.sin(
                2 * np.pi * spk.vibrato_hz * t)
            inst_f0 = f0 * vib
            phase = 2 * np.pi * np.cumsum(inst_f0) / SAMPLE_RATE
            # cap harmonics at ~4.3 kHz: the formant envelope (F3 <= 3.2 kHz
            # x 1.2 scale) + spectral tilt makes higher partials inaudible,
            # and synthesis cost is linear in n_harm (single-core host)
            n_harm = int(min(28, 4300.0 // max(f0, 50.0)))
            k = np.arange(1, n_harm + 1)
            amps = _formant_envelope(k * f0, u.f, spk.formant_scale, tilt)
            seg = (np.sin(phase[None, :] * k[:, None]) *
                   amps[:, None]).sum(axis=0).astype(np.float32)
            seg /= max(1.0, np.abs(seg).max())
            seg += spk.breath * rng.standard_normal(n).astype(np.float32)
            seg *= u.gain
        elif u.kind == "fricative":
            noise = rng.standard_normal(n).astype(np.float32)
            spec = np.fft.rfft(noise)
            fr = np.fft.rfftfreq(n, 1.0 / SAMPLE_RATE)
            band = np.exp(-0.5 * ((fr - u.f[0] * spk.formant_scale)
                                  / u.f[1]) ** 2)
            seg = np.fft.irfft(spec * band, n).astype(np.float32)
            m = np.abs(seg).max()
            seg = seg / max(m, 1e-6) * u.gain
        else:  # stop: closure gap then burst
            gap = int(n * 0.45)
            burst = n - gap
            noise = rng.standard_normal(burst).astype(np.float32)
            spec = np.fft.rfft(noise)
            fr = np.fft.rfftfreq(burst, 1.0 / SAMPLE_RATE)
            band = np.exp(-0.5 * ((fr - u.f[0] * spk.formant_scale)
                                  / u.f[1]) ** 2)
            b = np.fft.irfft(spec * band, burst).astype(np.float32)
            b = b / max(np.abs(b).max(), 1e-6) * u.gain
            b *= np.exp(-np.arange(burst) / (0.25 * burst))  # decay
            seg = np.concatenate([np.zeros(gap, np.float32), b])
        # 5 ms edge fades against clicks
        edge = min(len(seg) // 4, int(0.005 * SAMPLE_RATE))
        if edge > 0:
            w = np.hanning(2 * edge)
            seg[:edge] *= w[:edge]
            seg[-edge:] *= w[edge:]
        pieces.append(seg)
        total += n
        if word_spans is not None:
            word_spans.append((start, total))

    x = np.concatenate(pieces) if pieces else np.zeros(16, np.float32)
    x *= 0.25 * energym
    if snr_db is not None:
        sig_p = float(np.mean(x ** 2)) + 1e-12
        noise_p = sig_p / (10.0 ** (snr_db / 10.0))
        x = x + rng.standard_normal(len(x)).astype(np.float32) * np.sqrt(
            noise_p)
    np.clip(x, -1.0, 1.0, out=x)
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# Example generation
# ---------------------------------------------------------------------------

@dataclass
class SynthExample:
    samples: np.ndarray        # 16 kHz float32
    text: str
    language: str              # display name
    code: str
    emotion: str
    speaker_id: int
    translation: Optional[str]  # English gloss, None iff English
    char_spans: List[Tuple[int, int]]  # per text char (sample_start, end)
    #: rendered in the bundled real recording's (perturbed) voice —
    #: the batcher labels these speaker 0 like the real English crops
    voice_matched: bool = False


def make_example(rng: np.random.Generator, *,
                 min_words: int = 3, max_words: int = 10,
                 languages: Sequence[SynthLanguage] = LANGUAGES,
                 clean: bool = False,
                 snr_range: Tuple[float, float] = (8.0, 40.0),
                 voice_match_p: float = 0.0,
                 english_sentence_p: float = 0.0
                 ) -> SynthExample:
    lang = languages[int(rng.integers(len(languages)))]
    if (lang.is_english and english_sentence_p > 0
            and rng.random() < english_sentence_p):
        # grammatical English from the sentence bank (real word order,
        # function-word rhythm) instead of an i.i.d. lexicon draw
        from .english_text import sample_sentence

        text = sample_sentence(rng, min_words=min_words,
                               max_words=max_words)
        translation = None
    else:
        lex = lexicon(lang)
        n_words = int(rng.integers(min_words, max_words + 1))
        # zipf-ish index draw keeps common words common
        idx = np.minimum(
            (rng.pareto(1.2, n_words) * 12).astype(int), LEXICON_SIZE - 1)
        words = [lex[i] for i in idx]
        text = " ".join(words)
        translation = (None if lang.is_english
                       else " ".join(ENGLISH_WORDS[i] for i in idx))
    emotion = EMOTIONS[int(rng.integers(len(EMOTIONS)))]
    speaker_id = int(rng.integers(N_SPEAKERS))
    speaker = None
    if lang.is_english and voice_match_p > 0 and rng.random() < voice_match_p:
        # Matched-voice English: render in (a perturbation of) the bundled
        # real recording's voice; speaker_id 0 is that voice's label (the
        # real English crops in SynthBatcher._one use the same id).
        speaker = matched_voice(rng)
        speaker_id = 0
        emotion = "neutral"
    spans: List[Tuple[int, int]] = []
    samples = synth_utterance(
        text, speaker_id, emotion, seed=int(rng.integers(2**31)),
        snr_db=None if clean else float(rng.uniform(*snr_range)),
        rate=float(rng.uniform(0.9, 1.15)),
        word_spans=spans, english=lang.is_english, speaker=speaker)
    return SynthExample(samples=samples, text=text, language=lang.name,
                        code=lang.code, emotion=emotion,
                        speaker_id=speaker_id, translation=translation,
                        char_spans=spans, voice_matched=speaker is not None)


def make_codeswitch_example(rng: np.random.Generator,
                            clean: bool = False,
                            min_words: int = 2,
                            max_words: int = 5) -> SynthExample:
    """Two-language utterance (code-switching, reference prompt req #4) with
    per-char spans so frame LID labels switch mid-utterance. min/max_words
    bound EACH half (so the length curriculum can cap total length)."""
    la, lb = rng.choice(len(LANGUAGES), size=2, replace=False)
    a = make_example(rng, min_words=min_words, max_words=max_words,
                     languages=[LANGUAGES[la]], clean=clean)
    b = make_example(rng, min_words=min_words, max_words=max_words,
                     languages=[LANGUAGES[lb]], clean=clean)
    gap = np.zeros(int(0.12 * SAMPLE_RATE), np.float32)
    samples = np.concatenate([a.samples, gap, b.samples])
    off = len(a.samples) + len(gap)
    text = a.text + " " + b.text
    spans = (a.char_spans + [(len(a.samples), off)]
             + [(s + off, e + off) for (s, e) in b.char_spans])
    ex = SynthExample(
        samples=samples, text=text, language=a.language, code=a.code,
        emotion=a.emotion, speaker_id=a.speaker_id,
        translation=None, char_spans=spans)
    ex.lid_span_langs = ([a.language] * (len(a.text) + 1)
                         + [b.language] * len(b.text))  # type: ignore
    return ex


# ---------------------------------------------------------------------------
# Real bundled recordings via their word-aligned EAF goldens
# ---------------------------------------------------------------------------

def parse_eaf_words(eaf_path: str | Path) -> List[Tuple[float, float, str]]:
    """(start_s, end_s, word) from an ELAN EAF word tier (the reference ships
    gettysburg.eaf / samuel_lisu.eaf goldens, SURVEY C25)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(str(eaf_path)).getroot()
    slots = {
        ts.get("TIME_SLOT_ID"): float(ts.get("TIME_VALUE", "0")) / 1000.0
        for ts in root.iter("TIME_SLOT")
    }
    words = []
    for tier in root.iter("TIER"):
        lt = (tier.get("LINGUISTIC_TYPE_REF") or "").lower()
        if "word" not in lt and "word" not in (tier.get("TIER_ID") or "").lower():
            continue
        for ann in tier.iter("ALIGNABLE_ANNOTATION"):
            t0 = slots.get(ann.get("TIME_SLOT_REF1"))
            t1 = slots.get(ann.get("TIME_SLOT_REF2"))
            val = ann.findtext("ANNOTATION_VALUE") or ""
            if t0 is not None and t1 is not None and val.strip():
                words.append((t0, t1, val.strip()))
    words.sort(key=lambda w: w[0])
    return words


def eaf_windows(audio_path: str | Path, eaf_path: str | Path, *,
                language: str, code: str, window_s: float = 12.0,
                hold_out_after: Optional[float] = None,
                ) -> List[dict]:
    """Cut a real recording into <=window_s training windows with exact texts
    from the EAF word alignment. Windows starting after ``hold_out_after``
    seconds are tagged split='eval' (held-out for honest WER), others 'train'.
    """
    from ..audio.decode import decode_audio
    from ..audio.resample import resample

    samples, sr = decode_audio(audio_path)
    if sr != SAMPLE_RATE:
        samples = resample(samples, sr, SAMPLE_RATE)
    words = parse_eaf_words(eaf_path)
    out: List[dict] = []
    i = 0
    while i < len(words):
        t0 = words[i][0]
        j = i
        while j + 1 < len(words) and words[j + 1][1] - t0 <= window_s:
            # never pack across the hold-out boundary, so the eval tail
            # gets its own (never-trained-on) windows
            if (hold_out_after is not None and t0 < hold_out_after
                    and words[j + 1][1] > hold_out_after):
                break
            j += 1
        t1 = words[j][1]
        pad = 0.15
        s0 = max(0, int((t0 - pad) * SAMPLE_RATE))
        s1 = min(len(samples), int((t1 + pad) * SAMPLE_RATE))
        text = " ".join(w[2] for w in words[i:j + 1])
        split = ("eval" if hold_out_after is not None and t0 >= hold_out_after
                 else "train")
        out.append({
            "samples": samples[s0:s1].copy(), "text": text,
            "language": language, "code": code, "start_s": t0, "end_s": t1,
            "split": split,
        })
        i = j + 1
    return out


def real_corpus(reference_dir: str | Path = "/root/reference",
                hold_out_frac: float = 0.25,
                window_s: float = 12.0) -> Tuple[List[dict], List[dict]]:
    """(train_windows, eval_windows) from the bundled real recordings.
    Returns empty lists when the assets are absent (CI without the
    reference checkout)."""
    ref = Path(reference_dir)
    # Only recordings with trustworthy transcripts: gettysburg.eaf is the
    # actual Gettysburg Address; samuel_lisu.eaf's "Lisu" text is
    # Gemini-hallucinated mixed-script noise (Arabic/CJK/Burmese fragments),
    # so training on it would teach inconsistent labels — that file stays a
    # demo/diarization asset only.
    pairs = [
        (ref / "gettysburg.wav", ref / "gettysburg.eaf", "English", "en"),
    ]
    train: List[dict] = []
    evals: List[dict] = []
    for audio, eaf, name, code in pairs:
        if not (audio.exists() and eaf.exists()):
            continue
        words = parse_eaf_words(eaf)
        if not words:
            continue
        t_end = words[-1][1]
        cut = t_end * (1.0 - hold_out_frac)
        for w in eaf_windows(audio, eaf, language=name, code=code,
                             window_s=window_s, hold_out_after=cut):
            (train if w["split"] == "train" else evals).append(w)
    return train, evals


def real_recordings(reference_dir: str | Path = "/root/reference",
                    hold_out_frac: float = 0.25):
    """Raw word-aligned recordings for RANDOM-crop training draws:
    [(samples, words, cut_s, language, code)].

    The fixed windows real_corpus cuts give only 2-3 distinct training
    examples per recording; drawing a fresh random word span per draw
    multiplies the scarce real data into hundreds of distinct crops
    (every contiguous word span below the window), which is the cheap
    lever against memorizing exact window boundaries."""
    ref = Path(reference_dir)
    pairs = [
        (ref / "gettysburg.wav", ref / "gettysburg.eaf", "English", "en"),
    ]
    out = []
    for audio, eaf, name, code in pairs:
        if not (audio.exists() and eaf.exists()):
            continue
        words = parse_eaf_words(eaf)
        if not words:
            continue
        from ..audio.decode import decode_audio
        from ..audio.resample import resample

        samples, sr = decode_audio(audio)
        if sr != SAMPLE_RATE:
            samples = resample(samples, sr, SAMPLE_RATE)
        cut = words[-1][1] * (1.0 - hold_out_frac)
        out.append((samples, words, cut, name, code))
    return out


_LTAS_GRID = 256
_LTAS_REAL: "Optional[List[np.ndarray]] | bool" = None


def unique_real_audio(reference_dir: str | Path = "/root/reference"
                      ) -> List[Path]:
    """Paths of the UNIQUE real recordings bundled with the reference:
    gettysburg.wav, the Lisu demo, and the distinct files in the demo app's
    uploads folder (which is mostly copies — deduped by size + head hash).
    Only gettysburg has a trustworthy transcript (real_corpus); the rest
    are unlabeled but still real channels/voices, used for channel-
    statistics matching (real_ltas_match), never for supervision."""
    import hashlib

    ref = Path(reference_dir)
    cands = [ref / "gettysburg.wav",
             ref / "public" / "codeswitching-demo.mp3"]
    uploads = ref / "workflows" / "wav2elan_web" / "uploads"
    if uploads.is_dir():
        cands.extend(sorted(uploads.rglob("*")))
    seen = set()
    out: List[Path] = []
    for p in cands:
        try:
            if not (p.is_file() and p.suffix.lower() in
                    (".wav", ".mp3", ".flac", ".ogg")):
                continue
            with open(p, "rb") as f:
                head = f.read(65536)
            key = (p.stat().st_size, hashlib.md5(head).hexdigest())
        except OSError:
            continue
        if key in seen:
            continue
        seen.add(key)
        out.append(p)
    return out


def _smoothed_ltas(x: np.ndarray, grid: int = _LTAS_GRID) -> np.ndarray:
    """Welch-style long-term average power spectrum, resampled to a fixed
    control grid (64 ms Hann windows)."""
    win = 1024
    n = (len(x) // win) * win
    if n == 0:
        return np.ones(grid, np.float32)
    frames = x[:n].reshape(-1, win) * np.hanning(win)
    p = (np.abs(np.fft.rfft(frames, axis=1)) ** 2).mean(axis=0)
    p = np.maximum(p, float(p.max()) * 1e-8)
    src = np.linspace(0.0, 1.0, len(p))
    dst = np.linspace(0.0, 1.0, grid)
    return np.interp(dst, src, p).astype(np.float32)


def real_ltas_match(row: np.ndarray,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """EQ a synthetic-English draw toward a real recording's long-term
    average spectrum. Targets: the supervised recording's TRAIN portion
    (the held-out tail contributes nothing) plus every other unique real
    recording on the box (unique_real_audio — unlabeled audio is fair game
    for channel statistics). One target is drawn per call; the measured
    synthetic→real gap is largely acoustic-condition mismatch, and
    matching channel statistics is standard domain adaptation. ±12 dB cap,
    level-preserving."""
    global _LTAS_REAL
    if _LTAS_REAL is None:
        targets: List[np.ndarray] = []
        recs = real_recordings()
        if recs:
            samples, words, cut, _, _ = recs[0]
            targets.append(_smoothed_ltas(samples[: int(cut * SAMPLE_RATE)]))
        for p in unique_real_audio():
            if p.name == "gettysburg.wav":
                continue   # already included (train portion only)
            try:
                from ..audio.decode import decode_audio
                from ..audio.resample import resample

                x, sr = decode_audio(p)
                if sr != SAMPLE_RATE:
                    x = resample(x, sr, SAMPLE_RATE)
                targets.append(_smoothed_ltas(x))
            except Exception:
                continue
        _LTAS_REAL = targets if targets else False
    if _LTAS_REAL is False or len(row) < 2048:
        return row
    i = 0 if rng is None else int(rng.integers(len(_LTAS_REAL)))
    own = _smoothed_ltas(row)
    ratio = np.sqrt(_LTAS_REAL[i] / np.maximum(own, 1e-12))
    ratio /= max(float(ratio.mean()), 1e-6)   # preserve overall level
    ratio = np.clip(ratio, 10 ** (-12 / 20), 10 ** (12 / 20))
    m = len(row)
    spec = np.fft.rfft(row, m)
    eq = np.interp(np.linspace(0.0, 1.0, m // 2 + 1),
                   np.linspace(0.0, 1.0, len(ratio)), ratio)
    out = np.fft.irfft(spec * eq, m).astype(np.float32)
    peak = float(np.abs(out).max())
    if peak > 1.0:
        out /= peak
    return out


def random_real_window(rec, rng: np.random.Generator,
                       window_s: float) -> dict:
    """One random contiguous word span (entirely before the hold-out cut)
    cropped with jittered padding — exact text from the EAF alignment."""
    samples, words, cut, name, code = rec
    starts = [i for i, w in enumerate(words) if w[1] <= cut]
    i = starts[int(rng.integers(len(starts)))]
    t0 = words[i][0]
    j = i
    while (j + 1 < len(words) and words[j + 1][1] - t0 <= window_s
           and words[j + 1][1] <= cut):
        j += 1
    t1 = words[j][1]
    pad0 = float(rng.uniform(0.05, 0.25))
    pad1 = float(rng.uniform(0.05, 0.25))
    s0 = max(0, int((t0 - pad0) * SAMPLE_RATE))
    s1 = min(len(samples), int((t1 + pad1) * SAMPLE_RATE))
    return {"samples": samples[s0:s1].copy(),
            "text": " ".join(w[2] for w in words[i:j + 1]),
            "language": name, "code": code, "split": "train"}


# ---------------------------------------------------------------------------
# Fixed-shape batching for the trainer
# ---------------------------------------------------------------------------

class SynthBatcher:
    """Infinite fixed-shape batch stream mixing synthetic utterances,
    code-switch utterances, and (augmented) real windows.

    Produces the train-step batch dict (see train/step.py): samples, mask,
    labels, label_mask, lid_label, emotion_label, speaker_label,
    lid_frame_label [B,T'] (-1 = unlabeled frame), and translation
    teacher-forcing tensors trans_in/trans_tgt/trans_mask.
    """

    def __init__(self, cfg, *, batch_size: int, window_seconds: float = 8.0,
                 max_label_len: int = 256, max_trans_len: int = 192,
                 seed: int = 0, real_fraction: float = 0.15,
                 codeswitch_fraction: float = 0.1,
                 reference_dir: str | Path = "/root/reference",
                 prefetch: int = 4, n_threads: int = 4,
                 frame_multiple: int = 0,
                 snr_range: Tuple[float, float] = (8.0, 40.0),
                 reuse_pool: int = 0, reuse_p: float = 0.75,
                 speed_range: Optional[Tuple[float, float]] = None,
                 channel_aug_p: float = 0.0,
                 real_match_p: float = 0.0,
                 english_fraction: float = 0.0,
                 voice_match_p: float = 0.0,
                 english_sentence_p: float = 0.0,
                 bake_mode: bool = False):
        import queue
        import threading

        from ..models import languages as lang_table

        self.cfg = cfg
        self.batch_size = batch_size
        self.max_label_len = max_label_len
        self.max_trans_len = max_trans_len
        fe = cfg.frontend
        self.window_samples = int(window_seconds * fe.sample_rate)
        n_frames = fe.frames_for_samples(self.window_samples)
        sub = cfg.encoder.subsample_factor
        # frame_multiple > sub pads T so T/sub tiles Pallas blocks
        # (e.g. 256*sub enables the flash-attention training path)
        mult = max(frame_multiple, sub)
        self.window_frames = ((n_frames + mult - 1) // mult) * mult
        self.sub = sub
        self.real_fraction = real_fraction
        self.snr_range = snr_range
        #: sox-style speed perturbation range (e.g. (0.9, 1.1)); None = off.
        #: Applied per draw in _collate so pooled examples get unique rates
        #: — multiplies the scarce real windows for generalization.
        self.speed_range = speed_range
        #: probability of simulating a room/channel per draw: synthetic
        #: reverb (exponentially-decaying noise IR) + spectral tilt EQ in
        #: one FFT round trip. Decorrelates the model from the synthetic
        #: corpus's perfectly-dry channel so the scarce real windows
        #: (real_corpus) aren't the only channel variety it ever sees.
        self.channel_aug_p = channel_aug_p
        #: probability of EQ-matching an English draw to the real
        #: recording's long-term average spectrum (real_ltas_match) —
        #: domain adaptation for the synthetic->real acoustic gap.
        self.real_match_p = real_match_p
        #: share of SYNTHETIC draws pinned to English (0 = uniform over
        #: languages) — the English-transfer fine-tune knob
        self.english_fraction = english_fraction
        #: probability an English synth draw renders in the real
        #: recording's (perturbed) voice, labeled speaker 0
        self.voice_match_p = voice_match_p
        #: probability an English synth draw uses the grammatical sentence
        #: bank (train/english_text.py) instead of an i.i.d. lexicon draw
        self.english_sentence_p = english_sentence_p
        self.codeswitch_fraction = codeswitch_fraction
        self._lang_id = lang_table.id_for_language
        self.real_train, self.real_eval = real_corpus(
            reference_dir, window_s=window_seconds)
        # Raw aligned recordings: real draws are fresh random word-span
        # crops (see random_real_window) rather than the few fixed windows.
        self._real_recs = real_recordings(reference_dir)
        self._window_s = window_seconds
        if not self.real_train:
            self.real_fraction = 0.0
        # Reuse pool (single-core hosts): clean synthesized examples are
        # re-drawn with FRESH noise/gain at collate time, so the expensive
        # harmonic synthesis amortizes over ~1/(1-reuse_p) uses while the
        # additive-noise augmentation stays unique per draw.
        self._pool: List[dict] = []
        self._pool_max = reuse_pool
        self._reuse_p = reuse_p if reuse_pool else 0.0
        #: bake mode (device-resident pool, train/device_pool.py): collate
        #: applies the EXPENSIVE per-draw augments (speed/channel/LTAS EQ)
        #: but leaves gain + additive noise to the on-device augmenter, so
        #: pool entries stay clean for fresh per-step noise realizations.
        self._bake = bake_mode
        # curriculum knobs (read by producer threads each draw; set via
        # set_curriculum from the training loop at stage boundaries)
        self._cur_min_words: Optional[int] = None
        self._cur_max_words: Optional[int] = None
        self._simple_only = False
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._producer, args=(seed + 7919 * t,),
                             daemon=True)
            for t in range(n_threads)
        ]
        for t in self._threads:
            t.start()

    # -- example -> padded arrays -------------------------------------------

    def _encode_text(self, text: str):
        from ..ops.ctc import text_to_byte_labels

        return text_to_byte_labels(text, self.cfg.vocab, self.max_label_len)

    def set_curriculum(self, *, min_words: Optional[int] = None,
                       max_words: Optional[int] = None,
                       simple_only: bool = False,
                       clear_pool: bool = False) -> None:
        """Length curriculum: cap utterance word counts and optionally
        restrict to plain single-language examples (no real windows /
        code-switch). Takes effect on subsequent producer draws; already-
        queued batches drain first. clear_pool drops pooled examples from
        the previous stage."""
        self._cur_min_words = min_words
        self._cur_max_words = max_words
        self._simple_only = simple_only
        if clear_pool:
            self._pool = []   # reassign (not clear): racing readers keep
            #                   the old list snapshot safely

    def _one(self, rng) -> dict:
        """Fresh CLEAN example (noise/gain are applied per-draw in
        _collate so pooled examples get unique augmentation)."""
        mw = self._cur_max_words
        if mw is not None or self._simple_only:
            kw = {}
            if mw is not None:
                kw = {"min_words": self._cur_min_words or 1,
                      "max_words": mw}
            r = rng.random()
            if (not self._simple_only
                    and r < self.codeswitch_fraction and (mw or 10) >= 4):
                # Each half gets half the stage's word budget so stage-2
                # (max_words=5) batches respect the length curriculum
                # (ADVICE r2: full-length code-switch leaked in before).
                ex = make_codeswitch_example(
                    rng, clean=True, min_words=1,
                    max_words=max(2, (mw or 10) // 2))
            else:
                ex = make_example(rng, clean=True,
                                  **self._english_kw(rng), **kw)
            return {"samples": ex.samples, "text": ex.text,
                    "language": ex.language, "emotion": ex.emotion,
                    "speaker_id": self._spk_label(ex),
                    "translation": ex.translation,
                    "char_spans": ex.char_spans,
                    "lid_span_langs": getattr(ex, "lid_span_langs", None)}
        r = rng.random()
        if r < self.real_fraction:
            if self._real_recs:
                rec = self._real_recs[int(rng.integers(len(self._real_recs)))]
                w = random_real_window(rec, rng, self._window_s)
            else:
                w = self.real_train[int(rng.integers(len(self.real_train)))]
            return {"samples": w["samples"], "text": w["text"],
                    "language": w["language"], "emotion": "neutral",
                    "speaker_id": 0 if w["language"] == "English" else 1,
                    "translation": None, "char_spans": None,
                    "lid_span_langs": None}
        if r < self.real_fraction + self.codeswitch_fraction:
            ex = make_codeswitch_example(rng, clean=True)
            return {"samples": ex.samples, "text": ex.text,
                    "language": ex.language, "emotion": ex.emotion,
                    "speaker_id": 2 + ex.speaker_id % (N_SPEAKERS - 2),
                    "translation": ex.translation,
                    "char_spans": ex.char_spans,
                    "lid_span_langs": getattr(ex, "lid_span_langs", None)}
        ex = make_example(rng, clean=True, **self._english_kw(rng))
        return {"samples": ex.samples, "text": ex.text,
                "language": ex.language, "emotion": ex.emotion,
                "speaker_id": self._spk_label(ex),
                "translation": ex.translation, "char_spans": ex.char_spans,
                "lid_span_langs": None}

    def _english_kw(self, rng) -> dict:
        """English oversampling + matched-voice kwargs for make_example.
        english_fraction > 0 pins the language to English for that share
        of synthetic draws (the rest keep the uniform language draw)."""
        kw: dict = {}
        if self.voice_match_p > 0:
            kw["voice_match_p"] = self.voice_match_p
        if self.english_sentence_p > 0:
            kw["english_sentence_p"] = self.english_sentence_p
        if self.english_fraction > 0 and rng.random() < self.english_fraction:
            kw["languages"] = [LANGUAGES[0]]   # English (LANGUAGES[0])
        return kw

    @staticmethod
    def _spk_label(ex: SynthExample) -> int:
        """Synth speakers map to ids >=2; matched-voice English renders ARE
        the real English voice, so they share its label 0 (real crops)."""
        if getattr(ex, "voice_matched", False):
            return 0
        return 2 + ex.speaker_id % (N_SPEAKERS - 2)

    def set_pool(self, pool_max: int, reuse_p: float) -> None:
        """Pool-size curriculum: CTC-from-scratch breaks off the unigram-
        prior plateau by (partially) memorizing a SMALL pool first — the
        per-char acoustics learned there transfer — then the pool grows so
        generalization takes over (see tools/diag_overfit.py findings)."""
        self._pool_max = int(pool_max)
        self._reuse_p = reuse_p if pool_max else 0.0
        if len(self._pool) > self._pool_max:
            self._pool = self._pool[: self._pool_max]

    def _draw(self, rng) -> dict:
        pool = self._pool   # snapshot: set_curriculum may swap the list
        pmax = self._pool_max
        if (pmax and len(pool) >= min(64, pmax)
                and rng.random() < self._reuse_p
                * min(1.0, len(pool) / float(pmax))):
            return pool[int(rng.integers(len(pool)))]
        ex = self._one(rng)
        if self._pool_max:
            if len(pool) >= self._pool_max:
                pool[int(rng.integers(len(pool)))] = ex
            else:
                pool.append(ex)
        return ex

    def _collate(self, exs: List[dict],
                 rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, np.ndarray]:
        B = len(exs)
        fe = self.cfg.frontend
        samples = np.zeros((B, self.window_samples), np.float32)
        mask = np.zeros((B, self.window_frames), bool)
        labels = np.zeros((B, self.max_label_len), np.int32)
        lmask = np.zeros((B, self.max_label_len), bool)
        lid = np.zeros(B, np.int32)
        emo = np.zeros(B, np.int32)
        spk = np.zeros(B, np.int32)
        Tp = self.window_frames // self.sub
        lid_frames = np.full((B, Tp), -1, np.int32)
        char_frames = np.full((B, Tp), -1, np.int32)
        tin = np.zeros((B, self.max_trans_len), np.int32)
        ttgt = np.zeros((B, self.max_trans_len), np.int32)
        tmask = np.zeros((B, self.max_trans_len), bool)
        nsamp = np.zeros(B, np.int32)

        frame_dur = fe.hop_length * self.sub / fe.sample_rate
        for b, ex in enumerate(exs):
            if rng is not None and self.speed_range is not None:
                f = float(rng.uniform(*self.speed_range))
                if abs(f - 1.0) > 1e-3:
                    ex = _speed_perturb(ex, f)
            # consistent audio/text truncation to the window (trim_to_window)
            x, text, translation, spans = trim_to_window(
                ex, self.window_samples)
            span_langs = ex.get("lid_span_langs")
            if span_langs is not None and spans:
                span_langs = span_langs[:len(spans)]
            ex = dict(ex, samples=x, text=text, translation=translation,
                      char_spans=spans or None, lid_span_langs=span_langs)
            n = min(len(x), self.window_samples)
            row = x[:n]
            if rng is not None and self.channel_aug_p > 0 \
                    and rng.random() < self.channel_aug_p:
                row = _channel_sim(row, rng)
            if (rng is not None and self.real_match_p > 0
                    and ex.get("language") == "English"
                    and rng.random() < self.real_match_p):
                row = real_ltas_match(row, rng)
            if rng is not None and not self._bake:
                # per-draw augmentation: gain + additive noise at a random
                # SNR (examples may come from the clean reuse pool)
                row = row * float(rng.uniform(0.7, 1.3))
                p_sig = float(np.mean(row ** 2)) + 1e-12
                snr = float(rng.uniform(*self.snr_range))
                row = row + rng.standard_normal(n).astype(
                    np.float32) * np.sqrt(p_sig / 10 ** (snr / 10))
                np.clip(row, -1.0, 1.0, out=row)
            samples[b, :n] = row
            nsamp[b] = n
            n_valid = fe.frames_for_samples(n)
            mask[b, :n_valid] = True
            lab, lm = self._encode_text(ex["text"])
            labels[b], lmask[b] = lab, lm
            lang_id = self._lang_id(ex["language"]) or 0
            lid[b] = max(lang_id, 0)
            emo[b] = (EMOTIONS.index(ex["emotion"])
                      if ex["emotion"] in EMOTIONS else 3)
            spk[b] = ex["speaker_id"] % N_SPEAKERS
            # frame-level LID labels from char spans (code-switch aware)
            spans = ex.get("char_spans")
            span_langs = ex.get("lid_span_langs")
            if spans:
                for ci, (s0, s1) in enumerate(spans):
                    if s0 >= n:
                        break
                    name = (span_langs[ci] if span_langs
                            and ci < len(span_langs) else ex["language"])
                    lidc = self._lang_id(name) or 0
                    fa = int(s0 / fe.sample_rate / frame_dur)
                    fb = int(min(s1, n) / fe.sample_rate / frame_dur)
                    lid_frames[b, fa:min(fb + 1, Tp)] = max(lidc, 0)
                # frame-level CHARACTER supervision from the same spans:
                # the synthesizer knows exactly which char sounds when, so
                # a dense per-frame byte CE can bootstrap the acoustics
                # without CTC's alignment search (loss_fn "char_frame_label")
                text = ex["text"]
                for ci, (s0, s1) in enumerate(spans):
                    if s0 >= n or ci >= len(text):
                        break
                    ch = text[ci]
                    if ch.isspace():
                        continue   # leave blank-eligible frames unlabeled
                    ids = [self.cfg.vocab.byte_to_id(x)
                           for x in ch.encode("utf-8")]
                    fa = int(s0 / fe.sample_rate / frame_dur)
                    fb = min(int(min(s1, n) / fe.sample_rate / frame_dur)
                             + 1, Tp)
                    nf = fb - fa
                    if nf <= 0:
                        continue
                    # multi-byte chars: split the span evenly across bytes
                    # (preserves the byte order CTC must emit)
                    for k, bid in enumerate(ids):
                        a = fa + (nf * k) // len(ids)
                        z = fa + (nf * (k + 1)) // len(ids)
                        char_frames[b, a:max(z, a + 1)] = bid
            else:
                nf = min(Tp, int(n / fe.sample_rate / frame_dur))
                lid_frames[b, :nf] = max(lang_id, 0)
            # translation teacher forcing: BOS(0) + bytes -> bytes + EOS(0)
            tr = ex.get("translation")
            if tr:
                bs = tr.encode("utf-8")[: self.max_trans_len - 1]
                ids = [self.cfg.vocab.byte_to_id(x) for x in bs]
                tin[b, 0] = 0
                tin[b, 1:1 + len(ids)] = ids
                ttgt[b, :len(ids)] = ids
                ttgt[b, len(ids)] = 0  # EOS
                tmask[b, :len(ids) + 1] = True
        out = {
            "samples": samples, "mask": mask, "labels": labels,
            "label_mask": lmask, "lid_label": lid, "emotion_label": emo,
            "speaker_label": spk, "lid_frame_label": lid_frames,
            "char_frame_label": char_frames,
            "trans_in": tin, "trans_tgt": ttgt, "trans_mask": tmask,
        }
        if self._bake:
            # valid-sample counts: the on-device augmenter masks its noise
            # to the real signal region (host noise stops at n too)
            out["n_samples"] = nsamp
        return out

    def _producer(self, seed: int):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            exs = [self._draw(rng) for _ in range(self.batch_size)]
            batch = self._collate(exs, rng)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except Exception:
                    continue

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        import queue

        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                continue

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass


def _channel_sim(row: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Room/channel simulation in one FFT round trip: convolve with a
    short exponentially-decaying noise IR (direct path dominant, RT
    30-150 ms) and apply a random spectral tilt (+-3 dB/oct around 1 kHz).
    Keeps timing intact (direct path at t=0), so char span labels hold."""
    n = len(row)
    if n < 256:
        return row
    ir_len = int(rng.uniform(0.03, 0.15) * SAMPLE_RATE)
    t = np.arange(ir_len, dtype=np.float32)
    decay = np.exp(-t / (0.25 * ir_len))
    ir = rng.standard_normal(ir_len).astype(np.float32) * decay
    ir /= max(float(np.linalg.norm(ir)), 1e-6)     # unit-energy tail
    ir *= float(rng.uniform(0.1, 0.45))            # wet level
    ir[0] += 1.0                                   # direct path
    m = n + ir_len
    spec = np.fft.rfft(row, m) * np.fft.rfft(ir, m)
    tilt_oct = float(rng.uniform(-3.0, 3.0))       # dB per octave
    fr = np.fft.rfftfreq(m, 1.0 / SAMPLE_RATE)
    eq = 10.0 ** (tilt_oct * np.log2(np.maximum(fr, 60.0) / 1000.0) / 20.0)
    out = np.fft.irfft(spec * eq, m)[:n].astype(np.float32)
    peak = float(np.abs(out).max())
    if peak > 1.0:
        out /= peak
    return out


def _speed_perturb(ex: dict, factor: float) -> dict:
    """Sox-style speed perturbation: resample by ``factor`` (>1 = faster/
    shorter, pitch shifts with rate, as in the standard Kaldi/sox recipe).
    Char spans rescale with the timeline so frame LID/char labels stay
    aligned. Text/labels are unchanged."""
    x = ex["samples"]
    new_len = max(1, int(round(len(x) / factor)))
    pos = np.linspace(0.0, len(x) - 1.0, new_len)
    y = np.interp(pos, np.arange(len(x)), x).astype(np.float32)
    spans = ex.get("char_spans")
    if spans:
        spans = [(int(s0 / factor), int(s1 / factor)) for (s0, s1) in spans]
    return dict(ex, samples=y, char_spans=spans)


def trim_to_window(ex: "SynthExample | dict", window_samples: int,
                   ) -> Tuple[np.ndarray, str, Optional[str], list]:
    """Consistently truncate (samples, text, translation, char_spans) so the
    transcript exactly matches the audio that fits the training window —
    clipping audio while keeping the full label would corrupt CTC training.

    Cuts at the last *word* boundary whose samples end inside the window;
    the English gloss is cut to the same number of words (the lexicons are
    word-aligned ciphers).
    """
    if isinstance(ex, dict):
        samples, text = ex["samples"], ex["text"]
        translation, spans = ex.get("translation"), ex.get("char_spans")
    else:
        samples, text = ex.samples, ex.text
        translation, spans = ex.translation, ex.char_spans
    if len(samples) <= window_samples:
        return samples, text, translation, spans or []
    if not spans:
        # no alignment info (real windows are pre-cut to the window length;
        # this is a safety net): keep audio + text unchanged
        return samples, text, translation, []
    # last char whose audio fully fits
    ci = 0
    for i, (_, e) in enumerate(spans):
        if e <= window_samples:
            ci = i + 1
        else:
            break
    new_text = text[:ci]
    if ci < len(text) and not text[ci].isspace() and " " in new_text:
        # truncation landed mid-word: drop the partial word
        new_text = new_text.rsplit(" ", 1)[0]
    new_text = new_text.rstrip()
    ci = len(new_text)
    n_words = len(new_text.split()) if new_text else 0
    new_trans = (" ".join(translation.split()[:n_words])
                 if translation and n_words else None)
    # Silence the window past the last kept character: otherwise the audio
    # of the dropped word(s) remains voiced but unlabeled, teaching CTC to
    # emit blank over clear speech (deletion bias).
    out = np.array(samples[:window_samples], copy=True)
    cut = int(spans[ci - 1][1]) if ci else 0
    out[min(cut, window_samples):] = 0.0
    return out, new_text, new_trans, list(spans[:ci])


def eval_set(n: int = 64, seed: int = 10_000_019,
             clean: bool = False) -> List[SynthExample]:
    """Held-out synthetic eval examples: the seed space is disjoint from any
    training stream seeded below 10_000_000."""
    rng = np.random.default_rng(seed)
    return [make_example(rng, clean=clean) for _ in range(n)]
