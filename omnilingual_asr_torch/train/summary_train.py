"""Free-text summarizer training on synthetic conversations: the data half
of ``omnilingual_asr_tpu/train/summary_train.py``, numpy only.

The JAX trainer teaches the summary decoder to state a conversation's
speaker count, language(s) and overall tone from the frozen encoder's
pooled states. Its conversations are composed here, bit for bit as the JAX
module composes them (``eval/heads.py`` scores the release summarizer on
them). The trainer itself is not ported yet (A11 in ROADMAP.md):
``train_summary`` and ``python -m omnilingual_asr_torch.train.summary_train``
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..types import EMOTIONS
from .synth import _not_ported


def build_utterance_pool(rng: np.random.Generator, n: int):
    """n clean utterances with known (samples, language, emotion, speaker)."""
    from .synth import LANGUAGES, lexicon, synth_utterance

    pool = []
    for _ in range(n):
        lang = LANGUAGES[int(rng.integers(len(LANGUAGES)))]
        lex = lexicon(lang)
        idx = np.minimum((rng.pareto(1.2, int(rng.integers(3, 8)))
                          * 12).astype(int), len(lex) - 1)
        text = " ".join(lex[i] for i in idx)
        emotion = EMOTIONS[int(rng.integers(len(EMOTIONS)))]
        # small voice set -> several utterances per speaker, so composed
        # conversations don't repeat one clip per speaker
        speaker = int(rng.integers(48))
        x = synth_utterance(text, speaker, emotion,
                            seed=int(rng.integers(2**31)),
                            rate=float(rng.uniform(0.9, 1.15)))
        pool.append({"samples": x, "language": lang.name,
                     "emotion": emotion, "speaker": speaker})
    return pool


def make_conversation(rng: np.random.Generator, pool,
                      sr: int = 16000) -> Tuple[np.ndarray, Dict]:
    """Compose a conversation from pool utterances.

    Facts are chosen first (n_speakers, 1-2 languages, dominant tone) and
    the pool is filtered to match, so labels are exact by construction.
    """
    langs = sorted({u["language"] for u in pool})
    while True:  # redraw facts until the pool can realize them
        n_speakers = int(rng.integers(1, 5))
        n_langs = int(rng.integers(1, 3))
        conv_langs = list(rng.choice(langs, size=n_langs, replace=False))
        tone = EMOTIONS[int(rng.integers(len(EMOTIONS)))]

        cands = [u for u in pool if u["language"] in conv_langs]
        by_speaker: Dict[int, list] = {}
        for u in cands:
            by_speaker.setdefault(u["speaker"], []).append(u)
        spk_pool = [s for s, us in by_speaker.items()
                    if any(u["emotion"] == tone for u in us)]
        if len(spk_pool) >= n_speakers:
            break
    chosen = list(rng.choice(spk_pool, size=n_speakers, replace=False))

    pieces, used_langs = [], set()
    n_turns = int(rng.integers(max(2, n_speakers), 9))
    for t in range(n_turns):
        who = chosen[t % n_speakers]
        opts = [u for u in by_speaker[who]
                # majority of turns carry the dominant tone
                if (u["emotion"] == tone or rng.random() < 0.25)]
        u = opts[int(rng.integers(len(opts)))]
        used_langs.add(u["language"])
        pieces.append(np.zeros(int(rng.uniform(0.15, 0.5) * sr), np.float32))
        pieces.append(u["samples"])
    samples = np.concatenate(pieces)
    samples = samples + 0.003 * rng.standard_normal(
        len(samples)).astype(np.float32)
    facts = {"n_speakers": n_speakers,
             "languages": sorted(used_langs), "tone": tone}
    return np.clip(samples, -1, 1).astype(np.float32), facts


def train_summary(*args, **kwargs):
    """The summarizer trainer: not ported yet."""
    raise _not_ported("the summarizer trainer (train/summary_train.py)")


def main(argv=None):
    train_summary()


if __name__ == "__main__":
    main()
