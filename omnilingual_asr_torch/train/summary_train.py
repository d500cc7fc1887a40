"""Free-text summarizer training on synthetic conversations, on one GPU.

The PyTorch port of ``omnilingual_asr_tpu/train/summary_train.py``. The
summary decoder (``models/summarizer.py::SummaryDecoder``: the 2-layer
translation decoder over pooled encoder states) learns to describe audio:
given the frozen ASR encoder's pooled window states of a multi-speaker
synthetic conversation, it states the speaker count, the language(s) and
the overall tone. With fact conditioning (the default) those facts are a
forced prefix (``models/summarizer.py::fact_prefix``) left out of the
loss, and the saved tree carries a ``fact_cond`` marker leaf.

    python -m omnilingual_asr_torch.train.summary_train \\
        --ckpt checkpoints/release/asr.npz --steps 4000 \\
        --out checkpoints/release/summarizer.npz

Conversations are composed from a reusable utterance pool
(:func:`build_utterance_pool`, :func:`make_conversation`: host synthesis
is the bottleneck), bit for bit as the reference composes them
(``eval/heads.py`` scores the release summarizer on them). Each is encoded
once by :class:`WindowEncoder` (16 slots of 8 s windows, one K1 launch a
conversation on the card) into a memory bank on the device, and the
decoder then trains on the bank. Everything runs on CUDA unless the caller
passes ``device="cpu"`` (``--device cpu``). ``--out X.npz`` writes that
file, any other ``--out`` writes ``X/summarizer.npz``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig, config_for_checkpoint, tiny_config
from ..models.translation import (GreedyDecoder, decoder_forward,
                                  save_translator, tokens_to_text,
                                  translator_init)
from ..models.zoo import checkpoint_path, load_checkpoint
from ..types import EMOTIONS
from .step import (RunLog, make_summarizer_optimizer, masked_ce,
                   train_update, trainable, tree_map)
from .translator_train import UtteranceEncoder, asr_checkpoint

POOL_SLOTS = 16          # conversations here are <= 16 windows long
MAX_SUMMARY_BYTES = 128


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


_TEMPLATES = (
    "A conversation between {n} speakers in {langs}. Overall tone: {tone}.",
    "{n} speakers talk in {langs}; the overall tone is {tone}.",
    "Dialogue with {n} speakers in {langs}. Overall tone: {tone}.",
)
_SINGLE = (
    "A single speaker talks in {langs}. Overall tone: {tone}.",
    "One speaker, speaking {langs}. Overall tone: {tone}.",
)


def summary_text(rng: np.random.Generator, facts: Dict) -> str:
    langs = " and ".join(facts["languages"])
    if facts["n_speakers"] == 1:
        t = _SINGLE[int(rng.integers(len(_SINGLE)))]
    else:
        t = _TEMPLATES[int(rng.integers(len(_TEMPLATES)))]
    return t.format(n=facts["n_speakers"], langs=langs, tone=facts["tone"])


# ---------------------------------------------------------------------------
# Frozen-encoder memory bank
# ---------------------------------------------------------------------------


class WindowEncoder(UtteranceEncoder):
    """The frozen encoder over a conversation: its first ``max_windows``
    windows of ``window_seconds`` in one batch (one K1 launch on a card),
    each the mean of its valid encoder states (the engine's pooling,
    ``SummaryDecoder.pool_states``); the slots past the conversation are
    zero."""

    def __init__(self, cfg: PipelineConfig, asr_params, device=None, *,
                 window_seconds: float = 8.0, max_windows: int = POOL_SLOTS):
        super().__init__(cfg, asr_params, device,
                         window_seconds=window_seconds)
        self.max_windows = max_windows

    def encode(self, samples: np.ndarray) -> Tuple[torch.Tensor, int]:
        """-> (memory [max_windows, D] f32 on the device, windows used)."""
        W, ws = self.max_windows, self.window_samples
        n_win = min(W, max(1, -(-len(samples) // ws)))
        segs = [samples[i * ws:(i + 1) * ws] for i in range(n_win)]
        segs += [samples[:0]] * (W - n_win)
        out = self.forward(*self.batch(segs))
        m = out["mask"].to(torch.float32)[:, :, None]
        mem = ((out["encoder_states"] * m).sum(dim=1)
               / torch.clamp(m.sum(dim=1), min=1.0))
        mem[n_win:] = 0.0
        return mem, n_win


# ---------------------------------------------------------------------------
# Decoder training
# ---------------------------------------------------------------------------


def encode_summary(text: str, vocab, max_len: int = MAX_SUMMARY_BYTES,
                   n_prefix: int = 0):
    """Teacher-forcing layout; the first ``n_prefix`` target positions (a
    forced fact prefix, models/summarizer.fact_prefix) are excluded from
    the loss: they are always forced at decode time, so training capacity
    belongs entirely to the continuation."""
    bs = text.encode("utf-8")[: max_len - 1]
    ids = [vocab.byte_to_id(b) for b in bs]
    inp = np.zeros(max_len, np.int32)          # BOS(0) + ids
    tgt = np.zeros(max_len, np.int32)          # ids + EOS(0)
    msk = np.zeros(max_len, bool)
    inp[1:1 + len(ids)] = ids
    tgt[:len(ids)] = ids
    msk[:len(ids) + 1] = True                  # include EOS position
    msk[:n_prefix] = False
    return inp, tgt, msk


def facts_score(hyp: str, facts: Dict) -> Dict[str, float]:
    """Checkable-fact accuracy of a generated summary."""
    h = hyp.lower()
    n = facts["n_speakers"]
    n_ok = (f"{n} speakers" in h) if n > 1 else (
        "single speaker" in h or "one speaker" in h)
    tone_ok = facts["tone"] in h
    lang_ok = all(lang.lower() in h for lang in facts["languages"])
    return {"speakers": float(n_ok), "tone": float(tone_ok),
            "languages": float(lang_ok),
            "all": float(n_ok and tone_ok and lang_ok)}


def build_bank(rng: np.random.Generator, enc: WindowEncoder, n: int,
               pool, facts_conditioning: bool, run: RunLog):
    """``n`` conversations composed from ``pool``, each encoded once, with
    their summaries (the fact prefix first with ``facts_conditioning``).
    Returns the bank (device tensors: memory [n, 16, D], windows used,
    decoder input, target, target mask) and each conversation's facts."""
    from ..models.summarizer import fact_prefix

    vocab = enc.cfg.vocab
    mems, nvs, rows, facts_all = [], [], [], []
    t0 = time.perf_counter()
    for i in range(n):
        with run.timed("synth"):
            samples, facts = make_conversation(rng, pool)
        with run.timed("encode"):
            mem, n_win = enc.encode(samples)
        text = summary_text(rng, facts)
        n_prefix = 0
        if facts_conditioning:
            pfx = fact_prefix(n_speakers=facts["n_speakers"],
                              tone=facts["tone"],
                              language_names=facts["languages"])
            n_prefix = len(pfx.encode("utf-8"))
            text = pfx + text
        rows.append(encode_summary(text, vocab, n_prefix=n_prefix))
        mems.append(mem)
        nvs.append(n_win)
        facts_all.append(facts)
        if (i + 1) % 200 == 0:
            print(f"  {i + 1}/{n} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)
    dev = enc.device
    bank = (torch.stack(mems), torch.tensor(nvs, dtype=torch.int32,
                                            device=dev),
            *(torch.from_numpy(np.stack(c)).to(dev) for c in zip(*rows)))
    return bank, facts_all


def loss_fn(params, mem, nv, inp, tgt, msk,
            cfg: PipelineConfig) -> torch.Tensor:
    """Teacher-forced cross-entropy over pooled memories ``mem`` [B, 16,
    D] with ``nv`` valid slots each."""
    enc_mask = (torch.arange(POOL_SLOTS, device=mem.device)[None, :]
                < nv[:, None])
    logits = decoder_forward(params, inp, mem, enc_mask, cfg,
                             n_heads=cfg.encoder.n_heads)
    return masked_ce(logits, tgt, msk)


def batch_indices(rng: np.random.Generator, order: np.ndarray, s: int,
                  batch_size: int) -> np.ndarray:
    """Step ``s``'s rows: ``order`` reshuffled (in place) at the start of
    each pass, then its next ``batch_size`` entries, wrapping."""
    n_train = len(order)
    if s % max(1, n_train // batch_size) == 0:
        rng.shuffle(order)
    a = (s * batch_size) % n_train
    idx = order[a:a + batch_size]
    if len(idx) < batch_size:
        idx = np.concatenate([idx, order[:batch_size - len(idx)]])
    return idx


@torch.no_grad()
def eval_summaries(params, bank, facts_all, ev: range, cfg: PipelineConfig,
                   facts_conditioning: bool):
    """Greedy decodes of the conversations ``ev`` (one at a time, the fact
    prefix forced as the engine forces it) scored by :func:`facts_score`
    on the generated continuation. Returns (mean scores, hypotheses)."""
    from ..models.summarizer import fact_prefix_ids

    mems, nvs = bank[0], bank[1]
    dev = mems.device
    decoder = GreedyDecoder(tree_map(lambda t: t.detach(), params), cfg,
                            n_heads=cfg.encoder.n_heads)
    scores, hyps = [], []
    for i in ev:
        enc_mask = torch.arange(POOL_SLOTS, device=dev)[None, :] < nvs[i]
        forced = None
        n_prefix = 0
        if facts_conditioning:
            f = facts_all[i]
            pfx_ids = fact_prefix_ids(cfg.vocab, n_speakers=f["n_speakers"],
                                      tone=f["tone"],
                                      language_names=f["languages"])
            n_prefix = len(pfx_ids)
            fa = np.full((1, MAX_SUMMARY_BYTES), -1, np.int32)
            fa[0, :n_prefix] = pfx_ids
            forced = torch.from_numpy(fa)
        toks = decoder.decode(mems[i][None], enc_mask,
                              max_len=MAX_SUMMARY_BYTES,
                              forced=forced).cpu().numpy()
        hyp = tokens_to_text(toks[0, n_prefix:], cfg.vocab).strip()
        hyps.append(hyp)
        scores.append(facts_score(hyp, facts_all[i]))
    agg = {k: round(float(np.mean([s[k] for s in scores])), 4)
           for k in scores[0]}
    return agg, hyps


def train_summarizer(*, asr_ckpt: str, out_dir: str, steps: int = 4000,
                     batch_size: int = 32, lr: float = 5e-4,
                     pool_size: int = 768, n_train: int = 1200,
                     n_eval: int = 96, seed: int = 0,
                     cfg: Optional[PipelineConfig] = None,
                     log_every: int = 200, facts_conditioning: bool = True,
                     device=None, init_params=None):
    """The reference's ``train_summarizer`` on ``device`` (CUDA unless
    "cpu"): ``asr_ckpt`` an ASR ``.npz``; the decoder saved to
    :func:`checkpoint_path` ``(out_dir, "summarizer.npz")``.

    ``init_params`` (tests and ``chip_smoke.py``): a decoder tree to start
    from instead of ``translator_init(seed, n_layers=2)``. Returns (the
    saved tree, :class:`RunLog`)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = cfg or PipelineConfig()
    enc = WindowEncoder(cfg, load_checkpoint(asr_ckpt, cfg), dev)
    run = RunLog()

    rng = np.random.default_rng(seed)
    print(f"synthesizing utterance pool ({pool_size})...", flush=True)
    with run.timed("synth"):
        pool = build_utterance_pool(rng, pool_size)
    print("encoding conversations...", flush=True)
    bank, facts_all = build_bank(rng, enc, n_train + n_eval, pool,
                                 facts_conditioning, run)

    if init_params is None:
        init_params = translator_init(torch.Generator().manual_seed(seed),
                                      cfg, n_layers=2)
    params = trainable(init_params, dev)
    tx = make_summarizer_optimizer(lr, steps)
    opt_state = tx.init(params)

    order = np.arange(n_train)
    for s in range(steps):
        idx = torch.from_numpy(batch_indices(rng, order, s,
                                             batch_size)).to(dev)
        with run.timed("steps"):
            run.losses.append(train_update(tx, opt_state, loss_fn, params,
                                           *(b[idx] for b in bank), cfg))
        if (s + 1) % log_every == 0:
            run.emit({"step": s + 1, "ce": round(run.losses[-1], 4)})

    with run.timed("eval"):
        agg, hyps = eval_summaries(params, bank, facts_all,
                                   range(n_train, n_train + n_eval), cfg,
                                   facts_conditioning)
    run.evals.append({"eval_fact_accuracy": agg, "n_eval": n_eval})
    run.emit(run.evals[-1])
    for h in hyps[:5]:
        print("  e.g.", h, flush=True)

    dec = tree_map(lambda t: t.detach(), params)
    if facts_conditioning:
        # Marker leaf: tells SummaryDecoder/load_translator this checkpoint
        # expects the forced fact prefix (models/summarizer.fact_conditioned).
        dec["fact_cond"] = torch.ones((), device=dev)
    path = checkpoint_path(out_dir, "summarizer.npz")
    save_translator(path, dec)
    print(f"saved summarizer -> {path}", flush=True)
    return dec, run


def main(argv=None):
    from ..utils.term import install_sigterm_exit

    install_sigterm_exit()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="trained ASR checkpoint: an .npz or an Orbax "
                         "directory, or a run directory holding asr.npz or "
                         "asr/ (and config.json)")
    ap.add_argument("--out", required=True,
                    help="an .npz file, or a directory for summarizer.npz")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--pool-size", type=int, default=768)
    ap.add_argument("--n-train", type=int, default=1200)
    ap.add_argument("--n-eval", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-facts", action="store_true",
                    help="train WITHOUT fact-prefix conditioning")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda[:N]' (default: CUDA)")
    args = ap.parse_args(argv)
    ckpt = asr_checkpoint(args.ckpt)
    # The checkpoint's own dims (its config.json), as the reference adopts.
    cfg = tiny_config() if args.tiny else config_for_checkpoint(str(ckpt))
    train_summarizer(asr_ckpt=str(ckpt), out_dir=args.out, steps=args.steps,
                     batch_size=args.batch_size, lr=args.lr,
                     pool_size=args.pool_size, n_train=args.n_train,
                     n_eval=args.n_eval, seed=args.seed, cfg=cfg,
                     facts_conditioning=not args.no_facts, device=args.device)


if __name__ == "__main__":
    main()
