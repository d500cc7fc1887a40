"""Decoder-only X->English translator fine-tune over cached encoder states,
on one GPU.

The PyTorch port of ``omnilingual_asr_tpu/train/translator_train.py``. The
ASR encoder is frozen here, so every utterance is encoded once: its
[T', D] encoder states go into a memory bank on the device (rounded to
bf16, as the reference stores them), and the 4-layer cross-attention
decoder (``models/translation.py``) then trains at decoder-only speed, each
step indexing the bank. The synthetic corpus makes X->English exactly
learnable: every non-English language is a bijective word cipher of the
English lexicon.

    python -m omnilingual_asr_torch.train.translator_train \\
        --ckpt checkpoints/release/asr.npz --steps 6000 \\
        --out checkpoints/release/translator.npz

The frozen encoder is :class:`UtteranceEncoder`: 8 s windows, the log-mel
(kernel K1 on the card, one launch a batch of ENCODE_BATCH utterances) and
``asr_forward`` with the checkpoint's own config (the release's has flash
attention and the fused conv module off, so K2 and K3 are not on this
path). Everything runs on CUDA unless the caller passes ``device="cpu"``
(``--device cpu``). The draws follow the reference's generator draw for
draw: the utterances first (training and held-out), then the batches'
indices. ``--ckpt`` takes an ``.npz`` ASR checkpoint or a directory
holding ``asr.npz``; the checkpoint is one ``.npz``
(``models/translation.py::save_translator``): ``--out X.npz`` writes that
file, any other ``--out`` writes ``X/translator.npz``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig, config_for_checkpoint
from ..models.conformer import asr_forward
from ..models.translation import (GreedyDecoder, decoder_forward,
                                  load_translator, save_translator,
                                  tokens_to_text, translator_init)
from ..models.zoo import checkpoint_path, load_checkpoint, tree_to
from ..ops.mel import MelFrontend
from .step import (RunLog, make_translator_optimizer, masked_ce,
                   train_update, trainable, training_device, tree_map)

MAX_TRANS_BYTES = 128
WINDOW_SECONDS = 8.0
#: Utterances the frozen encoder takes a batch.
ENCODE_BATCH = 64


class UtteranceEncoder:
    """The frozen encoder: padded samples -> encoder states.

    :meth:`encode_batch` returns [B, T', D] states rounded to bf16 (the
    reference's memory-bank dtype at either encoder dtype) and the [B, T']
    validity mask (the decoder's cross-attention mask), both on the
    device: the card when ``device`` is None (raising without one, TF32
    off), ``"cpu"`` for the CPU."""

    def __init__(self, cfg: PipelineConfig, asr_params, device=None, *,
                 window_seconds: float = WINDOW_SECONDS):
        self.cfg = cfg
        self.device = training_device(device)
        fe = cfg.frontend
        self.window_samples = int(window_seconds * fe.sample_rate)
        n_frames = fe.frames_for_samples(self.window_samples)
        sub = cfg.encoder.subsample_factor
        self.window_frames = ((n_frames + sub - 1) // sub) * sub
        self.frontend = MelFrontend(fe, self.device)
        self.params = tree_to(asr_params, self.device)

    @torch.no_grad()
    def forward(self, samples: torch.Tensor, n_valid: torch.Tensor):
        """[B, window_samples] f32, [B] valid mel frames -> the full
        ``asr_forward`` output dict."""
        wf = self.window_frames
        frames, _ = self.frontend.frames_from_signal(samples)
        mel = self.frontend.log_mel(frames)[:, :wf]
        mask = (torch.arange(wf, device=mel.device)[None, :]
                < n_valid[:, None])
        return asr_forward(self.params, mel, mask, self.cfg)

    def batch(self, utts: List[np.ndarray]):
        """Utterances -> (samples [B, window_samples], valid frames [B])
        on the device, cut to the window."""
        fe = self.cfg.frontend
        ws = self.window_samples
        x = np.zeros((len(utts), ws), np.float32)
        nv = np.zeros(len(utts), np.int32)
        for i, s in enumerate(utts):
            s = s[:ws]
            x[i, :len(s)] = s
            nv[i] = fe.frames_for_samples(len(s))
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(nv).to(self.device))

    def encode_batch(self, utts: List[np.ndarray]):
        out = self.forward(*self.batch(utts))
        return out["encoder_states"].to(torch.bfloat16), out["mask"]


def encode_target(text: str, vocab, max_len: int = MAX_TRANS_BYTES):
    """BOS(0) + bytes -> bytes + EOS(0), the mask including the EOS
    position (the teacher-forcing layout of ``SynthBatcher``)."""
    bs = text.encode("utf-8")[: max_len - 1]
    ids = [vocab.byte_to_id(b) for b in bs]
    inp = np.zeros(max_len, np.int32)
    tgt = np.zeros(max_len, np.int32)
    msk = np.zeros(max_len, bool)
    inp[1:1 + len(ids)] = ids
    tgt[:len(ids)] = ids
    msk[:len(ids) + 1] = True
    return inp, tgt, msk


def word_accuracy(hyp: str, ref: str) -> Tuple[int, int]:
    h, r = hyp.split(), ref.split()
    ok = sum(1 for a, b in zip(h, r) if a == b)
    return ok, max(len(r), 1)


def make_uniform(rng: np.random.Generator, non_english):
    """Uniform-index draw: zipf-ish indices make the target stream mostly
    function words, which a decoder can emit without reading the source;
    uniform indices force the source-to-target lexicon reading."""
    from .synth import (ENGLISH_WORDS, LEXICON_SIZE, N_SPEAKERS, lexicon,
                        synth_utterance)

    lang = non_english[int(rng.integers(len(non_english)))]
    lex = lexicon(lang)
    n_words = int(rng.integers(2, 11))
    idx = rng.integers(0, LEXICON_SIZE, n_words)
    text = " ".join(lex[i] for i in idx)
    translation = " ".join(ENGLISH_WORDS[i] for i in idx)
    samples = synth_utterance(
        text, int(rng.integers(N_SPEAKERS)), "neutral",
        seed=int(rng.integers(2 ** 31)),
        snr_db=float(rng.uniform(8.0, 40.0)),
        rate=float(rng.uniform(0.9, 1.15)))
    return SimpleNamespace(samples=samples, translation=translation)


def make_mixed(rng: np.random.Generator, non_english):
    """Two-language non-English utterance with a joined English gloss."""
    from .synth import SAMPLE_RATE, make_example

    ia, ib = rng.choice(len(non_english), size=2, replace=False)
    a = make_example(rng, min_words=1, max_words=5,
                     languages=[non_english[ia]])
    b = make_example(rng, min_words=1, max_words=5,
                     languages=[non_english[ib]])
    gap = np.zeros(int(0.12 * SAMPLE_RATE), np.float32)
    a.samples = np.concatenate([a.samples, gap, b.samples])
    a.translation = f"{a.translation} {b.translation}"
    return a


def build_bank(rng: np.random.Generator, enc: UtteranceEncoder,
               n_total: int, run: RunLog):
    """Synthesizes ``n_total`` utterances with English targets (1/6
    two-language, 1/2 uniform-index, the rest zipf-ish natural draws;
    English draws carry no target and are skipped) and encodes them in
    batches of ENCODE_BATCH. Returns the bank (device tensors: encoder
    states bf16, mask, decoder input, target, target mask) and the
    reference translations."""
    from .synth import LANGUAGES, make_example

    non_english = [lg for lg in LANGUAGES if not lg.is_english]
    vocab = enc.cfg.vocab
    encs, masks, inps, tgts, msks, refs = [], [], [], [], [], []
    buf: List = []

    def flush_buf():
        if not buf:
            return
        with run.timed("encode"):
            e, m = enc.encode_batch([ex.samples for ex in buf])
        encs.append(e)
        masks.append(m)
        buf.clear()

    made = 0
    t0 = time.perf_counter()
    while made < n_total:
        with run.timed("synth"):
            r = rng.random()
            if r < 1 / 6:
                ex = make_mixed(rng, non_english)
            elif r < 1 / 6 + 1 / 2:
                ex = make_uniform(rng, non_english)
            else:
                ex = make_example(rng, min_words=2, max_words=10)
        if not ex.translation:      # English utterances carry no target
            continue
        inp, tgt, msk = encode_target(ex.translation, vocab)
        inps.append(inp)
        tgts.append(tgt)
        msks.append(msk)
        refs.append(ex.translation)
        buf.append(ex)
        made += 1
        if len(buf) == ENCODE_BATCH:
            flush_buf()
            if made % 1024 == 0:
                print(f"  {made}/{n_total} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
    flush_buf()
    dev = enc.device
    bank = (torch.cat(encs), torch.cat(masks),
            *(torch.from_numpy(np.stack(c)).to(dev)
              for c in (inps, tgts, msks)))
    return bank, refs


def loss_fn(params, bank, idx: torch.Tensor,
            cfg: PipelineConfig) -> torch.Tensor:
    """Teacher-forced cross-entropy of the bank rows ``idx``."""
    b_enc, b_mask, b_inp, b_tgt, b_msk = bank
    logits = decoder_forward(params, b_inp[idx], b_enc[idx].float(),
                             b_mask[idx], cfg)
    return masked_ce(logits, b_tgt[idx], b_msk[idx])


@torch.no_grad()
def eval_word_accuracy(params, bank, refs, ev: slice,
                       cfg: PipelineConfig) -> float:
    """Greedy-decode word accuracy of the held-out bank rows ``ev`` (one
    decode of all of them)."""
    b_enc, b_mask = bank[0], bank[1]
    decoder = GreedyDecoder(tree_map(lambda t: t.detach(), params), cfg)
    toks = decoder.decode(b_enc[ev].float(), b_mask[ev],
                          max_len=MAX_TRANS_BYTES).cpu().numpy()
    ok = words = 0
    for j, ref in enumerate(refs[ev]):
        a, b = word_accuracy(tokens_to_text(toks[j], cfg.vocab), ref)
        ok += a
        words += b
    return ok / max(words, 1)


def train_translator(*, asr_ckpt: str, out_dir: str,
                     init_from: Optional[str] = None, steps: int = 6000,
                     batch_size: int = 64, lr: float = 1e-3,
                     n_train: int = 6144, n_eval: int = 128, seed: int = 0,
                     cfg: Optional[PipelineConfig] = None,
                     log_every: int = 200, metrics_log: Optional[str] = None,
                     device=None, init_params=None):
    """The reference's ``train_translator`` on ``device`` (CUDA unless
    "cpu"): ``asr_ckpt`` an ASR ``.npz``; ``init_from`` a translator
    ``.npz`` (or a directory holding ``translator.npz``) to warm-start from
    where it exists; the result saved to :func:`checkpoint_path`
    ``(out_dir, "translator.npz")``.

    ``init_params`` (tests and ``chip_smoke.py``): a parameter tree to
    start from instead of ``translator_init(seed)`` (``init_from`` wins).
    Returns (parameters, :class:`RunLog`)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = cfg or config_for_checkpoint(asr_ckpt)
    enc = UtteranceEncoder(cfg, load_checkpoint(asr_ckpt, cfg), dev)
    run = RunLog(Path(metrics_log) if metrics_log else None)

    rng = np.random.default_rng(seed)
    n_total = n_train + n_eval
    print(f"synthesizing + encoding {n_total} utterances...", flush=True)
    bank, refs = build_bank(rng, enc, n_total, run)
    print(f"memory bank: {tuple(bank[0].shape)} bf16 "
          f"({bank[0].numel() * 2 / 1e6:.0f} MB)", flush=True)

    warm = checkpoint_path(init_from, "translator.npz") if init_from else None
    if warm is not None and warm.is_file():
        init_params = load_translator(warm, cfg, n_layers=4)
        print(f"warm-started decoder from {warm}", flush=True)
    elif init_params is None:
        init_params = translator_init(torch.Generator().manual_seed(seed),
                                      cfg, n_layers=4)
    params = trainable(init_params, dev)
    tx = make_translator_optimizer(lr, steps)
    opt_state = tx.init(params)

    t0 = time.perf_counter()
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, n_train, batch_size)).to(dev)
        with run.timed("steps"):
            run.losses.append(train_update(tx, opt_state, loss_fn, params,
                                           bank, idx, cfg))
        if (i + 1) % log_every == 0 or i + 1 == steps:
            run.emit({"step": i + 1, "ce": round(run.losses[-1], 4),
                      "steps_per_s": round((i + 1) /
                                           (time.perf_counter() - t0), 2)})

    # Held-out greedy-decode word accuracy (the metric eval.heads
    # publishes as translation_word_acc).
    with run.timed("eval"):
        acc = eval_word_accuracy(params, bank, refs,
                                 slice(n_train, n_total), cfg)
    report = {"translation_word_acc": round(acc, 4), "n_eval": n_eval}
    run.evals.append(report)
    run.emit({"eval": report})

    path = checkpoint_path(out_dir, "translator.npz")
    save_translator(path, params)
    print(f"saved translator -> {path}", flush=True)
    return params, run


def asr_npz(ckpt) -> Path:
    """``--ckpt``: an ``.npz`` as given; a directory's ``asr.npz``."""
    ckpt = Path(ckpt)
    return ckpt / "asr.npz" if ckpt.is_dir() else ckpt


def main(argv=None) -> None:
    from ..utils.term import install_sigterm_exit

    install_sigterm_exit()
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="trained ASR checkpoint: an .npz, or a directory "
                         "holding asr.npz (and config.json)")
    ap.add_argument("--out", required=True,
                    help="an .npz file, or a directory for translator.npz")
    ap.add_argument("--init-from", default=None,
                    help="existing translator checkpoint to warm-start "
                         "(an .npz, or a directory holding translator.npz)")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-train", type=int, default=6144)
    ap.add_argument("--n-eval", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--metrics-log", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda[:N]' (default: CUDA)")
    args = ap.parse_args(argv)
    train_translator(asr_ckpt=str(asr_npz(args.ckpt)), out_dir=args.out,
                     init_from=args.init_from, steps=args.steps,
                     batch_size=args.batch_size, lr=args.lr,
                     n_train=args.n_train, n_eval=args.n_eval,
                     seed=args.seed, log_every=args.log_every,
                     metrics_log=args.metrics_log, device=args.device)


if __name__ == "__main__":
    main()
