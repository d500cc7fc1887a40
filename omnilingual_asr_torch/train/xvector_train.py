"""Train the local-receptive-field speaker embedder (``models/xvector.py``)
with AAM-softmax over the synthetic speaker space, on one GPU.

The PyTorch port of ``omnilingual_asr_tpu/train/xvector_train.py``. The
synthetic speaker space (``train/synth.py``) is hash-parameterized over all
ints, so speakers >= N_SPEAKER_CLASSES are truly held out: the eval measures
intra- and inter-speaker cosine distances and the pairwise order-violation
rate (an EER proxy) on 12 speakers the AAM head has never seen, and the
checkpoint is saved whenever that rate is at or below its best so far.

    python -m omnilingual_asr_torch.train.xvector_train \\
        --steps 4000 --batch-size 64 --ckpt-dir checkpoints/xvector

Each step synthesizes its batch on the host (from a reuse pool: synthesis
is the host's bottleneck), sends 4 s windows as int16 samples, runs the
log-mel (kernel K1 on the card) without a gradient, and takes the gradient
of the AAM loss from the mel on. Everything runs on CUDA unless the caller
passes ``device="cpu"`` (``--device cpu``). The parts are functions that the
tests and ``chip_smoke.py`` call: :func:`eval_set`, :class:`BatchPool`,
:func:`loss_fn`, :func:`run_eval` and :func:`train_xvector`.
"""

from __future__ import annotations

import argparse
import itertools
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..models.conformer import N_SPEAKER_CLASSES
from ..models.xvector import save_xvector, xvector_init, xvector_pooled
from ..ops.mel import BLOCK_T, MelFrontend
from .step import (RunLog, aam_softmax_loss, make_optimizer, train_update,
                   trainable, tree_leaves)

#: The held-out eval: EVAL_SPEAKERS unseen speakers (ids N_SPEAKER_CLASSES
#: + 17 i) x EVAL_PER_SPEAKER utterances, drawn from EVAL_SEED.
EVAL_SEED = 999_331
EVAL_SPEAKERS = 12
EVAL_PER_SPEAKER = 4
EVAL_CHANNEL_P = 0.25


def _draw(rng: np.random.Generator, sid: int,
          channel_p: float) -> np.ndarray:
    from .synth import (EMOTIONS, LANGUAGES, LEXICON_SIZE, _channel_sim,
                        lexicon, synth_utterance)

    lang = LANGUAGES[int(rng.integers(len(LANGUAGES)))]
    lex = lexicon(lang)
    n_words = int(rng.integers(2, 7))
    idx = np.minimum((rng.pareto(1.2, n_words) * 12).astype(int),
                     LEXICON_SIZE - 1)
    text = " ".join(lex[i] for i in idx)
    emotion = EMOTIONS[int(rng.integers(len(EMOTIONS)))]
    x = synth_utterance(text, sid, emotion,
                        seed=int(rng.integers(2 ** 31)),
                        snr_db=float(rng.uniform(8.0, 40.0)),
                        rate=float(rng.uniform(0.9, 1.15)),
                        english=lang.is_english)
    if rng.random() < channel_p:
        # Channel/room robustness: diarization must not cluster by
        # acoustic channel instead of voice.
        x = _channel_sim(x, rng)
    return x


def _to_window(x: np.ndarray, win: int,
               rng: np.random.Generator) -> Tuple[np.ndarray, int]:
    if len(x) > win:
        a = int(rng.integers(0, len(x) - win + 1))
        x = x[a:a + win]
    row = np.zeros(win, np.float32)
    row[:len(x)] = x
    return row, len(x)


def window_frames(cfg: PipelineConfig, win: int) -> int:
    """Mel frames of a ``win``-sample window as the reference pads them:
    to the log-mel's 256-frame blocks, then to the subsample factor (512
    at 4 s)."""
    n = cfg.frontend.frames_for_samples(win)
    wf = ((n + BLOCK_T - 1) // BLOCK_T) * BLOCK_T
    sub = cfg.encoder.subsample_factor
    return ((wf + sub - 1) // sub) * sub


def to_wire(rows: np.ndarray) -> np.ndarray:
    """f32 samples -> the int16 wire, ``clip(x * 32768)``."""
    return np.clip(rows * 32768.0, -32768, 32767).astype(np.int16)


def eval_set(cfg: PipelineConfig, win: int, wf: int):
    """The held-out set: (rows, valid mel frames, speaker index) lists."""
    fe = cfg.frontend
    ev_rng = np.random.default_rng(EVAL_SEED)
    ev_sids = [N_SPEAKER_CLASSES + 17 * i for i in range(EVAL_SPEAKERS)]
    rows, nv, who = [], [], []
    for si, sid in enumerate(ev_sids):
        for _ in range(EVAL_PER_SPEAKER):
            x = _draw(ev_rng, sid, channel_p=EVAL_CHANNEL_P)
            row, n = _to_window(x, win, ev_rng)
            rows.append(row)
            nv.append(min(fe.frames_for_samples(n), wf))
            who.append(si)
    return rows, nv, np.asarray(who)


class BatchPool:
    """The reference's batch stream: each row reuses a pooled utterance
    with probability ``reuse_p`` (always once the pool is full), else
    synthesizes a fresh one for a random training speaker and pools it;
    then a random 4 s crop. Draws from ``default_rng(seed + 1)``."""

    def __init__(self, cfg: PipelineConfig, *, batch_size: int, win: int,
                 wf: int, seed: int = 0, channel_p: float = 0.5,
                 pool_size: int = 4096, reuse_p: float = 0.85):
        self.cfg, self.batch_size, self.win, self.wf = cfg, batch_size, win, wf
        self.channel_p, self.pool_size, self.reuse_p = (channel_p, pool_size,
                                                        reuse_p)
        self.rng = np.random.default_rng(seed + 1)
        self.pool: List[Tuple[np.ndarray, int]] = []

    def _fresh(self) -> Tuple[np.ndarray, int]:
        sid = int(self.rng.integers(N_SPEAKER_CLASSES))
        return _draw(self.rng, sid, self.channel_p), sid

    def next_batch(self):
        """-> (int16 wire [B, win], valid mel frames [B], labels [B])."""
        rng, pool = self.rng, self.pool
        B = self.batch_size
        rows = np.zeros((B, self.win), np.float32)
        nv = np.zeros(B, np.int32)
        labels = np.zeros(B, np.int32)
        for i in range(B):
            if pool and (rng.random() < self.reuse_p
                         or len(pool) >= self.pool_size):
                x, sid = pool[int(rng.integers(len(pool)))]
            else:
                x, sid = self._fresh()
                pool.append((x, sid))
                if len(pool) > self.pool_size:
                    pool.pop(int(rng.integers(len(pool))))
            row, n = _to_window(x, self.win, rng)
            rows[i] = row
            nv[i] = min(self.cfg.frontend.frames_for_samples(n), self.wf)
            labels[i] = sid
        return to_wire(rows), nv, labels


def embed(params, frontend: MelFrontend, wire: torch.Tensor,
          n_valid: torch.Tensor, wf: int) -> torch.Tensor:
    """int16 wire [B, win] -> L2-normalised embeddings [B, 256]. The
    log-mel (one K1 launch on a card) takes no gradient."""
    with torch.no_grad():
        samples = wire.to(torch.float32) * (1.0 / 32768.0)
        frames, _ = frontend.frames_from_signal(samples)
        mel = frontend.log_mel(frames)[:, :wf]
    mask = torch.arange(wf, device=mel.device)[None, :] < n_valid[:, None]
    return xvector_pooled(params, mel, mask)


def loss_fn(params, frontend: MelFrontend, wire: torch.Tensor,
            n_valid: torch.Tensor, labels: torch.Tensor,
            wf: int) -> torch.Tensor:
    """The reference's AAM-softmax loss of one batch."""
    return aam_softmax_loss(embed(params, frontend, wire, n_valid, wf),
                            labels, params["aam"])


def batch_tensors(batch, device):
    """A :meth:`BatchPool.next_batch` batch as tensors on ``device``."""
    wire, nv, labels = batch
    return (torch.from_numpy(wire).to(device),
            torch.from_numpy(nv).to(device),
            torch.from_numpy(labels).to(device))


@torch.no_grad()
def run_eval(params, frontend: MelFrontend, ev, batch_size: int,
             wf: int) -> dict:
    """``intra_mean``, ``inter_mean`` (cosine distances) and ``viol`` (the
    share of intra/inter pairs in the wrong order) over the held-out set,
    in batches of ``batch_size`` padded with silent rows."""
    rows, nvs, who = ev
    win = len(rows[0])
    dev = frontend.device
    E = []
    for b0 in range(0, len(rows), batch_size):
        chunk = list(rows[b0:b0 + batch_size])
        nv = list(nvs[b0:b0 + batch_size])
        live = len(chunk)
        while len(chunk) < batch_size:
            chunk.append(np.zeros(win, np.float32))
            nv.append(1)
        e = embed(params, frontend,
                  torch.from_numpy(to_wire(np.stack(chunk))).to(dev),
                  torch.tensor(nv, dtype=torch.int32, device=dev), wf)
        E.append(e.cpu().numpy()[:live])
    E = np.concatenate(E)
    d = 1.0 - E @ E.T
    intra, inter = [], []
    for i, j in itertools.combinations(range(len(E)), 2):
        (intra if who[i] == who[j] else inter).append(d[i, j])
    intra = np.asarray(intra)
    inter = np.asarray(inter)
    viol = float((intra[:, None] >= inter[None, :]).mean())
    return {"intra_mean": round(float(intra.mean()), 4),
            "inter_mean": round(float(inter.mean()), 4),
            "viol": round(viol, 4)}


def train_xvector(*, steps: int, batch_size: int, lr: float = 1e-3,
                  window_seconds: float = 4.0, seed: int = 0,
                  warmup_steps: int = 300, channel_p: float = 0.5,
                  pool_size: int = 4096, reuse_p: float = 0.85,
                  ckpt_dir: Optional[str] = None, log_every: int = 50,
                  eval_every: int = 500,
                  metrics_log: Optional[str] = None, device=None,
                  init_params=None):
    """The reference's ``train_xvector`` on ``device`` (CUDA unless "cpu").

    ``init_params`` (tests and ``chip_smoke.py``): a parameter tree to start
    from instead of ``xvector_init(seed)``. Returns (params, :class:`RunLog`).
    """
    from ..device import resolve_device

    dev = resolve_device(device)
    cfg = PipelineConfig()
    fe = cfg.frontend
    frontend = MelFrontend(fe, dev)
    win = int(window_seconds * fe.sample_rate)
    wf = window_frames(cfg, win)

    if init_params is None:
        init_params = xvector_init(torch.Generator().manual_seed(seed), cfg)
    params = trainable(init_params, dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"xvector params: {n_params / 1e6:.2f} M", flush=True)
    tx = make_optimizer(lr=lr, warmup_steps=warmup_steps,
                        decay_steps=max(steps, 1000))
    opt_state = tx.init(params)
    run = RunLog(Path(metrics_log) if metrics_log else None)

    with run.timed("synth"):
        ev = eval_set(cfg, win, wf)
    batches = BatchPool(cfg, batch_size=batch_size, win=win, wf=wf,
                        seed=seed, channel_p=channel_p, pool_size=pool_size,
                        reuse_p=reuse_p)

    out = Path(ckpt_dir) if ckpt_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    best_viol = 1.0
    t0 = time.time()
    for step in range(1, steps + 1):
        with run.timed("synth"):
            batch = batches.next_batch()
        with run.timed("steps"):
            run.losses.append(train_update(tx, opt_state, loss_fn, params,
                                           frontend,
                                           *batch_tensors(batch, dev), wf))
        if step % log_every == 0:
            run.emit({"step": step, "aam": round(run.losses[-1], 4),
                      "steps_per_s": round(step / (time.time() - t0), 2)})
        if step % eval_every == 0 or step == steps:
            with run.timed("eval"):
                e = run_eval(params, frontend, ev, batch_size, wf)
            e["step"] = step
            run.evals.append(e)
            run.emit({"eval": e})
            if out and e["viol"] <= best_viol:
                best_viol = e["viol"]
                save_xvector(out / "xvector.npz", params)
                print(f"saved {out}/xvector.npz (viol {best_viol})",
                      flush=True)
    return params, run


def main(argv=None):
    from ..utils.term import install_sigterm_exit

    install_sigterm_exit()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--window-seconds", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup-steps", type=int, default=300)
    ap.add_argument("--channel-p", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default="checkpoints/xvector")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--metrics-log", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda[:N]' (default: CUDA)")
    args = ap.parse_args(argv)
    train_xvector(steps=args.steps, batch_size=args.batch_size,
                  lr=args.lr, window_seconds=args.window_seconds,
                  seed=args.seed, warmup_steps=args.warmup_steps,
                  channel_p=args.channel_p, ckpt_dir=args.ckpt_dir,
                  eval_every=args.eval_every, metrics_log=args.metrics_log,
                  device=args.device)


if __name__ == "__main__":
    main()
