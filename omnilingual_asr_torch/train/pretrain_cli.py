"""BEST-RQ pretraining CLI: masked prediction over synth + real audio.

The PyTorch port of ``omnilingual_asr_tpu/train/pretrain_cli.py``. BEST-RQ
needs no labels, so every unique real recording the reference ships
(``synth.unique_real_audio``) is pretraining fuel beside the synthetic
stream: the encoder learns real channel/voice acoustics before supervised
transfer. Without those recordings it pretrains on synth only.

    python -m omnilingual_asr_torch.train.pretrain_cli --steps 6000 \\
        --batch-size 64 --real-fraction 0.5 --ckpt-dir checkpoints/bestrq

``<ckpt-dir>/last/asr.npz`` (the encoder in the release's keystr layout)
warm-starts supervised training through ``synth_train --init-encoder``;
``head.npz``, ``config.json`` and ``train_state.npz`` sit beside it.
``--resume-from`` also takes the JAX trainer's directory (an Orbax
``asr/`` beside the same three files). Everything runs on CUDA unless the
caller passes ``device="cpu"`` (``--device cpu``). Crops never touch
gettysburg's held-out tail (the engine-level CER eval window). The mesh is
pinned as the reference pins it, data-parallel over every visible card
(``cfg.mesh`` (-1, 1); one card, or an explicit ``--device``, is one
device); ``pretrain_main`` trains over whatever ``cfg.mesh`` it is given
(``train/mesh_step.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from ..config import MeshConfig, PipelineConfig, tiny_config
from .device_pool import encode_wire
from .pretrain import PretrainConfig, make_pretrain_step
from .synth import SAMPLE_RATE, SynthBatcher, _channel_sim, unique_real_audio
from .synth_train import (_NoBatches, _assign_part, _quiet,
                          load_train_state, save_train_state)


class RealCropSampler:
    """Random augmented crops from every unique real recording on the box.

    Augmentation per draw: speed 0.9-1.1 (interp resample), gain -12..+3 dB,
    channel simulation (synth._channel_sim) with prob 0.5, white noise at
    SNR 5-30 dB. gettysburg's final ``hold_out_frac`` is excluded — that is
    the engine-level held-out CER window and must stay unseen, even
    unsupervised.
    """

    def __init__(self, window_samples: int, seed: int = 0,
                 hold_out_frac: float = 0.25):
        from ..audio.decode import decode_audio
        from ..audio.resample import resample

        self.window = window_samples
        self.rng = np.random.default_rng(seed + 7919)
        self.recs: List[np.ndarray] = []
        for p in unique_real_audio():
            try:
                x, sr = decode_audio(p)
            except Exception:
                continue
            if sr != SAMPLE_RATE:
                x = resample(x, sr, SAMPLE_RATE)
            if p.name == "gettysburg.wav":
                x = x[: int(len(x) * (1.0 - hold_out_frac))]
            rms = float(np.sqrt((x ** 2).mean()) + 1e-9)
            self.recs.append((x / rms * 0.05).astype(np.float32))
        self.weights = np.array([len(r) for r in self.recs], np.float64)
        self.weights /= max(self.weights.sum(), 1.0)

    def __bool__(self) -> bool:
        return bool(self.recs)

    def draw(self) -> Tuple[np.ndarray, int]:
        """(samples[window], n_valid_samples)"""
        rng = self.rng
        rec = self.recs[int(rng.choice(len(self.recs), p=self.weights))]
        # speed perturb by resampling a slightly longer/shorter source span
        f = float(rng.uniform(0.9, 1.1))
        src_len = min(len(rec), int(self.window * f))
        s0 = int(rng.integers(0, max(1, len(rec) - src_len + 1)))
        seg = rec[s0:s0 + src_len]
        n = min(self.window, int(round(len(seg) / f)))
        if n >= 16:
            seg = np.interp(np.arange(n) * f,
                            np.arange(len(seg)), seg).astype(np.float32)
        seg = seg * float(10.0 ** (rng.uniform(-12.0, 3.0) / 20.0))
        if rng.random() < 0.5:
            seg = _channel_sim(seg, rng)
        snr_db = float(rng.uniform(5.0, 30.0))
        sig_p = float((seg ** 2).mean() + 1e-12)
        noise = rng.normal(0.0, 1.0, len(seg)).astype(np.float32)
        noise *= np.sqrt(sig_p / (10.0 ** (snr_db / 10.0)))
        seg = seg + noise
        peak = float(np.abs(seg).max())
        if peak > 1.0:
            seg = seg / peak
        out = np.zeros(self.window, np.float32)
        out[: len(seg)] = seg
        return out, len(seg)


def pretrain_main(*, steps: int, batch_size: int, cfg: PipelineConfig,
                  lr: float = 2e-3, warmup_steps: int = 500,
                  window_seconds: float = 8.0, real_fraction: float = 0.5,
                  ckpt_dir: str | None = None, seed: int = 0,
                  resume_from: str | None = None, total_steps: int = 0,
                  log_every: int = 50, save_every: int = 500,
                  wire: str = "mulaw",
                  metrics_log: str | None = None,
                  device=None) -> float:
    """Pretrain; returns the last logged masked accuracy. ``device``: CUDA
    unless "cpu" is asked for. After ``parallel.mesh.init_distributed``
    every process runs it with the same arguments over the mesh that spans
    the processes; rank 0 alone makes the batches (the step broadcasts
    them), prints and saves, and every process takes the same steps."""
    from ..parallel.mesh import process_barrier, process_index
    from .mesh_step import training_mesh
    from .step import make_optimizer, training_device, whole_params

    main = process_index() == 0
    log = print if main else _quiet
    mesh = training_mesh(cfg.mesh, device)
    dev = training_device(device if mesh is None
                          else mesh.local().devices[0, 0])
    pcfg = PretrainConfig()
    horizon = max(total_steps or steps, warmup_steps + 1)
    tx = make_optimizer(lr=lr, warmup_steps=warmup_steps,
                        decay_steps=horizon)
    init_state, pstep, _ = make_pretrain_step(cfg, mesh or dev, pcfg, tx=tx,
                                              from_samples=True)
    params, quantizer, opt_state = init_state(seed=seed)

    fe = cfg.frontend
    window_samples = int(window_seconds * fe.sample_rate)
    batcher = SynthBatcher(cfg, batch_size=batch_size,
                           window_seconds=window_seconds, seed=seed,
                           # the pretrain stream is producer-bound: higher
                           # clean-example reuse with fresh per-draw
                           # noise/gain keeps the card fed
                           n_threads=2, snr_range=(10.0, 40.0),
                           reuse_pool=4096, reuse_p=0.93,
                           channel_aug_p=0.25, english_fraction=0.3,
                           english_sentence_p=0.65,
                           real_fraction=0.0) if main else _NoBatches()
    real = RealCropSampler(window_samples, seed=seed) if main else None
    if main and not real:
        print("no real recordings found; pretraining on synth only",
              flush=True)
        real_fraction = 0.0

    start_step = 0
    if resume_from:
        from ..models.zoo import load_checkpoint, resolve_checkpoint

        root = Path(resume_from)
        _assign_part(params, "encoder",
                     load_checkpoint(resolve_checkpoint(root, "asr"), cfg))
        with np.load(root / "head.npz") as z:
            _assign_part(params, "head", {k: torch.from_numpy(z[k])
                                          for k in ("w", "b")})
        ts = root / "train_state.npz"
        if ts.exists():
            opt_state, start_step, _ = load_train_state(ts, opt_state,
                                                        params)
        log(f"resumed from {resume_from} (step {start_step})", flush=True)

    def save(tag: str, step_now: int):
        if not ckpt_dir or not main:
            return
        from ..models.zoo import save_checkpoint

        out = Path(ckpt_dir) / tag
        whole = whole_params(params)
        save_checkpoint(out / "asr.npz", whole["encoder"])
        np.savez(out / "head.npz", **{
            k: v.detach().cpu().numpy() for k, v in whole["head"].items()})
        (out / "config.json").write_text(cfg.to_json())
        save_train_state(out / "train_state.npz", opt_state, step_now, 0.0,
                         params)
        print(f"saved pretrain checkpoint -> {out}", flush=True)

    mlog = open(metrics_log, "a") if metrics_log and main else None
    end_step = start_step + steps
    if total_steps:
        end_step = min(end_step, total_steps)
    t0 = time.perf_counter()
    acc = 0.0
    try:
        it = iter(batcher)
        for i in range(start_step, end_step):
            b = next(it)
            batch = None          # another process's: rank 0's, sent
            if b is not None:
                samples = b["samples"]
                mask = b["mask"].copy()
                if real_fraction > 0:
                    n_real = int(np.random.default_rng(seed + i).binomial(
                        batch_size, real_fraction))
                    for r in range(n_real):
                        crop, n = real.draw()
                        samples[r] = crop
                        nf = fe.frames_for_samples(n)
                        mask[r] = np.arange(mask.shape[1]) < nf
                batch = {"samples": torch.from_numpy(
                             encode_wire(samples, wire)).to(dev),
                         "mask": torch.from_numpy(mask).to(dev)}
            params, opt_state, _, metrics = pstep(
                params, quantizer, opt_state, batch, i)
            if main and (i + 1) % log_every == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                acc = m.get("masked_acc", acc)
                dt = time.perf_counter() - t0
                line = {"step": i + 1, **m,
                        "steps_per_s": round((i + 1 - start_step) / dt, 2)}
                print(json.dumps(line), flush=True)
                if mlog:
                    mlog.write(json.dumps(line) + "\n")
                    mlog.flush()
            if (i + 1) % save_every == 0 or i + 1 == end_step:
                save("last", i + 1)
        process_barrier()
    finally:
        batcher.close()
        if mlog:
            mlog.close()
    return acc


def main(argv=None):
    from ..utils.term import install_sigterm_exit

    install_sigterm_exit()
    ap = argparse.ArgumentParser(
        description="BEST-RQ pretraining on synth + real audio")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup-steps", type=int, default=500)
    ap.add_argument("--window-seconds", type=float, default=8.0)
    ap.add_argument("--real-fraction", type=float, default=0.5,
                    help="share of batch rows replaced by augmented real-"
                         "recording crops (the rest is the synth stream)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume-from", default=None,
                    help="a checkpoint directory: this pretrainer's "
                         "(asr.npz, head.npz, train_state.npz) or the JAX "
                         "pretrainer's (Orbax asr/ and the same .npz files)")
    ap.add_argument("--total-steps", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument("--wire", default="mulaw", choices=["i16", "mulaw"])
    ap.add_argument("--metrics-log", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--n-heads", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda[:N]' (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = tiny_config() if args.tiny else PipelineConfig()
    enc_over = {k: v for k, v in (("d_model", args.d_model),
                                  ("n_layers", args.n_layers),
                                  ("n_heads", args.n_heads)) if v}
    if enc_over:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                      **enc_over))
        print(f"encoder overrides: {enc_over}", flush=True)
    cfg = cfg.replace(mesh=MeshConfig(data=-1, model=1))
    pretrain_main(steps=args.steps, batch_size=args.batch_size, cfg=cfg,
                  lr=args.lr, warmup_steps=args.warmup_steps,
                  window_seconds=args.window_seconds,
                  real_fraction=args.real_fraction,
                  ckpt_dir=args.ckpt_dir, seed=args.seed,
                  resume_from=args.resume_from,
                  total_steps=args.total_steps,
                  save_every=args.save_every, wire=args.wire,
                  metrics_log=args.metrics_log, device=args.device)


if __name__ == "__main__":
    main()
