"""Training CLI: multi-task ASR training over a JSONL manifest.

The PyTorch port of ``omnilingual_asr_tpu/train/cli.py``:

    python -m omnilingual_asr_torch.train.cli manifest.jsonl \\
        --steps 1000 --batch-size 32 --ckpt out/asr.npz

``--pretrain`` runs BEST-RQ self-supervised pretraining instead (audio
only; the manifest's ``text`` is ignored) and saves the encoder, which
warm-starts supervised training (``synth_train --init-encoder``). Each
checkpoint is one ``.npz`` in the release's keystr layout: ``--ckpt X.npz``
writes that file, any other ``--ckpt`` writes ``X/asr.npz``; the engine
and ``models/zoo.py::load_checkpoint`` read it. Samples travel as f32 and
the log-mel (kernel K1 on the card) runs on the device. ``--mesh-data``
and ``--mesh-model`` train over a (data, model) mesh
(``train/mesh_step.py``: the batch over the data rows, the parameters
over the model shards; without ``--device`` the visible cards, with it
shards of that device). Everything runs on CUDA unless the caller passes
``device="cpu"`` (``--device cpu``).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..config import MeshConfig, PipelineConfig, tiny_config
from ..models.zoo import checkpoint_path, save_checkpoint
from .data import BatchLoader
from .mesh_step import training_mesh
from .step import (CTC_INFEASIBLE, ctc_rows, make_optimizer, make_train_step,
                   mel_from_samples, training_device, whole_params)


def train(manifest: str, *, steps: int, batch_size: int,
          cfg: PipelineConfig, lr: float = 1e-3,
          window_seconds: float = 15.0, ckpt: str | None = None,
          log_every: int = 10, seed: int = 0, device=None):
    mesh = training_mesh(cfg.mesh, device)
    dev = training_device(device if mesh is None else mesh.devices[0, 0])
    loader = BatchLoader(manifest, cfg, batch_size=batch_size,
                         window_seconds=window_seconds, seed=seed)
    init_state, train_step, _ = make_train_step(
        cfg, mesh or dev, tx=make_optimizer(lr=lr), from_samples=True)
    state = init_state(seed=seed)
    params, opt_state = state.params, state.opt_state

    t0 = time.perf_counter()
    audio_s = 0.0
    try:
        for i, batch in enumerate(loader):
            if i >= steps:
                break
            dev_batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
            dev_batch[CTC_INFEASIBLE] = ctc_rows(batch, cfg)
            params, opt_state, _, metrics = train_step(
                params, opt_state, dev_batch, i)
            audio_s += batch["mask"].sum() * cfg.frontend.hop_length \
                / cfg.frontend.sample_rate
            if (i + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                print(f"step {i+1}/{steps} loss={m['loss']:.4f} "
                      f"ctc={m['ctc']:.4f} lid={m['lid']:.4f} "
                      f"emo={m['emotion']:.4f} "
                      f"audio_h/min={audio_s/3600/(dt/60):.2f}", flush=True)
    finally:
        loader.close()
    if ckpt:
        path = checkpoint_path(ckpt, "asr.npz")
        save_checkpoint(path, whole_params(params))
        print(f"saved checkpoint to {path}")
    return params


def pretrain(manifest: str, *, steps: int, batch_size: int,
             cfg: PipelineConfig, lr: float = 2e-3,
             window_seconds: float = 15.0, ckpt: str | None = None,
             log_every: int = 10, seed: int = 0, device=None):
    """Self-supervised pretraining (BEST-RQ): needs only audio — manifest
    ``text`` fields are ignored. Saves encoder params that warm-start
    supervised training."""
    from ..ops.mel import MelFrontend
    from .pretrain import make_pretrain_step

    mesh = training_mesh(cfg.mesh, device)
    dev = training_device(device if mesh is None else mesh.devices[0, 0])
    loader = BatchLoader(manifest, cfg, batch_size=batch_size,
                         window_seconds=window_seconds, seed=seed)
    init_state, step_fn, _ = make_pretrain_step(
        cfg, mesh or dev, tx=make_optimizer(lr=lr))
    params, quantizer, opt_state = init_state(seed=seed)
    fe = MelFrontend(cfg.frontend, dev)
    try:
        for i, batch in enumerate(loader):
            if i >= steps:
                break
            dev_batch = mel_from_samples(
                {"samples": torch.from_numpy(batch["samples"]).to(dev),
                 "mask": torch.from_numpy(batch["mask"]).to(dev)}, fe)
            params, opt_state, _, metrics = step_fn(
                params, quantizer, opt_state, dev_batch, i)
            if (i + 1) % log_every == 0:
                print(f"pretrain step {i+1}/{steps} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"masked_acc={float(metrics['masked_acc']):.3f}",
                      flush=True)
    finally:
        loader.close()
    if ckpt:
        path = checkpoint_path(ckpt, "asr.npz")
        save_checkpoint(path, whole_params(params)["encoder"])
        print(f"saved pretrained encoder to {path}")
    return params


def main(argv=None):
    from ..utils.term import install_sigterm_exit

    install_sigterm_exit()
    ap = argparse.ArgumentParser(description="Train the omnilingual ASR model")
    ap.add_argument("manifest")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--window-seconds", type=float, default=15.0)
    ap.add_argument("--mesh-data", type=int, default=-1,
                    help="data rows of the mesh (-1: every visible card "
                         "over the model axis; with --device, 1)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model shards of each data row (tensor "
                         "parallelism)")
    ap.add_argument("--ckpt", default=None,
                    help="X.npz, or a directory that gets asr.npz")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model (CI / smoke tests)")
    ap.add_argument("--pretrain", action="store_true",
                    help="BEST-RQ self-supervised pretraining (audio only)")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda[:N]' (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = tiny_config() if args.tiny else PipelineConfig()
    cfg = cfg.replace(mesh=MeshConfig(data=args.mesh_data,
                                      model=args.mesh_model))
    fn = pretrain if args.pretrain else train
    fn(args.manifest, steps=args.steps, batch_size=args.batch_size,
       cfg=cfg, lr=args.lr, window_seconds=args.window_seconds,
       ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
