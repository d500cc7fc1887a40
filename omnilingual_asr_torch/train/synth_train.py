"""Synthetic-corpus multi-task training on one GPU or over a mesh.

The PyTorch port of ``omnilingual_asr_tpu/train/synth_train.py``: trains
every head at once (byte CTC, frame LID, emotion, AAM-softmax speaker and
the X->English translation decoder) on the formant-speech stream of
``train/synth.py``, with held-out greedy-CTC WER/CER at the end of the run
and at every ``--eval-every`` steps.

    python -m omnilingual_asr_torch.train.synth_train --pallas-kernels \\
        --steps 20000 --batch-size 16 --ckpt-dir ckpt

``--device-pool N`` keeps N baked examples on the card (int16 or, with
``--wire mulaw``, mu-law) and ships only a step's row indices; the rows'
gain and noise are drawn on the card (``train/device_pool.py``).

``--pallas-kernels`` (the reference's flag name) trains through the port's
hand-written kernels: flash attention forward and backward (K2, K6, K7)
and the fused conv module (K3), with the frames padded so that T/4 tiles
the reference's 256-row flash blocks; the log-mel (K1) runs on the card in
every mode. It needs a CUDA device. Everything runs on CUDA unless the
caller passes ``device="cpu"`` (``--device cpu``).

``--mesh-data D --mesh-model M`` (the reference's flags) trains over a
(data, model) mesh (``train/mesh_step.py``): the batch split over D data
rows, the parameters and the optimizer state over M model shards, one
update equal to one device's. Without ``--device`` the mesh spans the
visible cards (``--mesh-data -1``: all of them over the model axis); with
it every shard runs on that device, one after another.

Checkpoints are ``.npz`` files in the release's keystr layout
(``<ckpt-dir>/{best,last}/{asr,translator}.npz`` with ``config.json``;
``last/train_state.npz`` holds the optimizer). ``--resume-from`` also
takes the JAX trainer's directories (Orbax ``asr/`` and ``translator/``,
its ``train_state.npz``), and ``--init-encoder`` an Orbax ``asr/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import MeshConfig, PipelineConfig, tiny_config
from ..device import resolve_device
from ..models.conformer import asr_forward
from ..ops.attention import REFERENCE_BLOCK_Q
from ..ops.ctc import collapse_ctc
from ..utils.metrics import aggregate_wer
from .augment import SpecAugmentConfig
from .device_pool import (build_pool, encode_wire, make_pool_train_step,
                          pool_to_device)
from .step import (CTC_INFEASIBLE, ctc_rows, make_optimizer, make_train_step,
                   tree_leaves)
from .synth import SynthBatcher, eval_set, real_corpus, trim_to_window


def _moments(opt_state, key: str) -> List[torch.Tensor]:
    return [opt_state.opt.state.get(p, {}).get(key, torch.zeros_like(p))
            .detach() for p in opt_state.leaves]


def save_train_state(path: Path, opt_state, step: int,
                     best_score: float, params=None) -> None:
    """Persist the optimizer (Adam moments and update count), the step and
    the selection score next to the parameter checkpoint, atomically.
    Moments are stored per parameter leaf in ``tree_leaves`` order; over a
    mesh (``params`` a ``parallel.tensor.MeshParams``) each leaf's are
    gathered from its blocks, so the file is one device's."""
    from ..parallel.tensor import MeshParams

    m, v = _moments(opt_state, "exp_avg"), _moments(opt_state, "exp_avg_sq")
    if isinstance(params, MeshParams):
        m, v = params.merge(m), params.merge(v)
    flat = {}
    for i, (mi, vi) in enumerate(zip(m, v)):
        flat[f"m{i:05d}"] = mi.cpu().numpy()
        flat[f"v{i:05d}"] = vi.cpu().numpy()
    flat["__count__"] = np.asarray(int(opt_state.count), np.int64)
    flat["__step__"] = np.asarray(int(step), np.int64)
    flat["__best__"] = np.asarray(float(best_score), np.float64)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    tmp.replace(path)


def _from_jax_layout(path: Path, data: dict, params) -> dict:
    """The JAX trainer's ``train_state.npz`` (``l00000``...: the leaves of
    the optax chain ``clip_by_global_norm``, ``zero_nans``, ``adamw``, in
    JAX's tree order) -> :func:`save_train_state`'s keys. JAX orders a
    dict's leaves by sorted key, so the parameter tree gives the
    permutation; the chain's leaves are N ``found_nan`` flags, Adam's
    count, N first moments, N second moments and the schedule's count."""
    from ..models.zoo import flatten, parse_keystr
    from ..parallel.tensor import MeshParams

    if params is None:
        raise ValueError(f"{path}: a JAX train state needs the parameter "
                         f"tree to order its leaves")
    tree = params.full() if isinstance(params, MeshParams) else params
    paths = [parse_keystr(k) for k in flatten(tree)]
    n = len(paths)
    n_saved = sum(1 for k in data if k.startswith("l"))
    if n_saved != 3 * n + 2:
        raise ValueError(f"{path}: {n_saved} saved leaves, the JAX "
                         f"optimizer chain of {n} parameters has {3 * n + 2}")
    out = {"__count__": data[f"l{n:05d}"], "__step__": data["__step__"],
           "__best__": data["__best__"]}
    for j, i in enumerate(sorted(range(n), key=lambda i: paths[i])):
        out[f"m{i:05d}"] = data[f"l{n + 1 + j:05d}"]
        out[f"v{i:05d}"] = data[f"l{2 * n + 1 + j:05d}"]
    return out


def load_train_state(path: Path, opt_state, params=None):
    """Restore (opt_state, step, best_score) saved by
    :func:`save_train_state`, or by the JAX trainer's (which needs
    ``params``), into a fresh ``opt_state`` of the same model; leaves are
    matched by position and shape-checked. Over a mesh (``params`` a
    ``MeshParams``) each leaf's moments are split onto its blocks'
    copies."""
    from ..parallel.tensor import MeshParams

    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    if "__count__" not in data and "l00000" in data:
        data = _from_jax_layout(path, data, params)
    mesh = isinstance(params, MeshParams)
    n_leaves = len(params.blocks) if mesh else len(opt_state.leaves)
    n_saved = sum(1 for k in data if k.startswith("m"))
    if n_saved != n_leaves:
        raise ValueError(f"{path}: {n_saved} saved leaves vs {n_leaves} "
                         f"in the optimizer (different model dims)")
    count = int(data["__count__"])
    ms = [data[f"m{i:05d}"] for i in range(n_leaves)]
    vs = [data[f"v{i:05d}"] for i in range(n_leaves)]
    if mesh:
        shapes = [tuple(t.shape) for t in params.merge(
            [p.detach() for p in params.leaves])]
    else:
        shapes = [tuple(p.shape) for p in opt_state.leaves]
    for i, (m, shape) in enumerate(zip(ms, shapes)):
        if tuple(m.shape) != shape:
            raise ValueError(f"{path}: leaf {i} has shape {m.shape}, the "
                             f"model expects {shape}")
    if mesh:
        ms, vs = params.split(ms), params.split(vs)
    for p, m, v in zip(opt_state.leaves, ms, vs):
        opt_state.opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(m).to(p.device),
            "exp_avg_sq": torch.as_tensor(v).to(p.device)}
    opt_state.count = count
    return opt_state, int(data["__step__"]), float(data["__best__"])


def _assign_part(params, key: str, tree) -> None:
    """Copy a loaded subtree (``"asr"``, ``"translator"``, ``"encoder"``,
    ``"head"``) into the live parameters: the leaves themselves on one
    device, every block's copies over a mesh."""
    from ..parallel.tensor import MeshParams

    if isinstance(params, MeshParams):
        whole = params.full()
        whole[key] = tree
        params.assign(whole)
    else:
        _assign(params[key], tree)


def _assign(dst, src) -> None:
    """Copy a loaded tree into the live parameter leaves, in place, so
    that the optimizer keeps holding the same tensors."""
    with torch.no_grad():
        for p, s in zip(tree_leaves(dst), tree_leaves(src)):
            if tuple(p.shape) != tuple(s.shape):
                raise ValueError(f"loaded leaf of shape {tuple(s.shape)} "
                                 f"for a parameter of {tuple(p.shape)}")
            p.copy_(s)


def _ids_to_text(frame_ids: np.ndarray, vocab) -> str:
    units = collapse_ctc(frame_ids, blank_id=vocab.blank_id)
    byte_vals = [vocab.id_to_byte(u.byte_id) for u in units]
    byte_vals = [b for b in byte_vals if 0 <= b < 256]
    return bytes(byte_vals).decode("utf-8", errors="replace")


class Evaluator:
    """Greedy-CTC WER/CER on fixed held-out sets (the synthetic eval set,
    plus the held-out real windows where the reference recordings exist),
    on ``device`` (the card when None, which raises without one; ``"cpu"``
    for the CPU)."""

    def __init__(self, cfg: PipelineConfig, *, window_seconds: float,
                 n_synth: int = 48, batch: int = 8, frame_multiple: int = 0,
                 device=None):
        from ..ops.mel import MelFrontend

        self.cfg = cfg
        self.device = resolve_device(device)
        fe = cfg.frontend
        self.window_samples = int(window_seconds * fe.sample_rate)
        n_frames = fe.frames_for_samples(self.window_samples)
        mult = max(frame_multiple, cfg.encoder.subsample_factor)
        self.window_frames = ((n_frames + mult - 1) // mult) * mult
        self.batch = batch
        trimmed = [trim_to_window(e, self.window_samples)
                   for e in eval_set(n_synth)]
        self.sets: Dict[str, List[Tuple[np.ndarray, str]]] = {
            "synth": [(x, t) for (x, t, _, _) in trimmed if t]}
        _, real_eval = real_corpus(window_s=window_seconds)
        if real_eval:
            self.sets["gettysburg_heldout"] = [
                (w["samples"], w["text"]) for w in real_eval
                if w["language"] == "English"]
        self._frontend = MelFrontend(fe, self.device)

    @torch.inference_mode()
    def _forward(self, params, samples: torch.Tensor, n_valid: torch.Tensor):
        wf = self.window_frames
        frames, _ = self._frontend.frames_from_signal(samples)
        mel = self._frontend.log_mel(frames)[:, :wf]
        mask = torch.arange(wf, device=mel.device)[None, :] < n_valid[:, None]
        out = asr_forward(params, mel, mask, self.cfg)
        n_real = 1 + self.cfg.vocab.n_bytes
        ids = torch.argmax(out["ctc_logits"][..., :n_real], dim=-1)
        return ids.cpu().numpy(), out["mask"].cpu().numpy()

    def _decode_batch(self, params, samples_list) -> List[str]:
        fe = self.cfg.frontend
        out: List[str] = []
        for b0 in range(0, len(samples_list), self.batch):
            chunk = samples_list[b0:b0 + self.batch]
            x = np.zeros((self.batch, self.window_samples), np.float32)
            nv = np.zeros(self.batch, np.int64)
            for i, s in enumerate(chunk):
                n = min(len(s), self.window_samples)
                x[i, :n] = s[:n]
                nv[i] = fe.frames_for_samples(n)
            ids, mask = self._forward(params,
                                      torch.from_numpy(x).to(self.device),
                                      torch.from_numpy(nv).to(self.device))
            for i in range(len(chunk)):
                nf = int(mask[i].sum())
                out.append(_ids_to_text(ids[i, :nf], self.cfg.vocab))
        return out

    def run(self, params) -> Dict[str, Dict[str, float]]:
        report: Dict[str, Dict[str, float]] = {}
        for name, items in self.sets.items():
            hyps = self._decode_batch(params, [s for s, _ in items])
            report[name] = aggregate_wer(
                [(t, h) for (_, t), h in zip(items, hyps)])
        return report


def train_synth(*, steps: int, batch_size: int, cfg: PipelineConfig,
                lr: float = 2e-3, window_seconds: float = 8.0,
                ckpt_dir: Optional[str] = None, log_every: int = 50,
                eval_every: int = 1000, seed: int = 0,
                warmup_steps: int = 1000,
                resume_from: Optional[str] = None,
                total_steps: int = 0, resume_opt: bool = True,
                init_encoder: Optional[str] = None,
                metrics_log: Optional[str] = None,
                pallas_kernels: bool = False,
                stage1_steps: int = 0, stage2_steps: int = 0,
                pool_schedule: Optional[str] = None,
                fce_steps: int = 0, aux_off: bool = False,
                aux_ramp_start: int = 0, aux_ramp_steps: int = 2000,
                speed_perturb: float = 0.0, wire: str = "i16",
                channel_aug: float = 0.0, real_match: float = 0.0,
                english_fraction: float = 0.0, voice_match: float = 0.0,
                english_sentences: float = 0.0, real_fraction: float = 0.15,
                select: str = "synth", select_synth_cap: float = 0.08,
                device_pool: int = 0, pool_refresh_every: int = 150,
                dropout: float = 0.0, weight_decay: float = 1e-6,
                device=None):
    """Train; returns (params, best selection score). The knobs are the
    reference's. ``device``: CUDA unless "cpu" is asked for.

    Called after ``parallel.mesh.init_distributed``, every process runs it
    with the same arguments and it trains over the mesh that spans the
    processes (``cfg.mesh``'s data rows counted over all of them): rank 0
    alone makes the batches (the step broadcasts them), evaluates, prints
    and writes the checkpoints, and every process takes the same steps
    and returns together."""
    from ..parallel.mesh import (process_barrier, process_index,
                                 require_one_process)
    from .mesh_step import training_mesh
    from .step import whole_params

    main = process_index() == 0
    log = print if main else _quiet
    mesh = training_mesh(cfg.mesh, device)
    # The batch, the pool and the evaluator live on shard (0, 0)'s device.
    dev = (mesh.local().devices[0, 0] if mesh is not None
           else resolve_device(device))
    where = mesh if mesh is not None else dev
    use_pool = device_pool > 0
    if mesh is not None:
        if use_pool:
            require_one_process(mesh, "the device-pool step")
        log(f"training over a {mesh.shape} mesh: "
            f"{[str(d) for d in mesh.devices.flat]}"
            + (f", processes {mesh.processes.tolist()}"
               if mesh.spans_processes else ""), flush=True)
    if use_pool:
        # Round up so that refresh slices tile the pool.
        device_pool = ((device_pool + batch_size - 1)
                       // batch_size) * batch_size
    frame_multiple = 0
    if pallas_kernels:
        # Train through the hand-written kernels (flash attention forward
        # and backward, fused conv module); pad T so T/sub tiles the
        # reference's flash blocks, as the reference's kernel mode does.
        if dev.type != "cuda":
            raise RuntimeError("--pallas-kernels trains through the CUDA "
                               "kernels and needs a CUDA device")
        frame_multiple = REFERENCE_BLOCK_Q * cfg.encoder.subsample_factor
        cfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, use_flash_attention=True, use_fused_conv=True))
    batcher = SynthBatcher(cfg, batch_size=batch_size,
                           window_seconds=window_seconds, seed=seed,
                           frame_multiple=frame_multiple,
                           n_threads=2, snr_range=(15.0, 40.0),
                           reuse_pool=6144, reuse_p=0.8,
                           speed_range=((1.0 - speed_perturb,
                                         1.0 + speed_perturb)
                                        if speed_perturb > 0 else None),
                           channel_aug_p=channel_aug,
                           real_match_p=real_match,
                           english_fraction=english_fraction,
                           voice_match_p=voice_match,
                           english_sentence_p=english_sentences,
                           real_fraction=real_fraction,
                           bake_mode=use_pool) if main else _NoBatches()
    # Pool-size curriculum "max:reuse_p:steps,..." (the last entry holds).
    pool_stages: List[Tuple[int, float, int]] = []
    if pool_schedule:
        for part in pool_schedule.split(","):
            pmax, rp, n = part.split(":")
            pool_stages.append((int(pmax), float(rp), int(n)))
        p0 = pool_stages[0]
        batcher.set_pool(p0[0], p0[1])
        log(f"pool stage 0: max={p0[0]} reuse_p={p0[1]}", flush=True)
    pool_boundaries = []
    acc = 0
    for (_, _, n) in pool_stages[:-1]:
        acc += n
        pool_boundaries.append(acc)

    # Length curriculum: stage 1 (1-2 words, aux losses and SpecAugment
    # off), stage 2 (<= 5 words), stage 3 (the full mix).
    curriculum = stage1_steps > 0 or stage2_steps > 0
    if stage1_steps > 0:
        batcher.set_curriculum(min_words=1, max_words=2, simple_only=True)
    elif stage2_steps > 0:
        batcher.set_curriculum(min_words=1, max_words=5)

    def stage_weights(i: int) -> Dict[str, float]:
        w_fce = (float(np.clip(2.0 - i / float(fce_steps), 0.0, 1.0))
                 if fce_steps > 0 else 0.0)
        if aux_ramp_start > 0:
            w_aux = float(np.clip(
                (i - aux_ramp_start) / max(1, aux_ramp_steps), 0.0, 1.0))
        elif aux_off or (curriculum and i < stage1_steps):
            w_aux = 0.0
        else:
            w_aux = 1.0
        return {"w_spk": w_aux, "w_trans": w_aux, "w_aug": w_aux,
                "w_fce": w_fce, "w_ctc": 1.0}

    horizon = max(total_steps or steps, warmup_steps + 1)
    tx = make_optimizer(lr=lr, warmup_steps=warmup_steps,
                        decay_steps=horizon, weight_decay=weight_decay)
    use_dropout = dropout > 0.0
    if use_dropout:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                      dropout=dropout))
        log(f"training dropout: {dropout} (weight decay {weight_decay})",
            flush=True)
    # Milder than the ASR default: a synthetic character spans 2-3
    # subsampled frames, so 0.6 s time masks would erase whole words.
    aug_cfg = SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16,
                                n_time_masks=1, time_mask_width=24)
    if use_pool:
        init_state, pool_step, refresh_pool, _ = make_pool_train_step(
            cfg, where, tx=tx, augment=aug_cfg, with_translator=True,
            snr_range=(15.0, 40.0), dropout=use_dropout)
        log(f"building device pool: {device_pool} entries "
            f"({wire} wire)...", flush=True)
        t_bake = time.perf_counter()
        refresh_iter = iter(batcher)
        pool_np = build_pool(refresh_iter, device_pool, wire=wire)
        t_bake = time.perf_counter() - t_bake
        pool_nframes = pool_np["mask"].sum(axis=1).astype(np.float64)
        # The rows whose CTC labels cannot be aligned, known on the host
        # so that the loss reads nothing back.
        pool_infeasible = np.zeros(device_pool, bool)
        pool_infeasible[ctc_rows(pool_np, cfg)] = True
        pool = pool_to_device(pool_np, dev)
        pool_mb = sum(v.nbytes for v in pool_np.values()) / 1e6
        log(f"device pool resident: {pool_mb:.0f} MB (baked in "
            f"{t_bake:.1f} s); per-step H2D is now {4 * batch_size} B of "
            f"indices", flush=True)
        del pool_np
        pool_cursor = 0
        idx_rng = np.random.default_rng(seed + 104729)
    else:
        init_state, train_step, _ = make_train_step(
            cfg, where, tx=tx, from_samples=True, with_translator=True,
            augment=aug_cfg, dropout=use_dropout)
    state = init_state(seed=seed)
    params, opt_state = state.params, state.opt_state
    start_step = 0
    best_wer = float("inf")
    if resume_from:
        from ..models.translation import load_translator
        from ..models.zoo import load_checkpoint, resolve_checkpoint

        root = Path(resume_from)
        _assign_part(params, "asr", load_checkpoint(
            resolve_checkpoint(root, "asr"), cfg, dev))
        try:
            _assign_part(params, "translator", load_translator(
                resolve_checkpoint(root, "translator"), cfg, device=dev))
        except (OSError, KeyError, ValueError) as e:
            log(f"translator resume skipped ({str(e)[:120]}); the joint "
                f"translator starts fresh", flush=True)
        log(f"resumed params from {resume_from}", flush=True)
        ts_path = root / "train_state.npz"
        if resume_opt and ts_path.exists():
            try:
                opt_state, start_step, best_wer = load_train_state(
                    ts_path, opt_state, params)
                log(f"resumed optimizer/schedule from {ts_path} (step "
                    f"{start_step}, best {best_wer:.4f})", flush=True)
            except (KeyError, ValueError) as e:
                # Another optimizer's state (a pretraining run's): the
                # reference restarts the optimizer and keeps the params.
                log(f"train_state restore failed ({e}); optimizer restarts "
                    f"(params-only resume)", flush=True)
    elif init_encoder:
        from ..models.zoo import load_checkpoint

        _assign_part(params, "asr",
                     load_checkpoint(Path(init_encoder), cfg, dev))
        log(f"encoder warm-started from {init_encoder}", flush=True)

    evaluator = Evaluator(cfg, window_seconds=window_seconds,
                          frame_multiple=frame_multiple,
                          device=dev) if main else None
    mlog = open(metrics_log, "a") if metrics_log and main else None

    def save(tag: str):
        if not ckpt_dir:
            return
        from ..models.translation import save_translator
        from ..models.zoo import save_checkpoint

        out = Path(ckpt_dir) / tag
        whole = whole_params(params)
        save_checkpoint(out / "asr.npz", whole["asr"])
        save_translator(out / "translator.npz", whole["translator"])
        (out / "config.json").write_text(cfg.to_json())
        log(f"saved checkpoint -> {out}", flush=True)

    t0 = time.perf_counter()
    audio_s = 0.0
    end_step = start_step + steps
    if total_steps:
        end_step = min(end_step, total_steps)
    fe = cfg.frontend
    try:
        batch_iter = None if use_pool else iter(batcher)
        for i in range(start_step, end_step):
            batch = None if use_pool else next(batch_iter)
            if pool_boundaries and i == pool_boundaries[0]:
                pool_boundaries.pop(0)
                nxt = pool_stages[len(pool_stages) - len(pool_boundaries) - 1]
                batcher.set_pool(nxt[0], nxt[1])
                log(f"pool stage at step {i}: max={nxt[0]} "
                    f"reuse_p={nxt[1]}", flush=True)
            if curriculum and stage1_steps and i == stage1_steps:
                batcher.set_curriculum(min_words=1, max_words=5,
                                       clear_pool=True)
                log(f"curriculum stage 2 at step {i}", flush=True)
            if curriculum and stage2_steps and i == stage1_steps + stage2_steps:
                batcher.set_curriculum()
                log(f"curriculum stage 3 at step {i}", flush=True)
            if use_pool:
                idx = idx_rng.integers(0, device_pool, batch_size)
                scalars = dict(stage_weights(i))
                scalars[CTC_INFEASIBLE] = np.flatnonzero(
                    pool_infeasible[idx])
                params, opt_state, _, metrics = pool_step(
                    params, opt_state, pool,
                    torch.from_numpy(idx.astype(np.int32)).to(dev), i,
                    scalars)
                audio_s += float(pool_nframes[idx].sum()) * fe.hop_length \
                    / fe.sample_rate
                if pool_refresh_every and (i + 1) % pool_refresh_every == 0:
                    # Rotate one freshly baked batch into the pool, in
                    # place: ~B/P of the pool churns a refresh.
                    nb = next(refresh_iter)
                    new = {k: (encode_wire(v, wire) if k == "samples" else v)
                           for k, v in nb.items()}
                    refresh_pool(pool, pool_cursor, new)
                    sl = slice(pool_cursor, pool_cursor + batch_size)
                    pool_nframes[sl] = nb["mask"].sum(axis=1)
                    pool_infeasible[sl] = False
                    pool_infeasible[pool_cursor + ctc_rows(nb, cfg)] = True
                    pool_cursor = (pool_cursor + batch_size) % device_pool
            else:
                dev_batch = None      # another process's: rank 0's, sent
                if batch is not None:
                    dev_batch = {k: torch.from_numpy(
                        encode_wire(v, wire) if k == "samples" else v).to(
                        dev) for k, v in batch.items()}
                    dev_batch[CTC_INFEASIBLE] = ctc_rows(batch, cfg)
                    dev_batch.update(stage_weights(i))
                    audio_s += float(batch["mask"].sum()) * \
                        fe.hop_length / fe.sample_rate
                params, opt_state, _, metrics = train_step(
                    params, opt_state, dev_batch, i)
            if not main:
                continue
            if (i + 1) % log_every == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                line = {"step": i + 1, **m,
                        "steps_per_s": round((i + 1 - start_step) / dt, 2),
                        "audio_h": round(audio_s / 3600, 2)}
                log(json.dumps(line), flush=True)
                if mlog:
                    mlog.write(json.dumps(line) + "\n")
                    mlog.flush()
            if (i + 1) % eval_every == 0 or i + 1 == end_step:
                report = evaluator.run(whole_params(params)["asr"])
                rline = {"step": i + 1, "eval": {
                    k: {m: round(v, 4) for m, v in r.items()}
                    for k, r in report.items()}}
                log(json.dumps(rline), flush=True)
                if mlog:
                    mlog.write(json.dumps(rline) + "\n")
                    mlog.flush()
                w = report.get("synth", {}).get("wer", float("inf"))
                if select == "transfer":
                    c = report.get("gettysburg_heldout",
                                   {}).get("cer", float("inf"))
                    score = c if w <= select_synth_cap else float("inf")
                else:
                    score = w
                if score < best_wer:
                    best_wer = score
                    save("best")
                    if ckpt_dir:
                        (Path(ckpt_dir) / "best" / "eval.json").write_text(
                            json.dumps(rline))
                save("last")
                if ckpt_dir:
                    save_train_state(
                        Path(ckpt_dir) / "last" / "train_state.npz",
                        opt_state, i + 1, best_wer, params)
        process_barrier()
    finally:
        batcher.close()
        if mlog:
            mlog.close()
    return params, best_wer


def _quiet(*args, **kwargs) -> None:
    """A process other than rank 0 prints nothing."""


class _NoBatches:
    """A process other than rank 0's batcher: the mesh step broadcasts
    rank 0's batch, so it draws none (each step's batch is None)."""

    def __iter__(self):
        return itertools.repeat(None)

    def set_pool(self, *args) -> None:
        pass

    def set_curriculum(self, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def main(argv=None):
    from ..utils.term import install_sigterm_exit

    install_sigterm_exit()
    ap = argparse.ArgumentParser(
        description="Multi-task training on the synthetic corpus")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--warmup-steps", type=int, default=1000)
    ap.add_argument("--window-seconds", type=float, default=8.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume-from", default=None,
                    help="a checkpoint directory: this trainer's (asr.npz, "
                         "translator.npz, train_state.npz) or the JAX "
                         "trainer's (Orbax asr/ and translator/, "
                         "train_state.npz)")
    ap.add_argument("--total-steps", type=int, default=0,
                    help="global schedule horizon for segmented runs; 0 = "
                         "this invocation is the whole run")
    ap.add_argument("--no-resume-opt", action="store_true",
                    help="resume params only, with a fresh optimizer")
    ap.add_argument("--init-encoder", default=None,
                    help="warm-start the trunk from an asr .npz or an "
                         "Orbax directory (a JAX pretraining run's <dir>/asr); "
                         "ignored with --resume-from")
    ap.add_argument("--metrics-log", default=None)
    ap.add_argument("--pallas-kernels", action="store_true",
                    help="train through the hand-written CUDA kernels "
                         "(flash attention fwd/bwd, fused conv module; "
                         "pads T to tile the flash blocks); needs a GPU")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda[:N]' (default: CUDA)")
    ap.add_argument("--mesh-data", type=int, default=-1,
                    help="data rows of the (data, model) mesh (-1: every "
                         "visible card over the model axis; with --device, "
                         "1)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model shards of each data row (tensor "
                         "parallelism); with --device, every shard on it")
    ap.add_argument("--stage1-steps", type=int, default=0)
    ap.add_argument("--stage2-steps", type=int, default=0)
    ap.add_argument("--pool-schedule", default=None)
    ap.add_argument("--fce-steps", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--n-heads", type=int, default=0)
    ap.add_argument("--conv-kernel", type=int, default=0)
    ap.add_argument("--aux-ramp-start", type=int, default=0)
    ap.add_argument("--aux-ramp-steps", type=int, default=2000)
    ap.add_argument("--speed-perturb", type=float, default=0.0)
    ap.add_argument("--real-match", type=float, default=0.0)
    ap.add_argument("--english-fraction", type=float, default=0.0)
    ap.add_argument("--voice-match", type=float, default=0.0)
    ap.add_argument("--english-sentences", type=float, default=0.0)
    ap.add_argument("--real-fraction", type=float, default=0.15)
    ap.add_argument("--select", default="synth",
                    choices=["synth", "transfer"])
    ap.add_argument("--select-synth-cap", type=float, default=0.08)
    ap.add_argument("--channel-aug", type=float, default=0.0)
    ap.add_argument("--wire", default="i16", choices=["i16", "mulaw"])
    ap.add_argument("--device-pool", type=int, default=0)
    ap.add_argument("--pool-refresh-every", type=int, default=150)
    ap.add_argument("--aux-off", action="store_true")
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--weight-decay", type=float, default=1e-6)
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = tiny_config()
    elif args.resume_from:
        cfg_file = Path(args.resume_from) / "config.json"
        cfg = PipelineConfig.from_json(cfg_file.read_text())
    else:
        cfg = PipelineConfig()
    enc_over = {k: v for k, v in (("d_model", args.d_model),
                                  ("n_layers", args.n_layers),
                                  ("n_heads", args.n_heads),
                                  ("conv_kernel", args.conv_kernel)) if v}
    if enc_over:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                      **enc_over))
        print(f"encoder overrides: {enc_over}", flush=True)
    cfg = cfg.replace(mesh=MeshConfig(data=args.mesh_data,
                                      model=args.mesh_model))
    train_synth(steps=args.steps, batch_size=args.batch_size, cfg=cfg,
                lr=args.lr, window_seconds=args.window_seconds,
                ckpt_dir=args.ckpt_dir, log_every=args.log_every,
                eval_every=args.eval_every, seed=args.seed,
                warmup_steps=args.warmup_steps,
                resume_from=args.resume_from, metrics_log=args.metrics_log,
                total_steps=args.total_steps,
                resume_opt=not args.no_resume_opt,
                init_encoder=args.init_encoder,
                pallas_kernels=args.pallas_kernels,
                stage1_steps=args.stage1_steps,
                stage2_steps=args.stage2_steps,
                pool_schedule=args.pool_schedule,
                fce_steps=args.fce_steps, aux_off=args.aux_off,
                aux_ramp_start=args.aux_ramp_start,
                aux_ramp_steps=args.aux_ramp_steps,
                speed_perturb=args.speed_perturb, wire=args.wire,
                channel_aug=args.channel_aug, real_match=args.real_match,
                english_fraction=args.english_fraction,
                voice_match=args.voice_match,
                english_sentences=args.english_sentences,
                real_fraction=args.real_fraction,
                select=args.select,
                select_synth_cap=args.select_synth_cap,
                device_pool=args.device_pool,
                pool_refresh_every=args.pool_refresh_every,
                dropout=args.dropout, weight_decay=args.weight_decay,
                device=args.device)


if __name__ == "__main__":
    main()
