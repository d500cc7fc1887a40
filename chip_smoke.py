#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``omnilingual_asr_torch``).

Run from the repository root on a machine with one NVIDIA H100 SXM:

    python3 chip_smoke.py              # phases 1-5 (4, 4b, 4d-4p)
    python3 chip_smoke.py --profile    # and phase 4c before the report, and
                                       # phase 4l's step profiles

Phases, each printed with its elapsed seconds; any failure exits non-zero
with no result line:

1. device  - card name and power limit; TF32 off for matmuls and cuDNN.
2. build   - nvcc builds the kernels from ``omnilingual_asr_torch/csrc``
             and each kernel's registers and spills are printed.
3. kernels - log-mel (K1, at the serving, the training path's and the
             crop re-embedding's frames, [16 x 768], the eval
             drivers' [4 x 1024] and [1 x 3072], the trainers'
             [64 x 512], [64 x 1024] and [16 x 1024], the pretrainer's
             [64 x 1024], the manifest trainer's [16 x 1536], sequence
             mode's [11 x 3072] (a 330 s file's chunks) and a training
             mesh's data row [8 x 1024]; its bound
             counted for
             the function as an FFT computes it, the dense DFT's beside
             it), flash attention (K2, at head dims 64 and 128, at the
             training shape, at a ragged T of 200, at the d512 seed's
             [4, 768, 8, 64], at the eval drivers' [4, 256, 4, 64] and
             [1, 768, 8, 64], at a data shard's [2, 768, 4, 64], at one
             model shard's heads [4, 768, 2, 64] and [4, 768, 1, 64] and
             at a training mesh's [8, 256, 4, 64] and [16, 256, 2, 64]),
             the fused conv module (K3, at the serving
             and the training shape, at large_config's width, D 1024, at
             the d512 seed's [4, 768, 512], at the eval drivers'
             [4, 256, 256] and [1, 768, 512] and at a data shard's
             [2, 768, 256], each with its launch plan:
             both launches' blocks and pw1's rows a frame; then split over
             2 and 4 model shards at the release's and the d512 seed's
             serving batch and at a training mesh's [8, 256, 512] over 2
             and [16, 256, 512] over 4, against the plain split and whole
             K3), the
             int8 matmuls W8A16 (K4) and W8A8 (K5, at the
             three widths of the quantized main path, K5 also at a data
             shard's M 1536) and the
             flash-attention backward, dQ (K6) and dK/dV (K7), at the
             training shape, at large_config's head dim 128, at a
             ragged T of 200 and at a training mesh's shard shapes (with
             the o and lse they read held to the plain forward), and the
             f32 variants of K2, K6 and K7 (the f32 encoder's, at
             ``card_cases.F32_FLASH_SHAPES``; SDPA at f32 their
             yardstick; all three on 3xTF32 ``mma.sync``, bound at three
             TF32 products a product, the f32 FMA-rate bound beside it),
             and the f16 variants of K2, K6 and K7 (the f16 encoder's, at
             ``card_cases.F16_FLASH_SHAPES``, K6 and K7 again at dO x
             ``F16_TINY_DO``, gradients under f16's normal range, and x
             ``F16_LARGE_DO``, where a fixed scale of dS would pass
             f16's 65504;
             SDPA at f16 their yardstick, bound at the f16 tensor-core
             rate; the f16 K2's (wgmma and TMA), K6's and K7's registers
             beside their earlier design's),
             on seeded inputs with masked rows, each held against its plain
             PyTorch version, and timed beside its plain version, a PyTorch
             yardstick where one exists, and the card's bound. Times are
             device times: 20 calls captured back to back in a CUDA graph,
             replayed between CUDA events (``call_ms`` adds one eager
             call's time, host launch included). K3's, K4's, K5's and
             the f32 and f16 K2's, K6's and K7's entries carry their
             kernels' registers; K3's, K4's and K5's previous
             design's recorded times (RECORDED_EARLIER_MS, not measured
             here) follow on a line of their own.
4. e2e     - ``TranscriptionEngine`` on the card with the release weights
             answers three ``transcribe`` requests (the golden fixture, the
             same audio tiled to two minutes = one full batch of 4 windows,
             and that again warm); the golden result is held to the JAX
             engine's stored result, and the kernel launch counters show
             that the requests ran through K1-K3. Then the int8 paths,
             each through the port's ``GeminiDiarizedTranscriptionPipeline``
             facade: ``quantize="a8"`` and ``"w8"`` answer the golden file
             and the tiled file, held to the JAX engine's int8 results, with
             10 K5 or K4 launches a batch; ``quantize=True`` answers the
             golden file with neither.
4b. train  - ``train_synth`` (the port's ``python -m
             omnilingual_asr_torch.train.synth_train --pallas-kernels``
             path) runs 4 steps at ``PipelineConfig()`` dims (d_model 512,
             12 layers, 8 heads), batch 16 of 8 s windows, from a seeded
             init: per step the loss and metrics, the step's seconds, the
             host's wait for ``SynthBatcher`` and the kernel launches
             (exactly K1 1, K2 12, K6 12, K7 12, K3 12, K4/K5 0), then the
             held-out evaluation. Then a gradient check: one batch of 2
             windows through the kernels on the card against the same step
             on the CPU (plain versions), leaf by leaf, beside the card's
             own floor and a planted fault that must miss the tolerance.
4d. decoders - ``TranscriptionEngine`` on the card with the release
             translator (text mode) and fact-conditioned summarizer given
             by explicit path answers the golden file and the tiled file,
             with the same K1-K3 launches a batch as phase 4. The golden
             result (translations and the neural summary included) is held
             to the JAX engine's ``golden_decoders.json``, and its decodes'
             tokens to the JAX engine's; every decode, replayed from its
             CUDA graph, is held to the same decode run eagerly. Then the
             decoders' seconds a request (warm, 3 rounds, graphs on and off
             in turns) beside the StageTrace's ``assemble.translate`` and
             ``assemble.summary``.
4e. server - the port's HTTP server (``serving/app.py``'s ``OmniServer``)
             in front of phase 4d's engine, on 127.0.0.1 with SQLite
             history. The native ``omniaudio`` library must have been built
             from the port's source under ``_build/`` (the phase fails on
             the Python fallback); it and the Python parser decode the
             tiled 120 s and 330 s files to equal samples, both timed.
             Then: ``/api/transcribe`` on the golden file, held to
             ``golden_decoders.json``; ``/api/transcribe-stream`` on the
             120 s file (progress steps, one result); the 44.1 kHz stereo
             golden audio and the 330 s file served alone (and an MP3 of
             the golden audio where libav is linked and ffmpeg can make
             one); the K1-K3 launches over those serial requests; the
             same files at once on ``/api/transcribe-batch-stream`` (the
             stereo one inside a .zip), each equal to the file served
             alone; ``/api/history`` and the five exports of every entry,
             each equal to ``export_transcript`` on the stored entry; the
             live route (``/api/transcribe-stream-live``) streaming the
             golden file, its result held to ``golden_decoders.json``.
             Then warm seconds through HTTP beside
             ``engine.transcribe`` (golden, 120 s), and the batch route's
             wall seconds under the engine's device lock, under a lock
             around whole requests, and served one after another.
4f. d512  - ``checkpoints/r5_d512x12_seed`` (d_model 512, 12 layers, 8
             heads, no x-vector) through ``config_for_checkpoint`` in crop
             speaker mode, greedy and with the beam search (beam 8, the
             "synth" lexicon, lm_alpha 0.3), answers the golden and the
             tiled file through ``transcribe`` and
             ``transcribe_streaming``, held to ``golden_d512_crop.json``
             (the beam texts of its stable decodes exact, the beam's
             top-K feed within ``testing.FEED_TOL`` of the JAX engine's,
             the search over the JAX feed giving every JAX text; every
             stream's final event equal to ``transcribe``'s); K1 launches a
             window batch and a crop batch ([16 x 768]), K2 and K3 12 a
             window batch. Then warm seconds (inline, crop and beam crop),
             the ``extract`` stage and the crop forward; the live route's
             first partial and final event against ``engine.transcribe``;
             the release engine with μ-law ingress and with the int8
             speaker wire at stride 2 on the golden file, held to the JAX
             engine's results in those modes; ``health_check``.
4g. evals  - the port's evaluation drivers (``omnilingual_asr_torch/
             eval/``) with the release weights, held to the JAX package's
             ``golden_evals.json`` (``testing.py``'s criteria):
             ``eval.synth`` on its 96 held-out files at 10 s windows (texts
             on at least 94, the files' greedy ids together on 99.5 %,
             WER and CER within 0.005), its first 32 files unquantized and
             under "w8" and "a8" (WER/CER, RTF, K4/K5 launches; reported,
             not held); ``eval.heads`` on 64 files and 8 conversations with
             the release translator and summarizer (languages and emotions
             equal but for one tied emotion, translation word accuracy
             within 0.01, summary accuracies equal); ``eval.diar`` on 16
             conversations (speaker counts equal on 15, each DER within
             0.02, the mean within 0.01); ``eval.long``'s engine on the
             420 s file (streamed; greedy ids on 99.5 %, the result's
             structure by ``testing.long_mismatches``: its tones are no
             speech, and the JAX result itself moves under 1-LSB noise);
             one K1, four K2 and four K3 launches a release batch. Then
             ``python -m omnilingual_asr_torch.eval.long --hours 1`` and
             ``eval.latency`` (d512 x 12, batch 1, 16 reps), each in a
             process of its own with the release discovered.
4h. trainers - the four trainers the release's other weight files come
             from, each through the port's own functions on the card from
             a seeded init: ``train_xvector`` (``PipelineConfig()``'s
             x-vector, 8 steps of 64 4 s windows, the 48-utterance eval at
             step 8), the text translator (``text_translator_train``, the
             release's dims, 20 steps of 128, 64 eval pairs a set), the
             audio translator (``translator_train``, a seeded decoder on
             the release ASR, 256 + 32 utterances, 20 steps of 64) and the
             summarizer (``summary_train`` on the release ASR, a pool of
             96, 64 + 8 conversations, 20 steps of 32). Each must give
             finite losses, exactly its K1 launches (one a x-vector step
             and eval batch, one a frozen-encoder batch of 64, one a
             conversation; no other kernel), one update on the card equal
             to the same update on the CPU (gradients within 5e-2 per
             leaf, the loss within 1e-3), and a file that the port's
             loaders read back equal. Each prints its steps per second,
             its seconds by part (host synthesis, encoding, steps, eval)
             and the card's peak memory. Then an engine with the trained
             x-vector, summarizer and each translator (text and audio
             mode) by explicit path answers the golden file: segments, a
             translation attempt on every non-English span, a summary.
4i. rest   - the rest of training at ``PipelineConfig()`` width, each
             run through the port's own functions on the card, cut in
             steps and data: ``pretrain_cli.pretrain_main`` at its
             defaults (batch 64 of 8 s, the mu-law wire, English
             sentences at 0.65, a codebook of 8192 x 16) for 12 steps with
             2 of warmup on one producer thread (an ordered stream, the
             same every call), its masked CE falling; its ``last/asr.npz``
             warm-starting one ``train_synth --init-encoder`` step (the
             trunk equal to the file after it); ``train_synth`` in kernel
             mode with a device pool of 512 on the mu-law wire, English
             sentences at 0.65, batch 16 of 8 s, 20 steps refreshed every
             5 (in place); the manifest trainer (``cli.train``, 6 steps of
             16 x 15 s, then ``cli.pretrain``, 4 steps) over 48 written
             WAVs, both checkpoints loading back; AED's joint loss for 10
             steps of 16 x 8 s, then its greedy decode at ``max_len`` 256.
             Every step's launches exactly (K1 1; the pool step K2, K3,
             K6, K7 12 each), finite losses, seconds by part (host
             synthesis or bake, steps, save), steps a second and card peak
             memory; one update of pretraining, the pool step and AED on
             the card against the CPU (the same rows and draws; gradients
             within 5e-2 per leaf, the loss within 1e-4).
4j. mesh   - the device mesh without tensor parallelism and the packed
             wire, with the release weights, meshes as shards on the card
             (and, where more than one card is visible, (a)-(e) again over
             distinct cards): (a) ``long_mode="sequence"`` at one shard and
             at four on the golden file (held to ``golden_sequence.json``)
             and the 330 s tiled file (four shards' ids on 99.5 % of one
             shard's; K1 one launch for the file's mel plus one a crop
             batch, K2/K3 none; seconds and peak memory beside window mode),
             then the longest file its forward takes at one shard and at
             four (``MESH_CEILING_MINUTES`` tried in turn until one runs out
             of memory); (b) ``ring_attention`` at T 4096 over 8 shards
             against full attention; (c) data-parallel windows, 2 shards of
             2 equal to one shard of 2 and on 99.5 % of ids to one shard of
             4, unquantized and "a8", golden and 120 s files (K1-K3, K5
             launches a shard batch); (d) the release model with 8 experts grafted into its
             second FFNs (seeded router and perturbations): the engine on
             the card against the port's CPU engine (ids on 99.5 %), the
             all-to-all conformer on a (2, 4) mesh against dense dispatch at
             capacity 16, the drop count at capacity 1, one kernel-mode step
             at ``PipelineConfig()`` with 8 experts and batch 16 (finite,
             ``moe_aux``, exactly K1 1 and K2, K3, K6, K7 12) and one update
             card vs CPU at batch 2 (``testing.TRAINER_GRAD_REL``); (e)
             ``pipeline_forward`` at 4 stages and 4 microbatches of release
             blocks against ``apply_stacked_blocks``; (f) the packed wire on
             and off on the 120 s file: equal results, device-to-host copies
             a batch, warm seconds over 6 requests each, interleaved.
4k. tp     - tensor parallelism in serving with the release weights,
             meshes as shards on the card (and, where more than one card
             is visible, (a), (e) and (g) again over distinct cards): (a)
             the engine at (data, model) (1, 2), (1, 4) and (2, 2),
             unquantized and ``quantize=True``, on the golden and the
             120 s file: every golden result held to ``golden.json`` (to
             the (1, 1) ``quantize=True`` engine under quantize=True),
             the meshes' golden ids and 120 s ids pooled against the same
             references on 99.5 %; per data row's shard batch K1 once and
             K2 and split K3 once a model shard a layer, whole K3, K4 and
             K5 never; (b) ``quantize="a8"`` and ``"w8"`` at model 2
             raise ValueError; (e) the release with 8 grafted experts at
             (1, 4) with all-to-all dispatch inside the blocks against the
             dense engine (ids on 99.5 %); (f) the d512 seed in crop mode
             at model 2 against ``golden_d512_crop.json`` where stable;
             (g) sequence mode at (2, 2) against ``golden_sequence.json``;
             (h) warm 120 s request seconds and card memory at model 1, 2
             and 4 (reported). (c) and (d), the split K3 and K2 at one
             shard's heads, run in phase 3.
4l. mesh training - training over a (data, model) mesh at
             ``PipelineConfig()`` width (d512 x 12, 8 heads), kernel mode,
             batch 16 of 8 s, the translator on, meshes as shards on the
             card: ``train_synth`` over (2, 2) for 3 steps from host
             batches (finite losses; a step's launches exactly K1 2, K2,
             K6, K7 and split K3 48, whole K3 0), its checkpoint equal to
             the gathered parameters and served by the one-device engine;
             one update at (2, 1), (1, 2), (2, 2) and (1, 4) (again over
             distinct cards where more than one is visible), one pool step
             at (2, 2) and one pretraining update at (2, 1), each against
             the same update on one device of the card (loss within 1e-3,
             every leaf's gradient within 5e-2, the worst leaf printed);
             step seconds, launches and peak memory at (1, 1), (2, 2)
             and (1, 4), printed, not held (with ``--profile`` one more
             step of each under the profiler: device events, busy share).
4m. f32 and moe mesh - (a) the release with the f32 encoder
             (``encoder.dtype="float32"``) serves the golden and the 120 s
             file with one model shard and at (data, model) (1, 2): the
             golden result held to ``golden_f32.json``, both files' ids
             on 99.5 %, each batch's launches exactly (K1 once, the f32
             K2 once a shard a layer, K3 whole or split, no bf16
             attention kernel), warm 120 s seconds beside bf16 in turns;
             (b) ``train_synth`` at f32, ``PipelineConfig()`` dims, batch
             16 of 8 s, kernel mode, 3 steps (each step's launches
             exactly: the f32 K2, K6, K7 and K3 12 each), one f32 update
             on the card against the CPU (``TOL_GRAD_REL``, the worst leaf
             printed), and f32 against bf16 on phase 4l's (1, 1) step in
             turns; (c) ``PipelineConfig()`` with 8 experts, kernel mode,
             batch 16: one update at (2, 1), (1, 2), (2, 2), (1, 4) of
             the card's shards against one device (loss and ``moe_aux``
             within ``TOL_MM_REL``, every leaf within ``TOL_GRAD_REL``,
             the routing choices that differ counted), then 3 steps at
             (1, 1), (2, 2), (1, 4) with exact launches, seconds and peak
             memory.
4n. multiprocess - training over a mesh whose data rows lie in 2
             processes joined by ``parallel.mesh.init_distributed`` (both
             on the card: gloo, every crossing staged through the host;
             again over NCCL with a card a process where two are
             visible), ``PipelineConfig()``, kernel mode, translator,
             SpecAugment, dropout 0.1, batch 16 of 8 s, from parameters
             and a batch the parent writes as ``.npz`` after building the
             kernels: one update over 2 x (1, 1) and 2 x (1, 2) and one
             pretraining update over 2 x (1, 1), each against the
             single-process mesh of the same global shape on the card
             (loss within ``MESH_LOSS_REL``, every leaf's gradient and
             clipped gradient within ``MESH_GRAD_REL``; the single
             process's own repeat printed), rank 1's loss and gradients
             equal to rank 0's; each process's launches exactly
             (``_mt_launches`` of its shards); 3 ``train_synth`` steps over
             2 x (1, 2) with finite losses and exact launches, rank 0's
             checkpoint equal to both processes' gathered parameters. A
             child that fails or runs past MP_CHILD_TIMEOUT_S (killed)
             fails the phase. Prints the backend, each process's step
             seconds beside the single process's, the gradients' sum over
             processes alone and the bytes a process hands to
             collectives (not held).
4o. f16     - (a) the release with the f16 encoder
             (``encoder.dtype="float16"``) serves the golden and the 120 s
             file with one model shard and at (data, model) (1, 2): the
             golden result held to ``golden_f16.json``, both files' ids
             on 99.5 %, each batch's launches exactly (K1 once, the f16
             K2 once a shard a layer, K3 whole or split, no bf16 or f32
             attention kernel), warm 120 s seconds beside bf16 in turns;
             (b) ``train_synth`` at f16, ``PipelineConfig()`` dims, batch
             16 of 8 s, kernel mode, 3 steps (finite losses; each step's
             launches exactly: the f16 K2, K6, K7 and K3 12 each), one f16
             update on the card against the CPU (``TOL_GRAD_REL``, the
             worst leaf printed).
4p. checkpoints - Orbax checkpoints without JAX (``checkpoint/``): (a)
             the committed fixture ``testdata/orbax_jax/`` (the JAX
             package's saves) read by the port, every leaf equal to its
             ``.npz`` twin bit for bit, and the zstd decoder's (libzstd) MB/s
             on its chunks on this host; (b) the d512 seed and a
             translator from init written by the port as Orbax ``asr/``
             and ``translator/``, and a ``train_state.npz`` in the JAX
             trainer's layout (random moments, a step, count and score),
             read back bit for bit (write and read seconds beside
             ``np.load`` of the ``.npz``), then ``train_synth`` resumed
             from it, ``PipelineConfig()``, kernel mode, batch 16 of 8 s,
             3 steps: before step 1 the trunk equals the ``.npz``, the
             translator the one written, and Adam's moments, count, the
             step and the score what was written; finite losses, each
             step's launches exactly as in phase 4b; (c) an engine built from the release
             ASR written as an Orbax directory serves the golden file,
             held to ``golden.json``, its greedy ids identical to the
             ``.npz`` engine's.
4c. profile - (``--profile`` only) median request seconds over 3 warm runs
             and the StageTrace stages at 30, 120 and 330 s of audio (1, 1
             and 3 batches); 120 s requests of the unquantized, a8 and w8
             engines in 7 turns; then one warm 120 s request of each under
             ``torch.profiler``: device time by kernel and the device's
             busy share of the request's wall time, and the same for a
             120 s request of phase 4d's engine. Then a warm
             kernel-mode training step at ``PipelineConfig()`` dims, batch
             16: the host's batch wait, upload, forward + loss, backward
             and optimizer seconds, and one step under the profiler.
5. report  - one ``{"kernels": [...]}`` line (K1-K7 and the f32 and f16
             K2, K6, K7; ``launches`` summed over the serving, training,
             decoders, server, d512, evals, trainers, rest_of_training,
             mesh, tp, mesh_training, f32_moe_mesh, multiprocess, f16 and
             checkpoints paths,
             K3's whole
             and split over a model axis (one a shard),
             by path beside it), the
             ``nvidia-smi`` name and power limit, and the result line
             ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import wave
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "omnilingual_asr_torch"
RELEASE = ROOT / "checkpoints" / "release"
D512 = ROOT / "checkpoints" / "r5_d512x12_seed" / "asr.npz"
SEED = 1234
N_TIMED = 20
WINDOWS_PER_BATCH = 4
TILED_SECONDS = 120.0
PROFILE_SECONDS = (30.0, 120.0, 330.0)
PROFILE_WARM_RUNS = 3
INT8_ROUNDS = 7
DECODER_ROUNDS = 3       # warm requests a decoder mode in phase 4d
D512_ROUNDS = 3          # warm requests a d512 mode in phase 4f (medians)
TRAIN_STEPS = 4          # train_synth steps at PipelineConfig() dims
TRAIN_BATCH = 16         # 8 s windows a step
EVAL_WINDOW_SECONDS = 10.0  # eval.synth's windows (1024 frames, T' 256)
# Valid keys of the attention checks at the training shape (T' 256): 12
# whole rows, ragged, short, one valid key and a padded batch slot.
TRAIN_VALID_KEYS = [256] * 12 + [200, 77, 1, 0]

# Peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W): f32 on
# the CUDA cores, bf16, f16, int8 and tf32 on the tensor cores, and HBM3
# bandwidth. The SXM part names itself "NVIDIA H100 80GB HBM3".
H100_SXM_PEAKS = {"f32": 67e12, "bf16": 989e12, "f16": 989e12,
                  "int8": 1979e12, "tf32": 495e12, "bytes": 3.35e12}

# Tolerances of each kernel against its plain version on the same inputs.
TOL_K1 = 1e-3   # log-mel, abs: both are f32; the sums run in another order
#                 (relative error ~1e-6 of a mel value); zero padding frames
#                 hit the log floor exactly in both
# attention output, per element |o - o_ref| <= ABS + REL * |o_ref|: both
# round an f32 result to bf16, and where the two f32 values (summed in
# another order) straddle a rounding boundary they land one bf16 ulp apart,
# which is at most 2^-7 |o_ref|; ABS covers the f32 difference itself
# (exp and sums over 768 keys in another order, ~1e-6), which matters only
# where o is near zero. A dropped key or a wrong V sum moves o by ~|o|.
TOL_K2_REL = 2.0 ** -7
TOL_K2_ABS = 1e-4
TOL_K2_LSE = 1e-3  # logsumexp, abs: f32 online softmax vs one pass
# Flash backward (K6, K7), per element |g - g_ref| <= ABS * max|g_ref| +
# 2^-7 |g_ref|: both round an f32 sum to bf16 (one ulp, 2^-8 relative,
# apart where they straddle a rounding boundary; 2^-7 covers the f32 sums
# differing on top of that), and the sums of p * (dp - delta) over up to
# 768 keys, whose terms cancel, are taken in another order, which ABS
# bounds relative to the largest element. Masked keys and fully-masked
# rows must be exactly 0. A dropped key or a wrong p moves g by ~|g|.
TOL_BWD_ABS = 2.0 ** -10
TOL_BWD_REL = 2.0 ** -7
# Training-step gradients on the card (K1-K3, K6, K7) against the same step
# on the CPU (plain versions), per leaf ||g - g_cpu|| / ||g_cpu||: q, k, v,
# o, dq, dk and dv are rounded to bf16 in both, from f32 sums taken in
# another order, so single elements differ by a bf16 ulp (2^-8) and the
# fused conv module's output by up to TOL_K3. Where such a difference flips
# a ReLU gate or a bf16 rounding of q or k, a gradient jumps: on the CPU
# tests' model a 1e-6 relative perturbation of the input moves single
# leaves by more than 1e-2 (tests/test_torch_train.py::
# test_kernel_mode_gradient_floor), so per-leaf errors of a few 1e-2 are
# the floor of the comparison, not a fault. The check prints the card's
# own floor (the same step with the parameters perturbed by 1e-6 relative)
# beside it, and plants a fault (delta dropped from the flash backward)
# whose reading must exceed the tolerance, or the check fails.
TOL_GRAD_REL = 5e-2
# K3's, K4's and K5's tolerances (TOL_K3, TOL_K4_ORDER with
# k4_error_share, TOL_K5_REL) and the shapes they are checked at are in
# omnilingual_asr_torch/ops/card_cases.py, which the tiling sweep reads too.
# The release layers that take K4/K5, by width N: the FFN up-projections
# (8 a batch), the CTC head and the LID head.
QUANT_LAYERS = {1024: ("blocks", 0, "ffn1", "w1"), 512: ("ctc_head",),
                2048: ("lid_head",)}
# Device ms of K3, K4 and K5 as designed before their current design (K3:
# 32 frames a block over 64 halo rows, both products as f32 FMAs on the
# CUDA cores; K5: every column tile re-quantizing its rows; K4: every
# column tile re-reading and re-rounding x, no cp.async, int8 widened a
# byte at a time), by D and by N at this script's shapes: the mean of two
# runs of this script at commit 622b750 (K3, K5) and a01c040 (K4) on an
# H100 80GB HBM3 at 700 W. Recorded, not measured by this run: logged on a
# line of its own after the kernel checks, and in no entry of the report.
RECORDED_EARLIER_MS = {"conv_module": {256: 0.1515119969844818,
                                       512: 0.5420583963394165,
                                       1024: 2.0611288070678713},
                       "q_matmul_w8a16": {512: 0.012005599960684777,
                                          1024: 0.01729839965701103,
                                          2048: 0.03151520043611526},
                       "q8a8_matmul": {512: 0.01579599976539612,
                                       1024: 0.027265599370002745,
                                       2048: 0.04393839985132217}}


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def card_peaks(name: str) -> dict:
    """The bound's peak rates; only the H100 SXM's are known here."""
    if "H100" not in name or not ("HBM3" in name or "SXM" in name):
        raise PhaseError(f"no peak rates for {name!r}: the bounds assume an "
                         f"H100 SXM")
    return H100_SXM_PEAKS


def time_ms(fn, n: int = N_TIMED, reps: int = 5, stream=None) -> float:
    """Device milliseconds of one ``fn()``: n calls captured back to back in
    one CUDA graph, so that no host launch time sits between them, and the
    graph replayed ``reps`` times between CUDA events; the median replay
    over n. Every kernel, plain version and yardstick is timed this way.
    ``stream``: warm up and capture on it (a backward pass runs on the
    stream of its forward, so an autograd call is timed on that one)."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def call_ms(fn, n: int = N_TIMED) -> float:
    """Median milliseconds of one eager ``fn()`` between CUDA events, the
    wrapper's host launch time included (the first slice's measure)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops_by_type: dict, n_bytes: int, peaks: dict):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = n_bytes / peaks["bytes"]
    t_ops = sum(f / peaks[kind] for kind, f in flops_by_type.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# Phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def check_k1(dev, peaks, cfg):
    """K1 at the serving path's shape (a batch of 4 x 30 s windows: 3072
    frames each, 2998 valid), and under "shapes" at the training path's
    (batch 16 of 8 s windows padded to 1024 frames, 798 valid), the
    crop re-embedding's (16 crops of 6 s padded to 768 frames, 598
    valid), eval.synth's (4 x 10 s windows: 1024 frames, 998 valid),
    eval.latency's (one 30 s window), the trainers'
    (``card_cases.K1_TRAINER_SHAPES``), the rest of training's
    (``card_cases.K1_REST_SHAPES``) and sequence mode's (the 330 s file's
    11 chunks of 30 s plus the frame overlap, 3000 frames each)."""
    from omnilingual_asr_torch.engine import (SPK_CROP_BATCH,
                                              SPK_CROP_SECONDS,
                                              WINDOW_SECONDS)
    from omnilingual_asr_torch.ops import card_cases

    main = _k1_case(dev, peaks, cfg, WINDOWS_PER_BATCH, 3072, 2998, SEED)
    train = _k1_case(dev, peaks, cfg, TRAIN_BATCH, 1024, 798, SEED + 13)
    crop_frames = cfg.frontend.frames_for_samples(
        int(SPK_CROP_SECONDS * cfg.frontend.sample_rate))
    crop = _k1_case(dev, peaks, cfg, SPK_CROP_BATCH,
                    math.ceil(crop_frames / 256) * 256, crop_frames,
                    SEED + 17)
    # The eval drivers': eval.synth's 10 s windows (998 frames padded to
    # 1024) and eval.latency's one 30 s window at batch 1.
    eval10 = _k1_case(dev, peaks, cfg, WINDOWS_PER_BATCH, 1024,
                      cfg.frontend.frames_for_samples(
                          int(EVAL_WINDOW_SECONDS
                              * cfg.frontend.sample_rate)), SEED + 20)
    lat = _k1_case(dev, peaks, cfg, 1, 3072, 2998, SEED + 21)
    # The trainers' (phase 4h): the x-vector's 64 4 s windows, the audio
    # translator's 64 8 s utterances, the summarizer's 16 8 s windows.
    trainers = [_k1_case(dev, peaks, cfg, B, t_pad, valid, SEED + 22 + i)
                for i, (B, t_pad, valid) in enumerate(
                    card_cases.K1_TRAINER_SHAPES.values())]
    # The rest of training's (phase 4i): the pretrainer's 64 8 s windows
    # and the manifest trainer's 16 15 s windows.
    rest = [_k1_case(dev, peaks, cfg, B, t_pad, valid, SEED + 26 + i)
            for i, (B, t_pad, valid) in enumerate(
                card_cases.K1_REST_SHAPES.values())]
    # Sequence mode's (phase 4j): one call over the 330 s file's 11 chunks
    # of 30 s plus the win - hop overlap.
    fe = cfg.frontend
    chunk = int(WINDOW_SECONDS * fe.sample_rate) + fe.win_length \
        - fe.hop_length
    seq_valid = fe.frames_for_samples(chunk)
    seq = _k1_case(dev, peaks, cfg, math.ceil(MESH_SEQ_SECONDS
                                              / WINDOW_SECONDS),
                   math.ceil(seq_valid / 256) * 256, seq_valid, SEED + 28)
    # Training over a mesh (phase 4l): a data row's 8 windows.
    mesh_rows = [_k1_case(dev, peaks, cfg, B, t_pad, valid, SEED + 29 + i)
                 for i, (B, t_pad, valid) in enumerate(
                     card_cases.K1_MESH_SHAPES.values())]
    return {"name": "log_mel", "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/mel.cu",
            "replaces": "omnilingual_asr_tpu/ops/mel_pallas.py:66",
            **main, "shapes": [main, train, crop, eval10, lat, *trainers,
                               *rest, seq, *mesh_rows]}


def _k1_case(dev, peaks, cfg, B, t_pad, n_frames, seed):
    import torch
    from omnilingual_asr_torch.audio.frontend import hann_window
    from omnilingual_asr_torch.ops.mel import (MelFrontend, log_mel_frames,
                                               log_mel_frames_plain)

    fe_cfg = cfg.frontend
    fe = MelFrontend(fe_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = 0.1 * torch.randn(B, t_pad, fe_cfg.n_fft, generator=gen,
                               device=dev)
    frames[:, n_frames:] = 0.0            # padding rows, as on the main path
    frames = frames.reshape(-1, fe_cfg.n_fft).contiguous()
    floor = fe_cfg.log_floor
    plan = fe.plan
    got = log_mel_frames(frames, fe.cw, fe.sw, fe.fb, floor, plan)
    want = log_mel_frames_plain(frames, fe.cw, fe.sw, fe.fb, floor)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > TOL_K1:
        raise PhaseError(f"K1 log-mel {B} x {t_pad} frames: max abs err "
                         f"{err:.3e} > {TOL_K1}")
    # Yardstick: the same function through cuFFT (rfft of the windowed
    # frames), the library's way to a power spectrum.
    win = torch.zeros(fe_cfg.n_fft, device=dev)
    win[:fe_cfg.win_length] = torch.from_numpy(
        hann_window(fe_cfg.win_length)).to(dev)

    def library():
        spec = torch.fft.rfft(frames * win, n=fe_cfg.n_fft, dim=-1)
        power = spec.real * spec.real + spec.imag * spec.imag
        return torch.log(torch.clamp(power @ fe.fb, min=floor))

    lib_err = float((library() - want).abs().max())
    n, n_fft = frames.shape
    n_mels = fe.fb.shape[1]
    n_bins = fe_cfg.n_freqs
    # The function as computed with a real FFT: ~2.5 n log2 n FLOP a frame,
    # plus the mel projection over the filterbank's nonzero weights (one
    # FMA each). Bytes it must move: the frames' samples under the window
    # (zero past it, so the rest cannot change the result), fb and the
    # output. The dense DFT's count (the TPU's algorithm, and this row's
    # yardstick before the FFT kernel) is kept beside it.
    fft_flops = n * (2.5 * n_fft * math.log2(n_fft) + 2 * plan.n_weights)
    n_win = plan.window.shape[0]
    b_ms, b_by = bound({"f32": fft_flops},
                       n * n_win * 4 + nbytes(fe.fb, got), peaks)
    dft_flops = 2 * n * n_fft * n_bins * 2 + 2 * n * n_bins * n_mels
    dft_ms, _ = bound({"f32": dft_flops},
                      nbytes(frames, fe.cw, fe.sw, fe.fb, got), peaks)
    all_ms, _ = bound({"f32": fft_flops}, nbytes(frames, fe.fb, got), peaks)
    return {
        "max_abs_err": err, "tol": TOL_K1,
        "ms": time_ms(lambda: log_mel_frames(frames, fe.cw, fe.sw, fe.fb,
                                             floor, plan)),
        "call_ms": call_ms(lambda: log_mel_frames(frames, fe.cw, fe.sw,
                                                  fe.fb, floor, plan)),
        "plain_ms": time_ms(lambda: log_mel_frames_plain(
            frames, fe.cw, fe.sw, fe.fb, floor)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library), "library_max_abs_err": lib_err,
        "shape": f"frames {list(frames.shape)} f32 ({B} x {t_pad}, "
                 f"{n_frames} valid) -> [{n}, {n_mels}]",
        "gflop": fft_flops / 1e9,
        "bound_all_samples_ms": all_ms,
        "dense_dft_gflop": dft_flops / 1e9, "dense_dft_bound_ms": dft_ms,
    }


def _flash_inputs(dev, B, T, H, D, n_valid, seed, n=3):
    """n seeded bf16 [B, T, H, D] tensors and the key mask of ``n_valid``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn(B, T, H, D, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(n)]
    nv = torch.tensor(n_valid, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < nv[:, None]
    return xs, mask, nv


def _check_fwd(label, q, k, v, mask, o, lse):
    """K2's (o, lse) against ``flash_attention_plain`` on the same inputs:
    per element within TOL_K2_ABS + TOL_K2_REL |o_ref|, lse within
    TOL_K2_LSE on live rows, and on a fully masked row lse exactly +1e30
    and o exactly 0. Returns (max abs err of o, its largest share of the
    tolerance, max abs err of lse)."""
    import torch
    from omnilingual_asr_torch.ops.attention import flash_attention_plain

    o_ref, lse_ref = flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    diff = (o.float() - o_ref.float()).abs()
    err = float(diff.max())
    # Largest share of its own tolerance that any element uses (<= 1 passes).
    tol_share = float((diff / (TOL_K2_ABS + TOL_K2_REL
                               * o_ref.float().abs())).max())
    live = lse_ref < 1e29
    lse_err = float((lse - lse_ref)[live].abs().max())
    dead_row = ~mask.any(dim=1)
    dead_ok = bool((lse[~live] == 1e30).all()) and bool(
        (o[dead_row].float() == 0).all())
    if (tol_share > 1.0 or lse_err > TOL_K2_LSE or not dead_ok
            or not bool(torch.isfinite(o.float()).all())):
        raise PhaseError(f"K2 flash attention {label}: o err {err:.3e} uses "
                         f"{tol_share:.2f} of its tolerance, lse err "
                         f"{lse_err:.3e} (tol {TOL_K2_LSE}), masked rows ok: "
                         f"{dead_ok}")
    return err, tol_share, lse_err


def _k2_case(dev, peaks, B, T, H, D, n_valid, seed):
    import torch
    import torch.nn.functional as F
    from omnilingual_asr_torch.ops.attention import (flash_attention,
                                                     flash_attention_plain)

    (q, k, v), mask, n_valid_t = _flash_inputs(dev, B, T, H, D, n_valid,
                                               seed)
    o, lse = flash_attention(q, k, v, mask)
    err, tol_share, lse_err = _check_fwd(f"{[B, T, H, D]}", q, k, v, mask,
                                         o, lse)
    # Yardstick: scaled_dot_product_attention with the same key mask (its
    # fully-masked slot is not comparable and is not checked).
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    amask = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)

    # Work this run's data needs: every query row against its valid keys.
    flops = 4 * H * D * T * int(n_valid_t.sum())
    b_ms, b_by = bound({"bf16": flops},
                       nbytes(q, k, v, mask.to(torch.int32), o, lse), peaks)
    return {
        "D": D, "max_abs_err": err, "lse_max_abs_err": lse_err,
        "tol": f"{TOL_K2_ABS} + {TOL_K2_REL} |o|, max share {tol_share:.3f}",
        "ms": time_ms(lambda: flash_attention(q, k, v, mask)),
        "call_ms": call_ms(lambda: flash_attention(q, k, v, mask)),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, mask)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library),
        "shape": f"q/k/v [{B}, {T}, {H}, {D}] bf16, valid keys {n_valid}",
        "gflop": flops / 1e9,
    }


def check_k2(dev, peaks, cfg):
    """K2 at the serving path's shape (the release: head dim 64), and under
    "head_dims" also at large_config's head dim 128 (8 heads of 128), at
    the training path's shape (batch 16 of 8 s windows: T' 256, 8 heads of
    64), at the d512 seed's serving batch (T' 768, 8 heads of 64), at
    eval.synth's 10 s windows (T' 256, the release's heads) and at
    eval.latency's batch 1 (T' 768, 8 heads of 64). Rows whole, ragged
    (partial last key tile), short (whole key tiles masked) and a padded
    batch slot (every key masked). Then the mesh paths' shapes
    (card_cases.K2_MESH_SHAPES)."""
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.ops.card_cases import (FLASH_TRAIN_MESH_SHAPES,
                                                      K2_MESH_SHAPES)

    H = cfg.encoder.n_heads
    main = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 768, H,
                    cfg.encoder.d_model // H, [768, 700, 300, 0], SEED + 1)
    wide = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 768, 8, 128,
                    [768, 700, 300, 0], SEED + 11)
    enc = PipelineConfig().encoder
    train = _k2_case(dev, peaks, TRAIN_BATCH, 256, enc.n_heads,
                     enc.head_dim, TRAIN_VALID_KEYS, SEED + 14)
    # T not a multiple of the 64-key tile, a partly masked row and a fully
    # masked slot: the tiles' zero-filled edges.
    ragged = _k2_case(dev, peaks, 3, 200, 4, 64, [200, 130, 0], SEED + 15)
    d512 = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 768, 8, 64,
                    [768, 700, 300, 0], SEED + 18)
    # eval.synth's batch of 10 s windows at the release width (T' 256: one
    # window whole, three ragged or padded) and eval.latency's flagship
    # d512 x 12 at batch 1 (749 of 768 frames valid).
    eval10 = _k2_case(dev, peaks, WINDOWS_PER_BATCH, 256, H,
                      cfg.encoder.d_model // H, [249, 200, 77, 0],
                      SEED + 22)
    lat = _k2_case(dev, peaks, 1, 768, enc.n_heads, enc.head_dim, [749],
                   SEED + 23)
    # The mesh paths' (card_cases.K2_MESH_SHAPES): a data shard's batch of
    # 2 windows, and one model shard's heads at model 2 and 4.
    # Training over a mesh (phase 4l): one shard's heads of a (2, 2)
    # mesh's data row and of a (1, 4) mesh's batch.
    mesh = [_k2_case(dev, peaks, B, T, Hm, Dm, list(valid), SEED + 70 + i)
            for i, (B, T, Hm, Dm, valid) in enumerate(
                [*K2_MESH_SHAPES.values(),
                 *FLASH_TRAIN_MESH_SHAPES.values()])]
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/attention.cu",
            "replaces": "omnilingual_asr_tpu/ops/attention.py:34",
            **main, "head_dims": [main, wide, train, ragged, d512, eval10,
                                  lat, *mesh]}


def _bwd_case(dev, peaks, B, T, H, D, n_valid, seed):
    """K6 and K7 on one shape against their plain versions; SDPA's
    backward (forward outside the timed region) as the pair's yardstick."""
    import torch
    import torch.nn.functional as F
    from omnilingual_asr_torch.ops import attention as A

    (q, k, v, do), mask, nv = _flash_inputs(dev, B, T, H, D, n_valid, seed,
                                            n=4)
    o, lse = A.flash_attention(q, k, v, mask)
    # K6 and K7 read K2's lse: hold it (and o) to the plain forward first.
    fwd = _check_fwd(f"{[B, T, H, D]} (backward's inputs)", q, k, v, mask,
                     o, lse)
    delta = A.flash_delta(o, do)
    args = (q, k, v, mask, do, lse, delta)
    dq = A.flash_attention_bwd_dq(*args)
    dk, dv = A.flash_attention_bwd_dkv(*args)
    dq_ref = A.flash_attention_bwd_dq_plain(*args)
    dk_ref, dv_ref = A.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    out = {}
    dead_key, dead_row = ~mask, ~mask.any(dim=1)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        share = float((diff / (TOL_BWD_ABS * w.abs().max()
                               + TOL_BWD_REL * w.abs())).max())
        zeros_ok = (bool((got[dead_row] == 0).all()) if name == "dq"
                    else bool((got[dead_key] == 0).all()))
        if share > 1.0 or not zeros_ok or not bool(torch.isfinite(g).all()):
            raise PhaseError(f"{name} D={D}: max abs err "
                             f"{float(diff.max()):.3e} uses {share:.2f} of "
                             f"its tolerance; masked entries exactly 0: "
                             f"{zeros_ok}")
        out[name] = (float(diff.max()), share)

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    amask = mask[:, None, None, :]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)

    def library():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    try:
        lib_ms = time_ms(library, stream=stream)
    except RuntimeError as e:     # the yardstick only; the port never calls it
        log(f"  SDPA backward could not be timed in a CUDA graph ({e}); "
            f"library_ms null")
        lib_ms = None
    work = H * T * D * int(nv.sum())
    io = nbytes(q, k, v, do, mask.to(torch.int32), lse, delta)
    b6 = bound({"bf16": 6 * work}, io + nbytes(dq), peaks)
    b7 = bound({"bf16": 8 * work}, io + nbytes(dk, dv), peaks)
    shape = f"q/k/v/dO [{B}, {T}, {H}, {D}] bf16, valid keys {n_valid}"
    k6 = {"D": D, "max_abs_err": out["dq"][0],
          "k2_o_max_abs_err": fwd[0], "k2_lse_max_abs_err": fwd[2],
          "tol": f"{TOL_BWD_ABS} max|ref| + {TOL_BWD_REL} |ref|, max share "
                 f"{out['dq'][1]:.3f}",
          "ms": time_ms(lambda: A.flash_attention_bwd_dq(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dq(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dq_plain(*args)),
          "bound_ms": b6[0], "bound_by": b6[1], "library_ms": lib_ms,
          "library": "SDPA backward (dQ, dK, dV together), forward "
                     "outside the timed region",
          "shape": shape, "gflop": 6 * work / 1e9}
    k7 = {"D": D, "max_abs_err": max(out["dk"][0], out["dv"][0]),
          "tol": f"{TOL_BWD_ABS} max|ref| + {TOL_BWD_REL} |ref|, max share "
                 f"dk {out['dk'][1]:.3f}, dv {out['dv'][1]:.3f}",
          "ms": time_ms(lambda: A.flash_attention_bwd_dkv(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dkv(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dkv_plain(
              *args)),
          "bound_ms": b7[0], "bound_by": b7[1], "library_ms": None,
          "shape": shape, "gflop": 8 * work / 1e9}
    return k6, k7


def check_flash_bwd(dev, peaks, cfg):
    """K6 and K7 at the training path's shape (batch 16 of 8 s windows:
    T' 256, 8 heads of 64; rows whole, ragged, short and one padded slot)
    and, under "head_dims", at large_config's (B 4, T 768, 8 heads of 128)
    and at a T of 200 (a partial last tile of queries and keys, a partly
    masked row and a fully masked slot)."""
    from omnilingual_asr_torch.ops.card_cases import FLASH_TRAIN_MESH_SHAPES

    enc = cfg.encoder
    train = _bwd_case(dev, peaks, TRAIN_BATCH, 256, enc.n_heads,
                      enc.head_dim, TRAIN_VALID_KEYS, SEED + 21)
    wide = _bwd_case(dev, peaks, WINDOWS_PER_BATCH, 768, 8, 128,
                     [768, 700, 300, 0], SEED + 22)
    ragged = _bwd_case(dev, peaks, 3, 200, 4, 64, [200, 130, 0], SEED + 23)
    # Training over a mesh (phase 4l): one shard's heads.
    mesh = [_bwd_case(dev, peaks, B, T, H, D, list(valid), SEED + 80 + i)
            for i, (B, T, H, D, valid) in enumerate(
                FLASH_TRAIN_MESH_SHAPES.values())]
    entries = []
    for i, (name, line) in enumerate((
            ("flash_attention_bwd_dq", 79), ("flash_attention_bwd_dkv", 110))):
        entries.append({
            "name": name, "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/attention_bwd.cu",
            "replaces": f"omnilingual_asr_tpu/ops/attention.py:{line}",
            **train[i], "head_dims": [train[i], wide[i], ragged[i],
                                      *[m[i] for m in mesh]]})
    return entries


def _f32_flash_case(dev, peaks, B, T, H, D, valid, seed):
    """The f32 variants of K2, K6 and K7 on one shape against their plain
    versions (``card_cases.TOL_F32_FLASH`` / ``TOL_F32_LSE``; masked keys
    and fully-masked rows exactly 0), each timed beside its plain version,
    SDPA at f32 (the forward for K2, its backward for the pair) and its
    bound at the rate their design uses, three TF32 tensor-core products a
    product (3xTF32), with the f32 FMA-rate bound of the earlier designs
    beside it under ``bound_fma_ms``. Returns (K2, K6, K7) entries."""
    import torch
    import torch.nn.functional as F
    from omnilingual_asr_torch.ops import attention as A
    from omnilingual_asr_torch.ops.card_cases import (TOL_F32_FLASH,
                                                      TOL_F32_LSE)

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev)
                   for _ in range(4))
    nv = torch.tensor(valid, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < nv[:, None]
    o, lse = A.flash_attention_f32(q, k, v, mask)
    o_ref, lse_ref = A.flash_attention_plain(q, k, v, mask)
    delta = A.flash_delta(o_ref, do)
    args = (q, k, v, mask, do, lse_ref, delta)
    dq = A.flash_attention_bwd_dq_f32(*args)
    dk, dv = A.flash_attention_bwd_dkv_f32(*args)
    dq_ref = A.flash_attention_bwd_dq_plain(*args)
    dk_ref, dv_ref = A.flash_attention_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    label = f"{[B, T, H, D]} f32"
    errs = {}
    for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref),
                            ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        errs[name] = err
        if (not bool(torch.isfinite(got).all()) or got.dtype != torch.float32
                or err > TOL_F32_FLASH * scale):
            raise PhaseError(f"f32 flash {label}: {name} max abs err "
                             f"{err:.3e} > {TOL_F32_FLASH} x {scale:.3e}")
    live = lse_ref < 1e29
    lse_err = float((lse - lse_ref)[live].abs().max())
    dead_row, dead_key = ~mask.any(dim=1), ~mask
    zeros = (bool((lse[~live] == 1e30).all())
             and bool((o[dead_row] == 0).all())
             and bool((dq[dead_row] == 0).all())
             and bool((dk[dead_key] == 0).all())
             and bool((dv[dead_key] == 0).all()))
    if lse_err > TOL_F32_LSE or not zeros:
        raise PhaseError(f"f32 flash {label}: lse err {lse_err:.3e} (tol "
                         f"{TOL_F32_LSE}), masked entries exactly 0: {zeros}")

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    amask = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)

    ql, kl, vl = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=amask)

    def sdpa_bwd():
        return torch.autograd.grad(ol, (ql, kl, vl), do.transpose(1, 2),
                                   retain_graph=True)

    try:
        bwd_lib = time_ms(sdpa_bwd, stream=stream)
    except RuntimeError as e:     # the yardstick only; the port never calls it
        log(f"  SDPA f32 backward could not be timed in a CUDA graph ({e}); "
            f"library_ms null")
        bwd_lib = None
    work = H * T * D * int(nv.sum())
    m32 = mask.to(torch.int32)
    io = nbytes(q, k, v, do, m32, lse, delta)
    b2 = bound({"tf32": 3 * 4 * work}, nbytes(q, k, v, m32, o, lse), peaks)
    fma2 = bound({"f32": 4 * work}, nbytes(q, k, v, m32, o, lse), peaks)[0]
    b6 = bound({"tf32": 3 * 6 * work}, io + nbytes(dq), peaks)
    b7 = bound({"tf32": 3 * 8 * work}, io + nbytes(dk, dv), peaks)
    fma6 = bound({"f32": 6 * work}, io + nbytes(dq), peaks)[0]
    fma7 = bound({"f32": 8 * work}, io + nbytes(dk, dv), peaks)[0]
    shape = f"q/k/v [{B}, {T}, {H}, {D}] f32, valid keys {valid}"
    tol = f"{TOL_F32_FLASH} max|ref| per element"
    k2 = {"D": D, "max_abs_err": errs["o"], "lse_max_abs_err": lse_err,
          "tol": tol + f", lse {TOL_F32_LSE}",
          "ms": time_ms(lambda: A.flash_attention_f32(q, k, v, mask)),
          "call_ms": call_ms(lambda: A.flash_attention_f32(q, k, v, mask)),
          "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v,
                                                              mask)),
          "bound_ms": b2[0], "bound_by": b2[1], "bound_fma_ms": fma2,
          "library_ms": time_ms(sdpa),
          "library": "SDPA forward at f32", "shape": shape,
          "gflop": 4 * work / 1e9}
    k6 = {"D": D, "max_abs_err": errs["dq"], "tol": tol,
          "ms": time_ms(lambda: A.flash_attention_bwd_dq_f32(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dq_f32(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dq_plain(*args)),
          "bound_ms": b6[0], "bound_by": b6[1], "bound_fma_ms": fma6,
          "library_ms": bwd_lib,
          "library": "SDPA backward at f32 (dQ, dK, dV together), forward "
                     "outside the timed region",
          "shape": shape, "gflop": 6 * work / 1e9}
    k7 = {"D": D, "max_abs_err": max(errs["dk"], errs["dv"]), "tol": tol,
          "ms": time_ms(lambda: A.flash_attention_bwd_dkv_f32(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dkv_f32(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dkv_plain(
              *args)),
          "bound_ms": b7[0], "bound_by": b7[1], "bound_fma_ms": fma7,
          "library_ms": None, "shape": shape, "gflop": 8 * work / 1e9}
    return k2, k6, k7


# The designs of the f32 kernels (csrc/attention_f32.cu), and the bound
# each entry's bound_ms reckons at.
F32_DESIGNS = {
    "flash_attention_fwd_f32": ("3xTF32 mma.sync", "3 x ops at 495 "
                                "TFLOP/s tf32 or bytes at 3.35 TB/s"),
    "flash_attention_bwd_dq_f32": ("3xTF32 mma.sync", "3 x ops at 495 "
                                   "TFLOP/s tf32 or bytes at 3.35 TB/s"),
    "flash_attention_bwd_dkv_f32": ("3xTF32 mma.sync", "3 x ops at 495 "
                                    "TFLOP/s tf32 or bytes at 3.35 TB/s")}


def check_flash_f32(dev, peaks, ptxas):
    """The f32 variants of K2, K6 and K7 (``csrc/attention_f32.cu``, the
    f32 encoder's attention) at ``card_cases.F32_FLASH_SHAPES``: K2's
    entry at the release's f32 serving batch, K6's and K7's at the f32
    training step's shape, every shape under "head_dims"; each with its
    kernel's registers and spills."""
    from omnilingual_asr_torch.ops.card_cases import F32_FLASH_SHAPES

    cases = {}
    for i, (name, (B, T, H, D, valid)) in enumerate(
            F32_FLASH_SHAPES.items()):
        cases[name] = [dict(c, case=name) for c in _f32_flash_case(
            dev, peaks, B, T, H, D, list(valid), SEED + 90 + i)]
    out = []
    for i, (name, line, main) in enumerate((
            ("flash_attention_fwd_f32", 34, "serving"),
            ("flash_attention_bwd_dq_f32", 79, "training"),
            ("flash_attention_bwd_dkv_f32", 110, "training"))):
        design, bound_at = F32_DESIGNS[name]
        kernel = {"flash_attention_fwd_f32": "flash_fwd_tf32_kernel",
                  "flash_attention_bwd_dq_f32": "flash_bwd_dq_tf32_kernel",
                  "flash_attention_bwd_dkv_f32": "flash_bwd_dkv_tf32_kernel"
                  }[name]
        out.append({"name": name, "route": "cuda",
                    "source": "omnilingual_asr_torch/csrc/attention_f32.cu",
                    "replaces": f"omnilingual_asr_tpu/ops/attention.py:{line}",
                    "design": design, "bound_at": bound_at,
                    **cases[main][i],
                    "head_dims": [c[i] for c in cases.values()],
                    "ptxas": {k: v for k, v in ptxas.items()
                              if k.startswith(kernel)}})
    return out


def _f16_flash_case(dev, peaks, B, T, H, D, valid, seed):
    """The f16 variants of K2, K6 and K7 on one shape against their plain
    versions (``card_cases.TOL_F16_*``; masked keys and fully-masked rows
    exactly 0), K6 and K7 again at dO times ``F16_TINY_DO`` (gradients
    under f16's normal range, where a flushed dS shows) and times
    ``F16_LARGE_DO`` (where a fixed scale of dS would pass 65504), each
    timed beside its plain version, SDPA at f16 (the forward for K2, its
    backward for the pair) and its bound at the f16 tensor-core rate.
    Returns (K2, K6, K7) entries."""
    import torch
    import torch.nn.functional as F
    from omnilingual_asr_torch.ops import attention as A
    from omnilingual_asr_torch.ops.card_cases import (F16_LARGE_DO,
                                                      F16_TINY_DO,
                                                      TOL_F16_LSE, f16_share)

    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device=dev).half()
                   for _ in range(4))
    nv = torch.tensor(valid, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < nv[:, None]
    o, lse = A.flash_attention_f16(q, k, v, mask)
    o_ref, lse_ref = A.flash_attention_plain(q, k, v, mask)
    label = f"{[B, T, H, D]} f16"
    shares, errs, args_at = {}, {}, {}
    scaled = {F16_TINY_DO: {}, F16_LARGE_DO: {}}   # dO x scale: name -> err
    for scale in (1.0, F16_TINY_DO, F16_LARGE_DO):
        d = do if scale == 1.0 else (do.float() * scale).half()
        args = args_at[scale] = (q, k, v, mask, d, lse_ref,
                                 A.flash_delta(o_ref, d))
        dq = A.flash_attention_bwd_dq_f16(*args)
        dk, dv = A.flash_attention_bwd_dkv_f16(*args)
        dq_ref = A.flash_attention_bwd_dq_plain(*args)
        dk_ref, dv_ref = A.flash_attention_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        pairs = [("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)]
        if scale == 1.0:
            pairs.insert(0, ("o", o, o_ref))
        for name, got, want in pairs:
            share = f16_share(got, want, sub=scale < 1.0)
            err = float((got.float() - want.float()).abs().max())
            if (not bool(torch.isfinite(got.float()).all())
                    or got.dtype != torch.float16 or share > 1.0):
                raise PhaseError(f"f16 flash {label}: {name} at dO x {scale}"
                                 f" max abs err {err:.3e} uses {share:.2f} "
                                 f"of its tolerance")
            if scale == 1.0:
                shares[name], errs[name] = share, err
            else:
                scaled[scale][name] = {"max_abs_err": err, "max_ref": float(
                    want.float().abs().max()), "share": share}
        dead_row, dead_key = ~mask.any(dim=1), ~mask
        zeros = (bool((dq[dead_row] == 0).all())
                 and bool((dk[dead_key] == 0).all())
                 and bool((dv[dead_key] == 0).all()))
        if not zeros:
            raise PhaseError(f"f16 flash {label}: masked gradients at dO x "
                             f"{scale} not exactly 0")
    live = lse_ref < 1e29
    lse_err = float((lse - lse_ref)[live].abs().max())
    zeros = (bool((lse[~live] == 1e30).all())
             and bool((o[~mask.any(dim=1)] == 0).all()))
    if lse_err > TOL_F16_LSE or not zeros:
        raise PhaseError(f"f16 flash {label}: lse err {lse_err:.3e} (tol "
                         f"{TOL_F16_LSE}), masked rows exactly 0: {zeros}")

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    amask = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)

    ql, kl, vl = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ol = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=amask)

    def sdpa_bwd():
        return torch.autograd.grad(ol, (ql, kl, vl), do.transpose(1, 2),
                                   retain_graph=True)

    try:
        bwd_lib = time_ms(sdpa_bwd, stream=stream)
    except RuntimeError as e:     # the yardstick only; the port never calls it
        log(f"  SDPA f16 backward could not be timed in a CUDA graph ({e}); "
            f"library_ms null")
        bwd_lib = None
    args = args_at[1.0]
    work = H * T * D * int(nv.sum())
    m32 = mask.to(torch.int32)
    io = nbytes(q, k, v, do, m32, lse, args[-1])
    b2 = bound({"f16": 4 * work}, nbytes(q, k, v, m32, o, lse), peaks)
    b6 = bound({"f16": 6 * work}, io + nbytes(q), peaks)
    b7 = bound({"f16": 8 * work}, io + nbytes(k, v), peaks)
    shape = f"q/k/v [{B}, {T}, {H}, {D}] f16, valid keys {valid}"
    tol = ("TOL_F16_ABS max|ref| + TOL_F16_REL |ref| (+ TOL_F16_SUB at dO x "
           "F16_TINY_DO; K6, K7 also at dO x F16_LARGE_DO), max share")
    k2 = {"D": D, "max_abs_err": errs["o"], "lse_max_abs_err": lse_err,
          "tol": f"{tol} {shares['o']:.3f}, lse {TOL_F16_LSE}",
          "ms": time_ms(lambda: A.flash_attention_f16(q, k, v, mask)),
          "call_ms": call_ms(lambda: A.flash_attention_f16(q, k, v, mask)),
          "plain_ms": time_ms(lambda: A.flash_attention_plain(q, k, v,
                                                              mask)),
          "bound_ms": b2[0], "bound_by": b2[1],
          "library_ms": time_ms(sdpa),
          "library": "SDPA forward at f16", "shape": shape,
          "gflop": 4 * work / 1e9}
    k6 = {"D": D, "max_abs_err": errs["dq"],
          "tol": f"{tol} {shares['dq']:.3f}",
          "tiny_do": scaled[F16_TINY_DO]["dq"],
          "large_do": scaled[F16_LARGE_DO]["dq"],
          "ms": time_ms(lambda: A.flash_attention_bwd_dq_f16(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dq_f16(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dq_plain(*args)),
          "bound_ms": b6[0], "bound_by": b6[1], "library_ms": bwd_lib,
          "library": "SDPA backward at f16 (dQ, dK, dV together), forward "
                     "outside the timed region",
          "shape": shape, "gflop": 6 * work / 1e9}
    k7 = {"D": D, "max_abs_err": max(errs["dk"], errs["dv"]),
          "tol": f"{tol} dk {shares['dk']:.3f}, dv {shares['dv']:.3f}",
          "tiny_do": {n: scaled[F16_TINY_DO][n] for n in ("dk", "dv")},
          "large_do": {n: scaled[F16_LARGE_DO][n] for n in ("dk", "dv")},
          "ms": time_ms(lambda: A.flash_attention_bwd_dkv_f16(*args)),
          "call_ms": call_ms(lambda: A.flash_attention_bwd_dkv_f16(*args)),
          "plain_ms": time_ms(lambda: A.flash_attention_bwd_dkv_plain(
              *args)),
          "bound_ms": b7[0], "bound_by": b7[1], "library_ms": None,
          "shape": shape, "gflop": 8 * work / 1e9}
    return k2, k6, k7


#: Each f16 flash kernel's design and, where it replaced an earlier one,
#: that design's registers and spill stores (nvcc -Xptxas -v, sm_90a,
#: recorded on an H100, not measured in this run).
F16_DESIGNS = {
    "flash_attention_fwd_f16": (
        "a 64-query tile a block, one warpgroup (two splitting the key "
        "tiles on grids of up to 264 blocks at D 64); Q, K, V by TMA "
        "(128-byte-swizzled boxes, a ring of K/V stages on mbarriers); S = "
        "Q K^T on f16 wgmma from shared memory, P x 2^14 (the scale in "
        "exp2's argument) split as f16 hi + lo against V native, two f16 "
        "wgmma a 16-key step with P from registers (m64n128k16 at D 128)",
        "the bf16 K2 templated, f16 mma.sync for S, V of P V split into "
        "bf16 hi + lo against P as bf16 hi + lo (three bf16 products): 128 "
        "registers at D 64, 8 bytes of spill stores; 168 at D 128, 44"),
    "flash_attention_bwd_dq_f16": (
        "f16 mma.sync for every product: S and dP over the f16 operands, "
        "dS K with K native against dS split as f16 hi + lo under a "
        "running power-of-two exponent a query row (two f16 products)",
        "K split into bf16 hi + lo, three bf16 products: 128 "
        "registers at D 64, 12 bytes of spill stores; 168 at D 128, 16"),
    "flash_attention_bwd_dkv_f16": (
        "f16 mma.sync for every product: S^T and dP^T over the f16 "
        "operands, P^T dO and dS^T Q with dO and Q native against P x 2^14 "
        "and dS under a running power-of-two exponent a key row, each "
        "split as f16 hi + lo (two f16 products)",
        "dO and Q split into bf16 hi + lo, three bf16 products: "
        "128 registers at D 64, 60 bytes of spill stores; 255 at D 128, "
        "100")}


def check_flash_f16(dev, peaks, ptxas):
    """The f16 variants of K2, K6 and K7 (``csrc/attention_f16.cu``, on
    wgmma and TMA, and ``csrc/attention_bwd.cu`` over f16 operands, the
    f16 encoder's attention) at ``card_cases.F16_FLASH_SHAPES``: K2's
    entry at the release's f16 serving batch, K6's and K7's at the f16
    training step's shape, every shape under "head_dims"; each with its
    kernel's registers and spills beside its earlier design's."""
    from omnilingual_asr_torch.ops.card_cases import F16_FLASH_SHAPES

    cases = {}
    for i, (name, (B, T, H, D, valid)) in enumerate(
            F16_FLASH_SHAPES.items()):
        cases[name] = [dict(c, case=name) for c in _f16_flash_case(
            dev, peaks, B, T, H, D, list(valid), SEED + 110 + i)]
    out = []
    # K2's kernel is f16 only; K6's and K7's names end in "true>" at f16.
    for i, (name, line, main, src, kernel) in enumerate((
            ("flash_attention_fwd_f16", 34, "serving", "attention_f16.cu",
             "flash_fwd_f16_kernel<"),
            ("flash_attention_bwd_dq_f16", 79, "training",
             "attention_bwd.cu", "flash_bwd_dq_kernel<"),
            ("flash_attention_bwd_dkv_f16", 110, "training",
             "attention_bwd.cu", "flash_bwd_dkv_kernel<"))):
        design, earlier = F16_DESIGNS[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"omnilingual_asr_torch/csrc/{src}",
                    "replaces": f"omnilingual_asr_tpu/ops/attention.py:{line}",
                    "design": design,
                    "bound_at": "ops at 989 TFLOP/s f16 or bytes at "
                                "3.35 TB/s",
                    **cases[main][i],
                    "head_dims": [c[i] for c in cases.values()],
                    "ptxas": {k: v for k, v in ptxas.items()
                              if k.startswith(kernel) and (
                                  i == 0 or k.endswith("true>"))},
                    **({"ptxas_earlier": earlier} if earlier else {})})
    return out


def check_k3(dev, peaks, cfg, params, ptxas):
    """K3 at the serving path's shape with the release weights, and at the
    training path's (batch 16, T' 256, D 512, random weights),
    large_config's width ([4, 256, 1024], random weights) and the d512
    seed's serving batch ([4, 768, 512], its block 0 weights),
    eval.synth's 10 s windows ([4, 256, 256], release weights) and
    eval.latency's batch 1 ([1, 768, 512], random weights) under
    "shapes"; each with its launch plan (blocks of each stage, rows pw1
    runs over per output frame). The shapes are card_cases.K3_SHAPES; then
    a data shard's batch and K3 split over a model axis
    (card_cases.K3_SPLIT_SHAPES) against its plain split and against
    whole K3."""
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.models.layers import convmod_init
    from omnilingual_asr_torch.ops.card_cases import (K3_SHAPES,
                                                      K3_SPLIT_SHAPES)

    p = params["blocks"][0]["conv"]          # release weights
    main = _k3_case(dev, peaks, K3_SHAPES["serving"], p, SEED + 2)
    enc = PipelineConfig().encoder
    pt = convmod_init(torch.Generator().manual_seed(SEED),
                      enc.d_model, enc.conv_kernel)
    pt = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
              else v.to(dev)) for k, v in pt.items()}
    train = _k3_case(dev, peaks, K3_SHAPES["training"], pt, SEED + 12)
    # large_config's width (d_model 1024), which a kernel-mode training run
    # at that width launches.
    pw = convmod_init(torch.Generator().manual_seed(SEED + 1), 1024,
                      enc.conv_kernel)
    pw = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
              else v.to(dev)) for k, v in pw.items()}
    wide = _k3_case(dev, peaks, K3_SHAPES["d1024"], pw, SEED + 16)
    from omnilingual_asr_torch.config import config_for_checkpoint
    from omnilingual_asr_torch.models.zoo import load_checkpoint

    p512 = load_checkpoint(D512, config_for_checkpoint(str(D512)),
                           dev)["blocks"][0]["conv"]
    d512 = _k3_case(dev, peaks, K3_SHAPES["d512"], p512, SEED + 19)
    # eval.synth's 10 s windows (release weights) and eval.latency's
    # flagship at batch 1 (seeded random weights, as that driver's).
    eval10 = _k3_case(dev, peaks, K3_SHAPES["eval10s"], p, SEED + 24)
    lat = _k3_case(dev, peaks, K3_SHAPES["latency"], pt, SEED + 25)
    # A data shard's batch of the mesh's data-parallel windows (release).
    shard = _k3_case(dev, peaks, K3_SHAPES["dp_shard"], p, SEED + 26)
    # Split over the shards of a model axis: the release's serving batch at
    # model 2 and 4 and the d512 seed's (card_cases.K3_SPLIT_SHAPES).
    # Training over a mesh at PipelineConfig()'s width (phase 4l): random
    # d512 weights.
    split = [_k3_split_case(dev, peaks, K3_SPLIT_SHAPES[name],
                            p512 if name.startswith("d512")
                            else pt if name.startswith("train") else p,
                            SEED + 27 + i)
             for i, name in enumerate(K3_SPLIT_SHAPES)]
    return {"name": "conv_module", "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/conv_module.cu",
            "replaces": "omnilingual_asr_tpu/ops/conv_module.py:32",
            **main, "shapes": [main, train, wide, d512, eval10, lat, shard,
                               *split],
            "ptxas": {k: v for k, v in ptxas.items()
                      if k.startswith(("conv_stage1_kernel",
                                       "conv_stage2_kernel",
                                       "conv_split_finish_kernel"))}}


def _k3_case(dev, peaks, shape, p, seed):
    import torch
    from omnilingual_asr_torch.ops import cuda_build
    from omnilingual_asr_torch.ops.card_cases import TOL_K3
    from omnilingual_asr_torch.ops.conv_module import (conv_module_plain,
                                                       fused_conv_module)

    B, T, D, valid = shape
    if p["dw"].shape[1] != D:
        raise PhaseError(f"K3: weights of width {p['dw'].shape[1]} for a "
                         f"case of width {D}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, D, generator=gen, device=dev)
    n_valid = torch.tensor(valid, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < n_valid[:, None]
    # pw1/pw2 in bf16, as the engine holds them for the kernel.
    pw1, pw2 = (p[k]["w"].to(torch.bfloat16) for k in ("pw1", "pw2"))
    args = (x, mask, p["ln"]["scale"], p["ln"]["bias"], pw1, p["dw"],
            p["dw_ln"]["scale"], p["dw_ln"]["bias"], pw2)
    got = fused_conv_module(*args)
    want = conv_module_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > TOL_K3:
        raise PhaseError(f"K3 conv module D={D}: max abs err {err:.3e} > "
                         f"{TOL_K3}")
    K = p["dw"].shape[0]
    plan = cuda_build.plan("omni_conv_module_plan", B, T, D)
    pw_flops = 2 * B * T * D * (2 * D + D)
    dw_flops = 2 * B * T * D * K
    b_ms, b_by = bound({"bf16": pw_flops, "f32": dw_flops},
                       nbytes(x, mask, got, pw1, pw2, p["dw"]) + 4 * 4 * D,
                       peaks)
    return {
        "D": D, "max_abs_err": err, "tol": TOL_K3,
        "mean_abs_err": float((got - want).abs().mean()),
        "ms": time_ms(lambda: fused_conv_module(*args)),
        "call_ms": call_ms(lambda: fused_conv_module(*args)),
        "plain_ms": time_ms(lambda: conv_module_plain(*args)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"x [{B}, {T}, {D}] f32, K {K}",
        "gflop": (pw_flops + dw_flops) / 1e9,
        "plan": {"stage1_blocks": plan[0], "stage2_blocks": plan[3],
                 "frames_a_block": plan[2],
                 "rows_per_frame": plan[1] / plan[2]},
    }


def _k3_split_case(dev, peaks, shape, p, seed):
    """K3 split over n shards of D / n channels (tensor parallelism: each
    shard's pw1 value and gate columns, taps and pw2 rows, as
    ``layers.convmod_spec`` places them) against the plain split
    (``conv_module_split_plain``, TOL_K3) and against whole K3 on the same
    weights (TOL_K3). Timed as the whole split call: every shard's three
    launches, the statistics' exchange and the sum over the shards."""
    import torch
    from omnilingual_asr_torch.ops.card_cases import TOL_K3
    from omnilingual_asr_torch.ops.conv_module import (
        conv_module_split_plain, fused_conv_module, fused_conv_module_split)
    from omnilingual_asr_torch.parallel.mesh import Split, split_block

    B, T, D, n, valid = shape
    if p["dw"].shape[1] != D:
        raise PhaseError(f"split K3: weights of width {p['dw'].shape[1]} "
                         f"for a case of width {D}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, D, generator=gen, device=dev)
    n_valid = torch.tensor(valid, device=dev)
    mask = torch.arange(T, device=dev)[None, :] < n_valid[:, None]
    pw1, pw2 = (p[k]["w"].to(torch.bfloat16) for k in ("pw1", "pw2"))

    def blocks(t, spec):
        return [split_block(t, spec, m, n).contiguous() for m in range(n)]

    args = ([x] * n, [mask] * n, [p["ln"]["scale"]] * n,
            [p["ln"]["bias"]] * n, blocks(pw1, Split("model", 1, 2)),
            blocks(p["dw"], Split("model", 1)), [p["dw_ln"]["scale"]] * n,
            [p["dw_ln"]["bias"]] * n, blocks(pw2, Split("model", 0)))
    got = fused_conv_module_split(*args)[0]
    want = conv_module_split_plain(*args)[0]
    whole = fused_conv_module(x, mask, p["ln"]["scale"], p["ln"]["bias"],
                              pw1, p["dw"], p["dw_ln"]["scale"],
                              p["dw_ln"]["bias"], pw2)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    err_whole = float((got - whole).abs().max())
    if (not bool(torch.isfinite(got).all()) or err > TOL_K3
            or err_whole > TOL_K3):
        raise PhaseError(f"split K3 D={D} n={n}: max abs err {err:.3e} "
                         f"against the plain split, {err_whole:.3e} against "
                         f"whole K3 (tol {TOL_K3})")
    K = p["dw"].shape[0]
    pw_flops = 2 * B * T * D * (2 * D + D)
    dw_flops = 2 * B * T * D * K
    b_ms, b_by = bound({"bf16": pw_flops, "f32": dw_flops},
                       nbytes(x, mask, got, pw1, pw2, p["dw"]) + 4 * 4 * D,
                       peaks)
    return {
        "D": D, "shards": n, "max_abs_err": err, "tol": TOL_K3,
        "max_abs_err_vs_whole": err_whole,
        "ms": time_ms(lambda: fused_conv_module_split(*args)),
        "call_ms": call_ms(lambda: fused_conv_module_split(*args)),
        "plain_ms": time_ms(lambda: conv_module_split_plain(*args)),
        "whole_ms": time_ms(lambda: fused_conv_module(
            x, mask, p["ln"]["scale"], p["ln"]["bias"], pw1, p["dw"],
            p["dw_ln"]["scale"], p["dw_ln"]["bias"], pw2)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"x [{B}, {T}, {D}] f32 over {n} shards of {D // n} "
                 f"channels, K {K}",
        "gflop": (pw_flops + dw_flops) / 1e9,
    }


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _k5_case(dev, peaks, x, w_q, scale, bias, w_t):
    """K5 (W8A8) on x [M, K] against its plain version: bit for bit up to
    TOL_K5_REL; timed beside its plain version and the int8 GEMM alone."""
    import torch
    from omnilingual_asr_torch.ops import quant
    from omnilingual_asr_torch.ops.card_cases import TOL_K5_REL

    M, K = x.shape
    N = w_q.shape[1]
    flops = 2 * M * N * K
    n_bytes = nbytes(x, w_q, scale, bias) + M * N * 4
    got = quant.quantized_matmul_a8(x, w_q, scale, bias, w_t)
    want = quant.quantized_matmul_a8_plain(x, w_q, scale, bias)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    err = float((got - want).abs().max())
    tol5 = TOL_K5_REL * float(want.abs().max())
    if err > tol5 or not bool(torch.isfinite(got).all()):
        raise PhaseError(f"K5 W8A8 N={N}: {n_diff} elements differ, max "
                         f"abs err {err:.3e} > {tol5:.3e}")
    xq, sx = quant.quantize_rows(x)
    xq8 = xq.to(torch.int8)
    lib_ok = bool(torch.equal(
        torch._int_mm(xq8, w_t.t()).float() * sx[:, None] * scale + bias,
        want))

    def lib_a8():
        return torch._int_mm(xq8, w_t.t())

    b_ms, b_by = bound({"int8": flops}, n_bytes, peaks)
    return {
        "M": M, "N": N, "max_abs_err": err, "n_diff": n_diff,
        "tol": f"{TOL_K5_REL} max|ref| = {tol5:.3e}",
        "ms": time_ms(lambda: quant.quantized_matmul_a8(x, w_q, scale,
                                                        bias, w_t)),
        "call_ms": call_ms(lambda: quant.quantized_matmul_a8(
            x, w_q, scale, bias, w_t)),
        "plain_ms": time_ms(lambda: quant.quantized_matmul_a8_plain(
            x, w_q, scale, bias)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lib_a8),
        "library": "GEMM only: torch._int_mm on int8 activations "
                   "quantized beforehand; leaves out the per-row "
                   "quantization of x and the f32 epilogue (scales, "
                   "bias) and writes int32",
        "library_epilogue_equal": lib_ok,
    }


def check_quant(dev, peaks, params, ptxas):
    """K4 and K5 at (3072, 256, N) for the quantized main path's widths, on
    the release layers of those widths (quantized as the engine quantizes
    them) and seeded activations with an outlier row. Returns the two
    kernels' entries, their numbers at N = 1024 (8 of the 10 launches a
    batch) and every width under "widths". The shapes are
    card_cases.K4_SHAPES (K5_SHAPES is the same), K5 on K4's inputs, then
    K5 alone at a data shard's batch (card_cases.K5_DP_SHAPES)."""
    import torch
    from omnilingual_asr_torch.ops import quant
    from omnilingual_asr_torch.ops.card_cases import (K4_SHAPES,
                                                      K5_DP_SHAPES,
                                                      k4_error_share)

    out = {"w8": [], "a8": []}
    for M, K, N in K4_SHAPES.values():
        leaf = _leaf(params, QUANT_LAYERS[N])
        if tuple(leaf["w"].shape) != (K, N):
            raise PhaseError(f"K4/K5: layer {QUANT_LAYERS[N]} is "
                             f"{tuple(leaf['w'].shape)}, not {(K, N)}")
        w_q, scale = quant.quantize_weight(leaf["w"])
        w_t = w_q.t().contiguous()
        bias = leaf["b"]
        gen = torch.Generator(device=dev).manual_seed(SEED + 3 + N)
        x = torch.randn(M, K, generator=gen, device=dev)
        x[0] *= 1000.0                  # an outlier row
        x[M - 1] = 0.0                  # an all-zero row
        flops = 2 * M * N * K
        n_bytes = nbytes(x, w_q, scale, bias) + M * N * 4

        # K4: W8A16.
        got = quant.quantized_matmul(x, w_q, scale, bias, w_t)
        want = quant.quantized_matmul_plain(x, w_q, scale, bias)
        torch.cuda.synchronize()
        err, share = k4_error_share(got, want, x, w_q, scale, bias)
        if share > 1.0 or not bool(torch.isfinite(got).all()):
            raise PhaseError(f"K4 W8A16 N={N}: max abs err {err:.3e} uses "
                             f"{share:.2f} of its per-element tolerance")
        again = quant.quantized_matmul(x, w_q, scale, bias, w_t)
        if not torch.equal(got, again):
            raise PhaseError(f"K4 W8A16 N={N}: two calls on the same inputs "
                             f"differ")
        xb16, wb16 = x.to(torch.bfloat16), w_q.to(torch.bfloat16)

        def lib_w8():
            return torch.mm(xb16, wb16, out_dtype=torch.float32)

        b_ms, b_by = bound({"bf16": flops}, n_bytes, peaks)
        out["w8"].append({
            "M": M, "N": N, "max_abs_err": err,
            "tol": f"2 K 2^-24 sum|terms| scale + 2^-23 |ref|, max share "
                   f"{share:.3f}",
            "ms": time_ms(lambda: quant.quantized_matmul(x, w_q, scale,
                                                         bias, w_t)),
            "call_ms": call_ms(lambda: quant.quantized_matmul(
                x, w_q, scale, bias, w_t)),
            "plain_ms": time_ms(lambda: quant.quantized_matmul_plain(
                x, w_q, scale, bias)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib_w8),
            "library": "GEMM only: torch.mm(out_dtype=float32) on bf16 "
                       "copies made beforehand; leaves out the f32 -> bf16 "
                       "rounding of x, the int8 widening, the scale and the "
                       "bias",
        })

        # K5: W8A8.
        out["a8"].append(_k5_case(dev, peaks, x, w_q, scale, bias, w_t))

    # K5 at a data shard's batch under "a8" (card_cases.K5_DP_SHAPES).
    for M, K, N in K5_DP_SHAPES.values():
        w_q, scale = quant.quantize_weight(_leaf(params, QUANT_LAYERS[N])["w"])
        gen = torch.Generator(device=dev).manual_seed(SEED + 5 + N)
        x = torch.randn(M, K, generator=gen, device=dev)
        x[0] *= 1000.0
        x[M - 1] = 0.0
        out["a8"].append(_k5_case(dev, peaks, x, w_q, scale,
                                  _leaf(params, QUANT_LAYERS[N])["b"],
                                  w_q.t().contiguous()))

    entries = []
    for mode, name, src_line in (
            ("w8", "q_matmul_w8a16", "omnilingual_asr_tpu/ops/quant.py:41"),
            ("a8", "q8a8_matmul", "omnilingual_asr_tpu/ops/quant.py:90")):
        head = next(w for w in out[mode] if w["N"] == 1024
                    and w["M"] == 3072)
        entries.append({
            "name": name, "route": "cuda",
            "source": "omnilingual_asr_torch/csrc/quant.cu",
            "replaces": src_line,
            **{k: head[k] for k in ("max_abs_err", "tol", "ms", "call_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "ptxas": {k: v for k, v in ptxas.items()
                      if k in {"w8": ("bf16_rows_kernel", "q_matmul_kernel"),
                               "a8": ("quantize_rows_kernel",
                                      "q8a8_matmul_kernel")}[mode]},
            "shape": f"x [{head['M']}, {K}] f32, w_q [{K}, N] int8, "
                     f"numbers at N = 1024",
            "gflop": 2 * head["M"] * K * 1024 / 1e9,
            "widths": out[mode],
        })
    return entries


# ---------------------------------------------------------------------------
# Phase 4: end to end
# ---------------------------------------------------------------------------

def write_tiled_wav(src: Path, dst: Path, seconds: float) -> float:
    """``src`` repeated and cut to ``seconds``; returns the length in s."""
    with wave.open(str(src), "rb") as w:
        params = w.getparams()
        pcm = w.readframes(w.getnframes())
    n_frames = int(seconds * params.framerate)
    n = n_frames * params.sampwidth * params.nchannels
    dst.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(dst), "wb") as w:
        w.setparams(params)
        w.writeframes((pcm * (n // len(pcm) + 1))[:n])
    return n_frames / params.framerate


def _counters():
    from omnilingual_asr_torch.ops.attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dkv_f16,
        flash_attention_bwd_dkv_f32, flash_attention_bwd_dq,
        flash_attention_bwd_dq_f16, flash_attention_bwd_dq_f32,
        flash_attention_f16, flash_attention_f32)
    from omnilingual_asr_torch.ops.conv_module import (
        fused_conv_module, fused_conv_module_split)
    from omnilingual_asr_torch.ops.mel import log_mel_frames
    from omnilingual_asr_torch.ops.quant import (quantized_matmul,
                                                 quantized_matmul_a8)

    return (log_mel_frames, flash_attention, fused_conv_module,
            quantized_matmul, quantized_matmul_a8, flash_attention_bwd_dq,
            flash_attention_bwd_dkv, fused_conv_module_split,
            flash_attention_f32, flash_attention_bwd_dq_f32,
            flash_attention_bwd_dkv_f32, flash_attention_f16,
            flash_attention_bwd_dq_f16, flash_attention_bwd_dkv_f16)


def _read_counters(reset: bool = True) -> dict:
    counts = {}
    for fn in _counters():
        counts[fn.__name__] = fn.launches
        if reset:
            fn.launches = 0
    return counts


def _n_batches(engine, paths) -> int:
    n = 0
    for path in paths:
        with wave.open(str(path), "rb") as w:
            n_win = math.ceil(w.getnframes() / engine.window_samples)
        n += math.ceil(n_win / engine.batch_size)
    return n


def drive_path(label, answer, engine, requests, per_batch):
    """One path of the port: every launch count is set to 0, the requests
    are answered through ``answer(path, progress_callback)`` (which returns
    a ``to_dict()``-form result), and the counts are read at once and held
    to ``per_batch`` launches of each kernel a batch. Returns (results,
    launches)."""
    counters = _counters()
    n_batches = _n_batches(engine, [p for _, p in requests])
    for fn in counters:
        fn.launches = 0
    results, report = [], []
    for name, path in requests:
        steps = []
        t0 = time.perf_counter()
        res = answer(path, lambda s, i: steps.append(i))
        secs = time.perf_counter() - t0
        tr = engine.last_trace
        results.append(res)
        report.append({"path": label, "request": name, "seconds": secs,
                       "audio_seconds": tr.audio_seconds,
                       "segments": len(res["segments"]),
                       "stages": {k: round(v, 4)
                                  for k, v in tr.stages.items()}})
        if steps != [0, 1, 2, 3]:
            raise PhaseError(f"{label}: progress steps {steps} for {name}")
    launches = {fn.__name__: fn.launches for fn in counters}
    for r in report:
        log(f"  request {json.dumps(r)}")
    log(f"  {label} launches {json.dumps(launches)} over {n_batches} "
        f"batches")
    for name, n in per_batch.items():
        if launches[name] != n * n_batches:
            raise PhaseError(f"{label}: {name} launched {launches[name]} "
                             f"times, expected {n} a batch x {n_batches}")
    return results, launches


def check_golden(label, engine, result, quantize=False) -> None:
    """``result`` and the greedy CTC ids on the golden file against the JAX
    engine's stored result in the same mode."""
    from omnilingual_asr_torch import testing as golden

    stored = golden.load_golden(quantize)
    bad = golden.result_mismatches(stored["result"], result,
                                   tone_mass=stored["tone_mass"])
    if bad:
        raise PhaseError(f"{label}: golden result mismatch: "
                         + "; ".join(bad))
    if result["summary"] != stored["result"]["summary"]:
        log(f"  {label}: summary tone within the fixture's tie "
            f"(tone mass {stored['tone_mass']}): {result['summary']!r}")
    samples = engine._load_audio(golden.GOLDEN_WAV)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    ids = [o["ctc_ids"].astype(int).tolist()
           for outs in engine._forward_batches(windows, n_last) for o in outs]
    agree = golden.ctc_agreement(stored["ctc_ids"], ids)
    log(f"  {label} golden: {len(result['segments'])} segments match the "
        f"JAX result ({golden.golden_json(quantize).name}); greedy CTC ids "
        f"agree on {agree:.4%} of frames")
    if agree < golden.MIN_CTC_AGREEMENT:
        raise PhaseError(f"{label}: CTC id agreement {agree:.4f} < "
                         f"{golden.MIN_CTC_AGREEMENT}")


def check_segment_times(label, results, audio_s) -> None:
    for res in results:
        if not res["segments"]:
            raise PhaseError(f"{label}: a request returned no segments")
        for s in res["segments"]:
            if not (0.0 <= s["start"] < s["end"] <= audio_s + 1.0):
                raise PhaseError(f"{label}: segment times {s['start']}-"
                                 f"{s['end']} outside [0, {audio_s}]")


def run_e2e(dev, cfg, params, xvector):
    """The unquantized main path through ``TranscriptionEngine``, then the
    int8 paths through the facade. Returns (engines by mode, launches of
    each kernel on its own path)."""
    import dataclasses

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.diarization.pipeline import (
        GeminiDiarizedTranscriptionPipeline)
    from omnilingual_asr_torch.engine import TranscriptionEngine

    L = cfg.encoder.n_layers
    tiled = PKG / "_build" / "smoke_tiled.wav"
    tiled_s = write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    requests = [("golden", golden.GOLDEN_WAV), ("tiled", tiled),
                ("tiled-warm", tiled)]
    engine = TranscriptionEngine(config=cfg, params=params,
                                 xvector_params=xvector, device=dev)
    unquantized = {"log_mel_frames": 1, "flash_attention": L,
                   "fused_conv_module": L, "quantized_matmul": 0,
                   "quantized_matmul_a8": 0, "flash_attention_bwd_dq": 0,
                   "flash_attention_bwd_dkv": 0}
    results, base = drive_path(
        "unquantized",
        lambda path, cb: engine.transcribe(path,
                                           progress_callback=cb).to_dict(),
        engine, requests, unquantized)
    check_golden("unquantized", engine, results[0])
    check_segment_times("unquantized", results[1:], tiled_s)
    if ([s["text"] for s in results[1]["segments"]]
            != [s["text"] for s in results[2]["segments"]]):
        raise PhaseError("the warm repeat of the tiled request differs")
    launches = {k: base[k] for k in ("log_mel_frames", "flash_attention",
                                     "fused_conv_module")}
    engines = {"unquantized": engine}

    # Int8 serving through the public facade: 2 FFN up-projections a layer,
    # the CTC and the LID head take the kernels (10 launches a batch).
    n_kernel_layers = 2 * L + 2
    for quantize, requests_q in (("a8", requests[:2]), ("w8", requests[:2]),
                                 (True, requests[:1])):
        pipe = GeminiDiarizedTranscriptionPipeline(
            config=cfg, params=params, xvector_params=xvector, device=dev,
            quantize=quantize)

        def answer(path, cb, pipe=pipe):
            segs = pipe.transcribe(str(path), word_timestamps=True,
                                   progress_callback=cb)
            return {"summary": pipe.summary,
                    "detected_languages": pipe.detected_languages,
                    "segments": [dataclasses.asdict(x) for x in segs]}

        label = f"quantize={quantize!r}"
        per_batch = dict(unquantized)
        per_batch["quantized_matmul_a8"] = (n_kernel_layers
                                            if quantize == "a8" else 0)
        per_batch["quantized_matmul"] = (n_kernel_layers
                                         if quantize == "w8" else 0)
        results, counts = drive_path(label, answer, pipe.gemini, requests_q,
                                     per_batch)
        if quantize is True:
            check_segment_times(label, results,
                                pipe.gemini.last_trace.audio_seconds)
            engines["q"] = pipe.gemini
            continue
        check_golden(label, pipe.gemini, results[0], quantize)
        check_segment_times(label, results[1:], tiled_s)
        key = "quantized_matmul_a8" if quantize == "a8" else \
            "quantized_matmul"
        launches[key] = counts[key]
        engines[quantize] = pipe.gemini
    return engines, launches


# ---------------------------------------------------------------------------
# Phase 4d: the decoders (text-mode translator, fact-conditioned summarizer)
# ---------------------------------------------------------------------------

def _timed_decoders(engine, calls) -> dict:
    """Wrap the engine's two decoders so that each call's seconds (host
    clock; a decode ends in a device-to-host copy) and inputs are kept in
    ``calls``: {"translate": [...], "summary": [...]} of (seconds, args,
    kwargs, tokens). Returns the unwrapped decode functions by key."""
    dec = {"translate": (engine._translator, "translate_text"),
           "summary": (engine._summarizer.decoder, "decode")}
    plain = {}
    for key, (obj, name) in dec.items():
        fn = plain[key] = getattr(obj, name)

        def timed(*args, _fn=fn, _key=key, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs).cpu()
            calls[_key].append((time.perf_counter() - t0, args, kwargs, out))
            return out

        setattr(obj, name, timed)
    return plain


def _set_graphs(engine, on: bool) -> None:
    engine._translator.use_graph = on
    engine._summarizer.decoder.use_graph = on


def run_decoders(dev, cfg, params, xvector):
    """``TranscriptionEngine`` on the card with the release translator and
    summarizer given by explicit path answers the golden and the tiled
    file; the golden result is held to ``golden_decoders.json`` and the
    K1-K3 launches to the main path's counts; every decode's CUDA-graph
    tokens are held to the same decode run eagerly; then the decoders'
    seconds a request, warm, with the graphs and without. Returns the
    launches of this path."""
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine

    L = cfg.encoder.n_layers
    tiled = PKG / "_build" / "smoke_tiled.wav"
    tiled_s = write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    engine = TranscriptionEngine(
        config=cfg, params=params, xvector_params=xvector, device=dev,
        translator_path=str(RELEASE / "translator.npz"),
        summarizer_path=str(RELEASE / "summarizer.npz"))
    if not (engine._translator.is_text and engine._translator.use_graph
            and engine._summarizer.fact_conditioned):
        raise PhaseError("the release decoders did not load as the text "
                         "translator and the fact-conditioned summarizer "
                         "with CUDA graphs")
    calls = {"translate": [], "summary": []}
    plain = _timed_decoders(engine, calls)
    per_batch = {"log_mel_frames": 1, "flash_attention": L,
                 "fused_conv_module": L, "quantized_matmul": 0,
                 "quantized_matmul_a8": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0}
    results, launches = drive_path(
        "decoders",
        lambda path, cb: engine.transcribe(path,
                                           progress_callback=cb).to_dict(),
        engine, [("golden", golden.GOLDEN_WAV), ("tiled", tiled)],
        per_batch)
    stored = golden.load_golden_decoders()
    bad = golden.result_mismatches(stored["result"], results[0],
                                   tone_mass=stored["tone_mass"])
    if results[0]["summary"] != stored["result"]["summary"]:
        bad.append(f"summary {results[0]['summary']!r}")
    if bad:
        raise PhaseError("decoders: golden result mismatch: "
                         + "; ".join(bad))
    check_segment_times("decoders", results[1:], tiled_s)
    if not all(s["translation"] for r in results for s in r["segments"]
               if s["language_code"] != "en"):
        raise PhaseError("decoders: a non-English segment has no "
                         "translation")
    # The golden request's decodes: the tokens of the JAX engine's
    # decodes, and the same decodes run eagerly.
    (_, args, kwargs, toks), = calls["translate"][:1]
    want = [t["tokens"] for t in stored["translations"]]
    if toks[:len(want)].tolist() != want:
        raise PhaseError("decoders: the golden spans' tokens differ from "
                         "the JAX engine's")
    if calls["summary"][0][3][0].tolist() != stored["summary"]["tokens"]:
        raise PhaseError("decoders: the golden summary's tokens differ "
                         "from the JAX engine's")
    n_tokens = 0
    _set_graphs(engine, False)
    for key, fn in plain.items():
        for _, args, kwargs, toks in calls[key]:
            eager = fn(*args, **kwargs).cpu()
            if not torch.equal(eager, toks):
                raise PhaseError(f"decoders: {key} tokens from the CUDA "
                                 f"graph differ from the eager decode")
            n_tokens += toks.numel()
    log(f"  decoders: golden result equals golden_decoders.json; "
        f"{len(calls['translate'])} translation and "
        f"{len(calls['summary'])} summary decodes ({n_tokens} tokens) "
        f"equal the same decodes run eagerly")
    # Warm seconds a request, by decoder, graphs on and off, in turns.
    secs = {}
    for _ in range(DECODER_ROUNDS):
        for graphs in (True, False):
            _set_graphs(engine, graphs)
            for name, path in (("golden", golden.GOLDEN_WAV),
                               ("tiled", tiled)):
                for v in calls.values():
                    v.clear()
                engine.transcribe(path)
                st = engine.last_trace.stages
                row = secs.setdefault(f"{name} graphs={graphs}", {
                    "translate_s": [], "summary_s": [],
                    "assemble.translate": [], "assemble.summary": []})
                for key in ("translate", "summary"):
                    row[f"{key}_s"].append(sum(c[0] for c in calls[key]))
                    row[f"assemble.{key}"].append(st[f"assemble.{key}"])
    _set_graphs(engine, True)
    for label, row in secs.items():
        log("  decoder seconds " + json.dumps({
            "request": label, "rounds": DECODER_ROUNDS,
            "translate_s_median": statistics.median(row["translate_s"]),
            "summary_s_median": statistics.median(row["summary_s"]),
            **{k: v for k, v in row.items()}}))
    return engine, launches


# ---------------------------------------------------------------------------
# Phase 4f: the d512 x 12 seed in crop mode, the beam search, streaming,
# the live route, and the release engine's wire modes
# ---------------------------------------------------------------------------

def _sse_timed(port, path, name, data):
    """(seconds to the first ``segments`` event, seconds to the ``result``
    event, events) of one SSE POST, read line by line as it streams."""
    import http.client

    body, ctype = _multipart([(name, data)])
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    t_first = t_final = None
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        if resp.status != 200:
            raise PhaseError(f"POST {path} answered {resp.status}")
        lines = []
        while True:
            line = resp.readline()
            if not line:
                break
            if line.startswith(b"event: segments") and t_first is None:
                t_first = time.perf_counter() - t0
            if line.startswith(b"event: result"):
                t_final = time.perf_counter() - t0
            lines.append(line)
    finally:
        conn.close()
    return t_first, t_final, _sse_events(b"".join(lines))


def run_d512(dev, smi, release_params, release_xvector):
    """Phase 4f. ``checkpoints/r5_d512x12_seed`` (d_model 512, 12 layers, no
    x-vector) through ``config_for_checkpoint`` with ``speaker_mode=
    "crop"``, greedy and with the fixture's beam search, answers the golden
    and the tiled 120 s file through ``transcribe`` and through
    ``transcribe_streaming``: held to ``golden_d512_crop.json``
    (``testing.d512_mismatches``; the stable beam decodes' texts exact;
    the beam feed within ``testing.FEED_TOL`` of the JAX engine's, and the
    search over the JAX feed giving every JAX text),
    each stream's final event equal to ``transcribe``'s result, and the
    launches read over these requests (K1 a window batch and a crop batch,
    K2 and K3 12 a window batch). Then warm seconds (medians of
    D512_ROUNDS): inline (trunk pooling), crop and beam-8 crop requests,
    the ``extract`` stage and the crop forward's seconds; the live route
    in front of the crop engine, its first partial and its final event
    against ``engine.transcribe``. Last, the release engine with μ-law
    ingress and with the int8 speaker wire at stride 2 answers the golden
    file, held to the fixture's ``release_wire``, and ``health_check``.
    Returns the launches."""
    import dataclasses
    import tempfile

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import (PipelineConfig,
                                              config_for_checkpoint)
    from omnilingual_asr_torch.engine import (SPK_CROP_BATCH,
                                              TranscriptionEngine)
    from omnilingual_asr_torch.models.zoo import load_checkpoint
    from omnilingual_asr_torch.serving.app import OmniServer
    from omnilingual_asr_torch.serving.schema import result_to_entry

    stored = golden.load_golden_d512()
    base = config_for_checkpoint(str(D512))
    L = base.encoder.n_layers
    beam = base.replace(decode=dataclasses.replace(base.decode,
                                                   **stored["beam"]))
    params = load_checkpoint(D512, base, dev)
    engines = {mode: TranscriptionEngine(config=cfg, params=params,
                                         device=dev, speaker_mode=speaker)
               for mode, cfg, speaker in (("greedy", base, "crop"),
                                          ("beam", beam, "crop"),
                                          ("inline", base, "inline"))}
    for eng in engines.values():
        icfg = eng.infer_config.encoder
        if not (icfg.use_flash_attention and icfg.use_fused_conv
                and eng._xvector is None):
            raise PhaseError("d512: the engine did not take K2 and K3, or "
                             "loaded an x-vector")
    tiled = PKG / "_build" / "smoke_tiled.wav"
    write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    files = {"golden": golden.GOLDEN_WAV, "tiled": tiled}
    rec = {"ids": {}, "feeds": {}, "crop_batches": 0, "crop_s": []}

    def watch(eng):
        """Record each request's greedy ids, beam feed, crop batches and
        crop seconds on ``eng``."""
        extract, crop = eng._extract_windows, eng._segment_crop_embeds

        def rec_extract(outs, *parts):
            rec["ids"].setdefault(rec["name"], []).extend(
                o["ctc_ids"].astype(int).tolist() for o in outs)
            rec["feeds"].setdefault(rec["name"], []).extend(
                o["ctc_topk"] for o in outs if o["ctc_topk"] is not None)
            return extract(outs, *parts)

        def rec_crop(samples, decoded):
            t0 = time.perf_counter()
            out = crop(samples, decoded)
            rec["crop_s"].append(time.perf_counter() - t0)
            rec["crop_batches"] += math.ceil(len(decoded) / SPK_CROP_BATCH)
            return out

        eng._extract_windows, eng._segment_crop_embeds = (rec_extract,
                                                          rec_crop)

    for eng in engines.values():
        watch(eng)
    counters = _counters()
    for fn in counters:
        fn.launches = 0
    rec["crop_batches"] = 0
    results = {}
    for mode in ("greedy", "beam"):
        eng = engines[mode]
        results[mode] = {}
        rec["ids"], rec["feeds"] = {}, {}
        for name, path in files.items():
            rec["name"] = name
            results[mode][name] = eng.transcribe(path).to_dict()
        bad = golden.d512_mismatches(mode, results[mode], rec["ids"])
        if mode == "beam":
            bad += golden.d512_feed_mismatches(rec["feeds"])
        if bad:
            raise PhaseError(f"d512 {mode}: golden mismatch: "
                             + "; ".join(bad))
        rec["name"] = "stream"
        for name, path in files.items():
            events = list(eng.transcribe_streaming(path))
            kinds = [k for k, _ in events]
            n_part = _n_batches(eng, [path])
            if kinds != ["partial"] * n_part + ["final"]:
                raise PhaseError(f"d512 {mode} stream of {name}: {kinds}")
            if events[-1][1].to_dict() != results[mode][name]:
                raise PhaseError(f"d512 {mode}: the stream's final result "
                                 f"for {name} differs from transcribe's")
    launches = {fn.__name__: fn.launches for fn in counters}
    n_batches = 4 * _n_batches(engines["greedy"], list(files.values()))
    want = {"log_mel_frames": n_batches + rec["crop_batches"],
            "flash_attention": L * n_batches,
            "fused_conv_module": L * n_batches}
    log(f"  d512 launches {json.dumps(launches)} over {n_batches} window "
        f"batches and {rec['crop_batches']} crop batches")
    for name, n in want.items():
        if launches[name] != n:
            raise PhaseError(f"d512: {name} launched {launches[name]} "
                             f"times, expected {n}")
    # The host half of the beam path alone: the port's search over the JAX
    # engine's own feed gives the JAX text of every decode.
    import numpy as np

    feed = np.load(golden.GOLDEN_D512_FEED)
    n_exact = n_dec = 0
    for name, f in stored["files"].items():
        for d in f["beam"]["decodes"]:
            topk = (feed[f"{name}/{d['window']}/lp"],
                    feed[f"{name}/{d['window']}/ids"])
            n_exact += engines["beam"]._beam_text(topk, d["f0"],
                                                  d["f1"]) == d["text"]
            n_dec += 1
    if n_exact != n_dec:
        raise PhaseError(f"d512: the beam search over the JAX feed gave "
                         f"the JAX text in {n_exact} of {n_dec} decodes")
    diffs, swaps, n_frames = [], 0, 0
    for name in files:
        for w, (lp, ids) in enumerate(rec["feeds"][name]):
            diffs.append(np.abs(lp - feed[f"{name}/{w}/lp"]).ravel())
            swaps += sum(set(a) != set(b) for a, b in zip(
                ids.tolist(), feed[f"{name}/{w}/ids"].tolist()))
            n_frames += len(ids)
    diffs = np.concatenate(diffs)
    log("  d512 beam feed against the JAX engine's " + json.dumps({
        "mean_abs_dlogp": float(diffs.mean()),
        "max_abs_dlogp": float(diffs.max()),
        "frames_with_another_class_set": swaps / n_frames}))
    log("  d512 beam decodes " + json.dumps([
        {"file": name, "gap": d["gap"], "stable": d["stable"],
         "text_equal": w["text"] == g["text"]}
        for name, f in stored["files"].items()
        for d, w, g in zip(f["beam"]["decodes"], f["beam"]["result"][
            "segments"], results["beam"][name]["segments"])]))
    texts = golden.d512_beam_texts(results["beam"])
    log(f"  d512 golden: greedy and beam results of both files match "
        f"golden_d512_crop.json; the beam feed is within "
        f"{golden.FEED_TOL} of the JAX engine's; over the JAX feed the "
        f"beam search gives the JAX text of all {n_dec} decodes; over the "
        f"run's own feed it gives the JAX text of {texts['stable']} "
        f"stable and {texts['unstable']} unstable decodes; streams' final "
        f"events equal transcribe's")
    for mode in ("greedy", "beam"):
        for name in files:
            segs = results[mode][name]["segments"]
            log(f"  d512 {mode} {name}: {len(segs)} segments, "
                f"{len({s['speaker'] for s in segs})} speakers")

    # Warm seconds a request, by mode and file, in turns.
    secs = {}
    for _ in range(D512_ROUNDS):
        for mode in ("inline", "greedy", "beam"):
            eng = engines[mode]
            for name, path in files.items():
                rec["crop_s"].clear()
                t0 = time.perf_counter()
                eng.transcribe(path)
                row = secs.setdefault(f"{mode} {name}", {
                    "request_s": [], "extract_s": [], "crop_s": []})
                row["request_s"].append(time.perf_counter() - t0)
                row["extract_s"].append(eng.last_trace.stages["extract"])
                row["crop_s"].append(sum(rec["crop_s"]))
    for label, row in secs.items():
        log("  d512 seconds " + json.dumps({
            "request": label, "rounds": D512_ROUNDS,
            **{f"{k}_median": statistics.median(v) for k, v in row.items()},
            **row, "card": smi}))

    # The live route in front of the crop engine.
    eng = engines["greedy"]
    with tempfile.TemporaryDirectory(dir=PKG / "_build") as d:
        srv = OmniServer(engine=eng, base_dir=Path(d), auth_required=False,
                         use_sqlite=True)
        port = srv.serve_background("127.0.0.1", 0)
        try:
            for name, path in files.items():
                data = path.read_bytes()
                row = {"first_partial_s": [], "final_s": [],
                       "transcribe_s": []}
                for _ in range(D512_ROUNDS):
                    t_first, t_final, events = _sse_timed(
                        port, "/api/transcribe-stream-live", f"{name}.wav",
                        data)
                    if events[-1][0] != "result" or t_first is None:
                        raise PhaseError(f"d512 live route: events "
                                         f"{[k for k, _ in events]}")
                    t0 = time.perf_counter()
                    res = eng.transcribe(path)
                    row["transcribe_s"].append(time.perf_counter() - t0)
                    row["first_partial_s"].append(t_first)
                    row["final_s"].append(t_final)
                    want = result_to_entry(res, file_name="", audio_url="")
                    got = events[-1][1]
                    if any(got.get(k) != want.get(k) for k in (
                            "segments", "summary", "detected_languages")):
                        raise PhaseError(f"d512 live route: the final entry "
                                         f"for {name} differs from "
                                         f"transcribe's result")
                log("  d512 live route " + json.dumps({
                    "file": name, "rounds": D512_ROUNDS,
                    **{f"{k}_median": statistics.median(v)
                       for k, v in row.items()}, **row, "card": smi}))
        finally:
            srv.shutdown()
            srv.app._httpd.server_close()

    # The release engine's wire modes on the golden file, and the probe.
    for mode, (kwargs, decode) in (
            ("mulaw", ({"ingress": "mulaw"}, {})),
            ("i8_stride2", ({}, {"spk_wire": "i8", "spk_frame_stride": 2}))):
        cfg = PipelineConfig.from_json(
            (RELEASE / "config.json").read_text(),
            checkpoint_path=str(RELEASE / "asr.npz"))
        cfg = cfg.replace(decode=dataclasses.replace(cfg.decode, **decode))
        eng = TranscriptionEngine(config=cfg, params=release_params,
                                  xvector_params=release_xvector,
                                  device=dev, **kwargs)
        want = stored["release_wire"][mode]
        res = eng.transcribe(golden.GOLDEN_WAV).to_dict()
        samples = eng._load_audio(golden.GOLDEN_WAV)   # one window
        ids = [o["ctc_ids"].astype(int).tolist()
               for outs in eng._forward_batches(eng._windows(samples),
                                                len(samples))
               for o in outs]
        bad = golden.result_mismatches(want["result"], res,
                                       tone_mass=want["tone_mass"])
        agree = golden.ctc_agreement(want["ctc_ids"], ids)
        if bad or agree < golden.MIN_CTC_AGREEMENT:
            raise PhaseError(f"release {mode}: golden mismatch "
                             f"{bad}, ids agree {agree:.4f}")
        log(f"  release {mode}: golden result matches the JAX engine's in "
            f"the same mode; greedy ids agree on {agree:.4%}")
    report = engines["greedy"].health_check()
    if not report["ok"]:
        raise PhaseError(f"health_check: {report}")
    log(f"  health_check {json.dumps(report)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4g: the evaluation drivers (eval.synth, heads, diar, long, latency)
# ---------------------------------------------------------------------------

EVAL_QUANT_FILES = 32     # eval.synth files under each int8 kernel mode
EVAL_LONG_HOURS = 1.0     # the timed eval.long run (its own process)
EVAL_LATENCY_REPS = 16
EVAL_CLI_TIMEOUT_S = 600


@contextlib.contextmanager
def _batches(engine):
    """Counts the device batches ``engine`` dispatches within the block."""
    n = [0]
    inner = engine._dispatch_batch

    def counting(*args, **kwargs):
        n[0] += 1
        return inner(*args, **kwargs)

    engine._dispatch_batch = counting
    try:
        yield n
    finally:
        del engine._dispatch_batch


def _launches_since(label, before, n_batches, per_batch) -> dict:
    """The launches since ``before`` (``_read_counters(reset=False)``), held
    to ``per_batch`` launches of each kernel named a batch."""
    now = _read_counters(reset=False)
    got = {k: now[k] - before[k] for k in now}
    for name, n in per_batch.items():
        if got[name] != n * n_batches:
            raise PhaseError(f"{label}: {name} launched {got[name]} times, "
                             f"expected {n} a batch x {n_batches}")
    return got


def _driver_cli(name: str, argv) -> dict:
    """``python -m omnilingual_asr_torch.eval.<name> ARGV`` in a process of
    its own, with release discovery on as a user's run has it: its one
    JSON line."""
    env = {k: v for k, v in os.environ.items() if k != "OMNIASR_RELEASE_DIR"}
    proc = subprocess.run(
        [sys.executable, "-m", f"omnilingual_asr_torch.eval.{name}", *argv],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=EVAL_CLI_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise PhaseError(f"eval.{name} {argv} exited {proc.returncode}: "
                         f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    return json.loads(lines[0])


def run_evals(dev, cfg, params, xvector) -> dict:
    """Phase 4g. The port's evaluation drivers with the release weights on
    the card, held to the JAX package's ``golden_evals.json`` by
    ``testing.py``'s criteria: eval.synth on its 96 files at 10 s windows
    (texts, greedy ids pooled over the files, WER/CER), then its first EVAL_QUANT_FILES files
    unquantized and under "w8" and "a8" (reported, not held: the fixture
    has no JAX int8 corpus run); eval.heads on its 64 files and 8
    conversations with the release translator and summarizer; eval.diar on
    its 16 conversations; eval.long's engine on the 420 s file (streamed:
    no ``decode`` stage; ``testing.long_mismatches``). Every release batch launches one K1, four K2 and
    four K3 (K4 or K5 ten under "w8" or "a8"). Then two drivers as a user
    runs them, each in a process of its own with the release discovered:
    ``eval.long --hours 1`` (wall, RTF, stages, peak RSS, the card's peak
    memory) and ``eval.latency`` (d512 x 12 at batch 1). Returns the
    launches of the in-process runs."""
    import tempfile

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.eval import diar, harness, heads, long, synth
    from omnilingual_asr_torch.utils.metrics import aggregate_wer

    want = golden.load_golden_evals()
    L = cfg.encoder.n_layers
    per_batch = {"log_mel_frames": 1, "flash_attention": L,
                 "fused_conv_module": L, "quantized_matmul": 0,
                 "quantized_matmul_a8": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0}

    def engine(**kwargs):
        return TranscriptionEngine(config=cfg, params=params,
                                   xvector_params=xvector, device=dev,
                                   **kwargs)

    for fn in _counters():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # eval.synth: 96 files at 10 s windows.
        t0 = time.perf_counter()
        ws = want["synth"]["window_seconds"]
        eng = engine(window_seconds=ws)
        if (eng.window_frames != 1024
                or not eng.infer_config.encoder.use_flash_attention):
            raise PhaseError(f"eval.synth engine: {eng.window_frames} "
                             f"frames, flash "
                             f"{eng.infer_config.encoder.use_flash_attention}")
        folder = tmp / "synth"
        manifest = synth.build_manifest(folder, want["synth"]["n"],
                                        include_real=True)
        t_data = time.perf_counter() - t0
        before = _read_counters(reset=False)
        with golden.recorded_ctc_ids(eng) as ids, _batches(eng) as nb:
            sets, reports = synth.evaluate_sets(eng, manifest, folder)
        _launches_since("eval.synth", before, nb[0], per_batch)
        rep = reports["synth"]
        hyps = [r["hyp"] for r in rep.per_file]
        stored = want["synth"]["files"]
        differ = {i: golden.ctc_agreement(f["ctc_ids"], ids[i])
                  for i, (h, f) in enumerate(zip(hyps, stored))
                  if h != f["hyp"]}
        pooled = golden.ctc_agreement(
            [x for f in stored for x in f["ctc_ids"]],
            [x for got in ids for x in got])
        log(f"  eval.synth {json.dumps(sets)} over {nb[0]} batches "
            f"(data {t_data:.2f} s, {time.perf_counter() - t0:.2f} s); "
            f"fixture WER {want['synth']['wer']:.6f} CER "
            f"{want['synth']['cer']:.6f}, card WER {rep.wer:.6f} CER "
            f"{rep.cer:.6f}; texts differ on {len(differ)} of "
            f"{len(hyps)} files (file: its ids' agreement {differ}); the "
            f"files' greedy ids agree on {pooled:.4%} of frames")
        bad = golden.synth_mismatches(want["synth"], hyps, ids, rep.wer,
                                      rep.cer)
        if bad:
            raise PhaseError("eval.synth: " + "; ".join(bad))

        # The same corpus's first files unquantized and under the kernels.
        sub = folder / "manifest_quant.jsonl"
        sub.write_text("".join(
            (folder / "manifest_synth.jsonl").read_text().splitlines(True)
            [:EVAL_QUANT_FILES]))
        quant = {}
        for mode in (False, "w8", "a8"):
            e = eng if mode is False else engine(window_seconds=ws,
                                                 quantize=mode)
            pb = dict(per_batch)
            if mode:
                pb["quantized_matmul" if mode == "w8"
                   else "quantized_matmul_a8"] = 2 * L + 2
            before = _read_counters(reset=False)
            with _batches(e) as nb:
                r = harness.evaluate(e, sub)
            got = _launches_since(f"eval.synth quantize={mode!r}", before,
                                  nb[0], pb)
            quant[mode or "none"] = {
                "wer": r.wer, "cer": r.cer, "rtf": r.rtf,
                "n_files": r.n_files, "batches": nb[0],
                "k4": got["quantized_matmul"],
                "k5": got["quantized_matmul_a8"]}
        fixture32 = aggregate_wer([(f["text"], f["hyp"])
                                   for f in stored[:EVAL_QUANT_FILES]])
        log(f"  eval.synth first {EVAL_QUANT_FILES} files {json.dumps(quant)}"
            f"; the fixture's WER/CER there {fixture32['wer']:.4f} / "
            f"{fixture32['cer']:.4f}")

        # eval.heads with the release translator and summarizer.
        t0 = time.perf_counter()
        eng = engine(translator_path=str(RELEASE / "translator.npz"),
                     summarizer_path=str(RELEASE / "summarizer.npz"))
        before = _read_counters(reset=False)
        with _batches(eng) as nb:
            report, rows = heads.evaluate_heads(
                eng, want["heads"]["n"], tmp / "heads", translate=True,
                summarize=True)
        _launches_since("eval.heads", before, nb[0], per_batch)
        pairs = [(g, w) for g, w in zip(rows["files"],
                                        want["heads"]["files"])
                 if g and w and "translation" in w]
        same = sum(g.get("translation") == w["translation"]
                   for g, w in pairs)
        log(f"  eval.heads {json.dumps(report)} over {nb[0]} batches "
            f"({time.perf_counter() - t0:.2f} s); fixture "
            f"{json.dumps(want['heads']['report'])}; translations identical "
            f"on {same} of {len(pairs)} files")
        bad = golden.heads_mismatches(want["heads"], report, rows)
        if bad:
            raise PhaseError("eval.heads: " + "; ".join(bad))

        # eval.diar: 16 conversations on the serving engine's config.
        t0 = time.perf_counter()
        eng = engine()
        before = _read_counters(reset=False)
        with _batches(eng) as nb:
            report, _ = diar.diar_report(lambda c: eng, cfg,
                                         want["diar"]["n"],
                                         want["diar"]["seed"])
        _launches_since("eval.diar", before, nb[0], per_batch)
        details = report["details"]
        der_mean = float(sum(d["der"] for d in details) / len(details))
        log(f"  eval.diar DER {report['value']} speaker count acc "
            f"{report['speaker_count_acc']} over {nb[0]} batches "
            f"({time.perf_counter() - t0:.2f} s); fixture DER "
            f"{want['diar']['report']['value']} count acc "
            f"{want['diar']['report']['speaker_count_acc']}; largest DER "
            f"difference "
            f"{max(abs(g['der'] - w['der']) for g, w in zip(details, want['diar']['report']['details'])):.4f}")
        bad = golden.diar_mismatches(want["diar"], details, der_mean)
        if bad:
            raise PhaseError("eval.diar: " + "; ".join(bad))

        # eval.long's engine on the 420 s file: the streamed-WAV path.
        t0 = time.perf_counter()
        eng = engine(batch_windows_per_device=want["long"]["batch_windows"])
        long.warm_up(eng, tmp)
        seconds = want["long"]["seconds"]
        path = long.make_long_audio(seconds, tmp / "long.wav")
        before = _read_counters(reset=False)
        with golden.recorded_ctc_ids(eng) as ids, _batches(eng) as nb:
            report, result = long.long_report(eng, path, seconds,
                                              seconds / 3600)
        _launches_since("eval.long 420 s", before, nb[0], per_batch)
        agreement = golden.long_agreement(want["long"]["result"],
                                          result.to_dict())
        log(f"  eval.long 420 s {json.dumps(report)} over {nb[0]} batches "
            f"({time.perf_counter() - t0:.2f} s with the warm-up); greedy "
            f"ids agree on {golden.ctc_agreement(want['long']['ctc_ids'], ids[0]):.4%}"
            f"; against the JAX result {json.dumps(agreement)}; the JAX "
            f"engine's own under 1-LSB noise "
            f"{json.dumps(want['long']['perturbed'])}")
        bad = golden.long_mismatches(want["long"], result.to_dict(),
                                     report["stages_s"], ids[0])
        if bad:
            raise PhaseError("eval.long 420 s: " + "; ".join(bad))
    launches = _read_counters(reset=False)

    # The drivers as a user runs them, each in a process of its own.
    t0 = time.perf_counter()
    report = _driver_cli("long", ["--hours", str(EVAL_LONG_HOURS)])
    log(f"  eval.long --hours {EVAL_LONG_HOURS} {json.dumps(report)} "
        f"({time.perf_counter() - t0:.2f} s with process start, warm-up "
        f"and the WAV's writing)")
    if "decode" in report["stages_s"] or report["n_segments"] < 100:
        raise PhaseError(f"eval.long --hours {EVAL_LONG_HOURS}: {report}")
    t0 = time.perf_counter()
    report = _driver_cli("latency", ["--reps", str(EVAL_LATENCY_REPS)])
    log(f"  eval.latency {json.dumps(report)} "
        f"({time.perf_counter() - t0:.2f} s)")
    if report["model"] != {"d_model": 512, "n_layers": 12}:
        raise PhaseError(f"eval.latency: {report}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4e: the server (native decoding, HTTP routes, history, exports)
# ---------------------------------------------------------------------------

SERVER_SECONDS = (120.0, 330.0)  # tiled files decoded both ways and served
SERVER_ROUNDS = 3                # warm requests a timing (medians)
EXPORT_FORMATS = ("eaf", "textgrid", "srt", "txt", "json")
# What differs between two servings of one file: ids, clocks, upload names.
UNSTABLE_KEYS = ("id", "created_at", "audio_url", "audio_key", "file_name")


def _multipart(files, field="file"):
    """(body, content type) of a multipart form with ``files``: [(name,
    bytes)]."""
    boundary = "omnismokeboundary"
    parts = []
    for name, data in files:
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{field}\"; filename=\"{name}\"\r\nContent-"
                     f"Type: application/octet-stream\r\n\r\n".encode()
                     + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _http(port, method, path, body=None, ctype=None):
    """(status, body bytes) of one request to the local server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _sse_events(data: bytes):
    events = []
    for block in data.decode().split("\n\n"):
        fields = dict(line.partition(": ")[::2]
                      for line in block.splitlines() if line)
        if "event" in fields:
            events.append((fields["event"], json.loads(fields["data"])))
    return events


def _stable(entry: dict) -> dict:
    return {k: v for k, v in entry.items() if k not in UNSTABLE_KEYS}


def _post_files(port, path, files, field="file"):
    """The body of a multipart POST of ``files``; any status but 200
    fails the phase."""
    status, body = _http(port, "POST", path, *_multipart(files, field))
    if status != 200:
        raise PhaseError(f"server: POST {path} answered {status}: "
                         f"{body[:300]!r}")
    return body


def write_resampled_stereo(src: Path, dst: Path, rate: int) -> None:
    """``src`` (16 kHz mono PCM-16) resampled to ``rate`` as a stereo file
    whose right channel is the left at half gain."""
    import numpy as np
    from omnilingual_asr_torch.audio.decode import decode_wav_bytes
    from omnilingual_asr_torch.audio.resample import resample

    x, sr = decode_wav_bytes(src.read_bytes())
    y = resample(x, sr, rate)
    pcm = np.clip(np.round(np.stack([y, 0.5 * y], axis=1) * 32767),
                  -32768, 32767).astype("<i2")
    with wave.open(str(dst), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def check_native(engine, work: Path, smi: str) -> dict:
    """The native library: built from the port's source under ``_build/``
    (failing the phase when it is not), then the tiled files decoded
    natively and by the Python parser, equal, with both times and the
    engine's own decode (``_load_audio``: native, at the engine's rate)."""
    import numpy as np
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.audio import native_lib
    from omnilingual_asr_torch.audio.decode import decode_wav_bytes

    if not native_lib.native_available():
        raise PhaseError("server: the native omniaudio library did not "
                         "build or load (g++ on "
                         f"{native_lib.SOURCE.relative_to(ROOT)})")
    info = native_lib.native_build()
    if info.lib_path.parent.parent != PKG / "_build":
        raise PhaseError(f"server: the native library {info.lib_path} is "
                         f"not under omnilingual_asr_torch/_build/")
    headers = bool(native_lib._libav_flags())
    log("  native " + json.dumps({
        "lib": str(info.lib_path.relative_to(ROOT)),
        "build_s": info.seconds, "cached": info.cached,
        "flags": info.flags, "libav_headers": headers,
        "libav_linked": info.libav, "card": smi}))
    paths = {}
    for seconds in SERVER_SECONDS:
        path = work / f"t{int(seconds)}.wav"
        write_tiled_wav(golden.GOLDEN_WAV, path, seconds)
        paths[seconds] = path
        times = {"native_s": [], "python_s": [], "engine_load_s": []}
        for _ in range(SERVER_ROUNDS):
            t0 = time.perf_counter()
            engine._load_audio(path)
            times["engine_load_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got, sr = native_lib.native_decode(path)
            times["native_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            want, want_sr = decode_wav_bytes(path.read_bytes())
            times["python_s"].append(time.perf_counter() - t0)
            if sr != want_sr or not np.array_equal(got, want):
                raise PhaseError(f"server: the native decode of the "
                                 f"{seconds:.0f} s file differs from the "
                                 f"Python parser's")
        log("  decode " + json.dumps({
            "audio_s": seconds, "samples_equal": True,
            "native_s_median": statistics.median(times["native_s"]),
            "python_s_median": statistics.median(times["python_s"]),
            "engine_load_s_median": statistics.median(
                times["engine_load_s"]),
            **times, "card": smi}))
    return {"paths": paths, "libav": info.libav}


def _mp3_of(src: Path, dst: Path) -> bool:
    """An MP3 of ``src`` made on this machine, if an encoder is here."""
    import shutil

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        return False
    proc = subprocess.run([ffmpeg, "-loglevel", "error", "-y", "-i",
                           str(src), "-codec:a", "libmp3lame", "-b:a",
                           "128k", str(dst)], capture_output=True,
                          timeout=120)
    return proc.returncode == 0 and dst.is_file()


def run_server(engine, smi: str) -> dict:
    """Phase 4e. The port's ``OmniServer`` in front of phase 4d's engine
    (release weights and both decoders) on 127.0.0.1 with SQLite history:
    the golden file, the tiled files and a 44.1 kHz stereo file served
    alone, then all four at once on the batch route (each result equal to
    the same file served alone), history and the five exports, the live
    route streaming the golden file (its result held to
    ``golden_decoders.json``); the K1-K3 launches over the serial requests;
    warm seconds
    through HTTP beside ``engine.transcribe``, and the batch route's wall
    seconds under the engine's device lock beside a lock around whole
    requests. Returns the serial requests' launches."""
    import io
    import re
    import tempfile
    import threading
    import zipfile

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.exporters import export_transcript
    from omnilingual_asr_torch.serving.app import OmniServer

    work = PKG / "_build" / "server"
    work.mkdir(parents=True, exist_ok=True)
    native = check_native(engine, work, smi)
    t120, t330 = (native["paths"][s] for s in SERVER_SECONDS)
    stereo = work / "golden_44k1_stereo.wav"
    write_resampled_stereo(golden.GOLDEN_WAV, stereo, 44_100)
    files = {"golden.wav": golden.GOLDEN_WAV, "t120.wav": t120,
             "golden_44k1_stereo.wav": stereo, "t330.wav": t330}
    mp3 = work / "golden.mp3"
    if native["libav"] and _mp3_of(golden.GOLDEN_WAV, mp3):
        files["golden.mp3"] = mp3
        log("  mp3: libav linked and ffmpeg made golden.mp3 here; it is "
            "served alone and on the batch route")
    else:
        log(f"  mp3: not served (libav linked: {native['libav']}, an MP3 "
            f"encoder here: {bool(native['libav'] and mp3.is_file())})")
    data = {name: p.read_bytes() for name, p in files.items()}

    L = engine.config.encoder.n_layers
    per_batch = {"log_mel_frames": 1, "flash_attention": L,
                 "fused_conv_module": L}
    counters = _counters()
    with tempfile.TemporaryDirectory(dir=work) as base:
        srv = OmniServer(engine=engine, base_dir=Path(base),
                         auth_required=False, use_sqlite=True)
        port = srv.serve_background("127.0.0.1", 0)
        try:
            # Serial requests, each file alone; the launches are read over
            # these only (the counters are not atomic across threads).
            for fn in counters:
                fn.launches = 0
            alone = {}
            for name in files:
                if name == "t120.wav":
                    continue
                alone[name] = json.loads(_post_files(
                    port, "/api/transcribe", [(name, data[name])]))
            body = _post_files(port, "/api/transcribe-stream",
                              [("t120.wav", data["t120.wav"])])
            events = _sse_events(body)
            steps = []
            for kind, d in events:
                if kind == "progress" and (not steps or steps[-1]
                                           != d["step"]):
                    steps.append(d["step"])
            if (steps != ["uploading", "transcribing", "processing", "done"]
                    or [k for k, _ in events].count("result") != 1
                    or events[-1][0] != "result"):
                raise PhaseError(f"server: stream events {steps} + "
                                 f"{[k for k, _ in events][-2:]}")
            alone["t120.wav"] = events[-1][1]
            launches = {fn.__name__: fn.launches for fn in counters}
            n_batches = _n_batches(engine, [files[n] for n in files
                                            if n.endswith(".wav")])
            if "golden.mp3" in files:
                n_batches += 1
            log(f"  server launches {json.dumps(launches)} over "
                f"{n_batches} batches of serial requests")
            for name, n in per_batch.items():
                if launches[name] != n * n_batches:
                    raise PhaseError(f"server: {name} launched "
                                     f"{launches[name]} times, expected {n} "
                                     f"a batch x {n_batches}")

            stored = golden.load_golden_decoders()
            g = alone["golden.wav"]
            bad = golden.result_mismatches(stored["result"], g,
                                           tone_mass=stored["tone_mass"])
            if g.get("summary") != stored["result"]["summary"]:
                bad.append(f"summary {g.get('summary')!r}")
            if ([s.get("translation") for s in g["segments"]]
                    != [s["translation"]
                        for s in stored["result"]["segments"]]):
                bad.append("translations differ")
            if bad:
                raise PhaseError("server: golden entry mismatch: "
                                 + "; ".join(bad))
            log(f"  server golden: {len(g['segments'])} segments equal "
                f"golden_decoders.json (translations and summary exact)")

            # The batch route: the four files at once, the stereo one
            # inside a .zip; each result equals the file served alone.
            zbuf = io.BytesIO()
            with zipfile.ZipFile(zbuf, "w") as z:
                z.writestr("golden_44k1_stereo.wav",
                           data["golden_44k1_stereo.wav"])
            upload = [(n, data[n]) for n in files
                      if n != "golden_44k1_stereo.wav"]
            upload.insert(2, ("batch.zip", zbuf.getvalue()))

            def batch_route():
                t0 = time.perf_counter()
                body = _post_files(port, "/api/transcribe-batch-stream",
                                  upload, field="files")
                secs = time.perf_counter() - t0
                events = _sse_events(body)
                errors = [d for k, d in events if d.get("step") == "error"]
                if errors or events[-1][0] != "result":
                    raise PhaseError(f"server: batch route errors {errors}")
                return events[-1][1]["results"], secs

            results, _ = batch_route()
            by_name = {r["file_name"]: r for r in results}
            if sorted(by_name) != sorted(files):
                raise PhaseError(f"server: batch results for "
                                 f"{sorted(by_name)}, want {sorted(files)}")
            for name in files:
                if _stable(by_name[name]) != _stable(alone[name]):
                    raise PhaseError(f"server: {name} on the batch route "
                                     f"differs from the file served alone")
            log(f"  server batch route: {len(files)} files at once (one in "
                f"a .zip) equal the same files served alone")

            # History and the five exports of every stored entry.
            status, listed = _http(port, "GET", "/api/history")
            listed = json.loads(listed)
            if status != 200 or len(listed) != 2 * len(files):
                raise PhaseError(f"server: history lists {len(listed)} "
                                 f"entries, want {2 * len(files)}")
            for item in listed:
                status, entry = _http(port, "GET",
                                      f"/api/history/{item['id']}")
                entry = json.loads(entry)
                for fmt in EXPORT_FORMATS:
                    status, got = _http(
                        port, "GET",
                        f"/api/history/{item['id']}/export?format={fmt}")
                    kw = {}
                    if fmt == "eaf":
                        kw["date"] = re.search(rb'DATE="([^"]*)"',
                                               got)[1].decode()
                    want = export_transcript(entry, fmt, **kw)
                    if status != 200 or got != want.encode("utf-8"):
                        raise PhaseError(f"server: the {fmt} export of "
                                         f"{item['file_name']} differs from "
                                         f"export_transcript")
            log(f"  server history: {len(listed)} entries; all five exports "
                f"of each equal export_transcript on the stored entry")

            # The live route streams the golden file: progress, one
            # segments event (one batch), the entry held to the fixture.
            events = _sse_events(_post_files(
                port, "/api/transcribe-stream-live",
                [("g.wav", data["golden.wav"])]))
            kinds = [k for k, _ in events]
            live = events[-1][1]
            bad = golden.result_mismatches(stored["result"], live,
                                           tone_mass=stored["tone_mass"])
            if (kinds.count("segments") != 1 or kinds[-1] != "result"
                    or "error" in kinds):
                bad.append(f"events {kinds}")
            if live.get("summary") != stored["result"]["summary"]:
                bad.append(f"summary {live.get('summary')!r}")
            if ([s.get("translation") for s in live["segments"]]
                    != [s["translation"]
                        for s in stored["result"]["segments"]]):
                bad.append("translations differ")
            if bad:
                raise PhaseError("server: live route mismatch: "
                                 + "; ".join(bad))
            log(f"  server live route: {kinds.count('progress')} progress "
                f"events, 1 segments event, a result equal to "
                f"golden_decoders.json")

            # Warm seconds a request: HTTP against engine.transcribe.
            for name in ("golden.wav", "t120.wav"):
                http_s, direct_s = [], []
                for _ in range(SERVER_ROUNDS):
                    t0 = time.perf_counter()
                    _post_files(port, "/api/transcribe",
                               [(name, data[name])])
                    http_s.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    engine.transcribe(files[name])
                    direct_s.append(time.perf_counter() - t0)
                log("  server seconds " + json.dumps({
                    "request": name, "rounds": SERVER_ROUNDS,
                    "http_s_median": statistics.median(http_s),
                    "direct_s_median": statistics.median(direct_s),
                    "http_s": http_s, "direct_s": direct_s, "card": smi}))

            # The lock's cost on the batch route: the four files at once
            # under the device lock, then under a lock around each whole
            # request, beside the same files served one after another.
            whole = threading.Lock()
            plain = engine.transcribe

            def whole_request(*a, **kw):
                with whole:
                    return plain(*a, **kw)

            secs = {"device_lock_s": [], "whole_request_lock_s": [],
                    "serial_s": []}
            for _ in range(SERVER_ROUNDS):
                secs["device_lock_s"].append(batch_route()[1])
                engine.transcribe = whole_request
                try:
                    secs["whole_request_lock_s"].append(batch_route()[1])
                finally:
                    del engine.transcribe
                t0 = time.perf_counter()
                for name in files:
                    _post_files(port, "/api/transcribe",
                               [(name, data[name])])
                secs["serial_s"].append(time.perf_counter() - t0)
            log("  server batch seconds " + json.dumps({
                "files": len(files), "rounds": SERVER_ROUNDS,
                **{f"{k}_median": statistics.median(v)
                   for k, v in secs.items()}, **secs, "card": smi}))
        finally:
            srv.shutdown()
            srv.app._httpd.server_close()
    return launches


# ---------------------------------------------------------------------------
# Phase 4b: kernel-mode training through train_synth
# ---------------------------------------------------------------------------

def _drive_train_synth(label, dev, steps, first=None, **train_kwargs):
    """``train_synth`` in kernel mode for ``steps`` steps at
    ``PipelineConfig()`` dims, batch TRAIN_BATCH. For this run only, a
    subclass of ``SynthBatcher`` times the host's wait for each batch, and
    the train step that ``make_train_step`` returns is wrapped to read the
    launch counts (exactly K1 once, K2, K3, K6 and K7 once a layer) and
    the parameters after each update; ``first(params, opt_state)`` sees
    the parameters and the optimizer before the first. Returns (launches of each kernel,
    parameter snapshots after steps 1 and 2, the best score)."""
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.train import synth_train
    from omnilingual_asr_torch.train.step import tree_leaves

    L = PipelineConfig().encoder.n_layers
    per_step = {"log_mel_frames": 1, "flash_attention": L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "fused_conv_module": L, "quantized_matmul": 0,
                "quantized_matmul_a8": 0}
    waits = []

    class TimedBatcher(synth_train.SynthBatcher):
        def __next__(self):
            t0 = time.perf_counter()
            batch = super().__next__()
            waits.append(time.perf_counter() - t0)
            return batch

    total = {k: 0 for k in per_step}
    snaps, times = [], [time.perf_counter()]
    steps_seen = []

    def after_step(step, params, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = _read_counters()
        m = {k: float(v) for k, v in metrics.items()}
        log(f"  {label} step " + json.dumps({
            "step": step, **m, "step_s": now - times[-1],
            "batch_wait_s": waits[-1], "launches": counts}))
        times.append(now)
        if not all(math.isfinite(v) for v in m.values()):
            raise PhaseError(f"{label} step {step}: non-finite metrics {m}")
        for name, n in per_step.items():
            if counts[name] != n:
                raise PhaseError(f"{label} step {step}: {name} launched "
                                 f"{counts[name]} times, expected {n}")
            total[name] += counts[name]
        steps_seen.append(step)
        if len(steps_seen) <= 2:
            snaps.append([p.detach().clone() for p in tree_leaves(params)])

    make_train_step = synth_train.make_train_step

    def watched_make_train_step(*args, **kwargs):
        init_state, train_step, loss_and_grads = make_train_step(*args,
                                                                 **kwargs)

        def watched_train_step(params, opt_state, batch, step):
            if first is not None and not steps_seen:
                first(params, opt_state)
            out = train_step(params, opt_state, batch, step)
            after_step(step + 1, out[0], out[3])
            return out

        return init_state, watched_train_step, loss_and_grads

    _read_counters()
    synth_batcher = synth_train.SynthBatcher
    synth_train.SynthBatcher = TimedBatcher
    synth_train.make_train_step = watched_make_train_step
    try:
        params, best = synth_train.train_synth(
            steps=steps, batch_size=TRAIN_BATCH, cfg=PipelineConfig(),
            seed=SEED, pallas_kernels=True, device=dev, log_every=1,
            eval_every=1000, **train_kwargs)
    finally:
        synth_train.SynthBatcher = synth_batcher
        synth_train.make_train_step = make_train_step
    torch.cuda.synchronize()
    log(f"  {label}: evaluation launches {json.dumps(_read_counters())}; "
        f"best synth WER {best}; host batch waits "
        f"{[round(w, 4) for w in waits]} s")
    if len(steps_seen) != steps:
        raise PhaseError(f"{label}: {len(steps_seen)} train steps were "
                         f"watched, expected {steps}")
    return total, snaps, best


def run_train(dev):
    """``train_synth`` with ``pallas_kernels=True`` for TRAIN_STEPS steps at
    ``PipelineConfig()`` dims from a seeded init, each step's launches
    exact (:func:`_drive_train_synth`). Returns the training path's
    launches of each kernel."""
    import torch

    total, snaps, _ = _drive_train_synth("train", dev, TRAIN_STEPS)
    moved = sum(int(not torch.equal(a, b)) for a, b in zip(*snaps))
    if moved == 0:
        raise PhaseError("the parameters after step 2 equal those after "
                         "step 1 (the first update has learning rate 0, the "
                         "second must move them)")
    log(f"  {moved} of {len(snaps[0])} parameter leaves moved in step 2")
    return total


def grad_check(dev):
    """One batch of 2 windows at ``PipelineConfig()`` dims through the
    kernels on the card (K1-K3, K6, K7) against the same step on the CPU
    (plain versions) from the same parameters: per-leaf relative L2 error
    of the gradients. Beside it, the card's own floor (the same step with
    the parameters perturbed by 1e-6 relative) and a planted fault (the
    same step with delta dropped from the flash backward, so that K6 and K7
    compute p * dp for p * (dp - delta)), which must miss the tolerance."""
    import dataclasses

    import numpy as np
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.ops import attention as A
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_train_step,
                                                  tree_leaves, tree_map)
    from omnilingual_asr_torch.train.synth import SynthBatcher

    cfg = PipelineConfig()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, use_flash_attention=True, use_fused_conv=True))
    mult = A.REFERENCE_BLOCK_Q * cfg.encoder.subsample_factor
    batcher = SynthBatcher(cfg, batch_size=2, seed=SEED + 5,
                           frame_multiple=mult, n_threads=1)
    try:
        batch = next(iter(batcher))
    finally:
        batcher.close()
    batch["samples"] = np.clip(batch["samples"] * 32768.0, -32768,
                               32767).astype(np.int16)
    grads = {}
    params = None
    for where in (dev, torch.device("cpu")):
        init, _, loss_and_grads = make_train_step(
            cfg, where, from_samples=True, with_translator=True)
        if params is None:
            params = init(SEED).params
        p = tree_map(lambda t: t.detach().to(where).requires_grad_(True),
                     params)
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        b[CTC_INFEASIBLE] = ctc_rows(batch, cfg)
        t0 = time.perf_counter()
        metrics, g = loss_and_grads(p, b, 0)
        grads[where.type] = [x.detach().cpu() if x is not None
                             else torch.zeros_like(y.cpu())
                             for x, y in zip(g, tree_leaves(p))]
        log(f"  grad check {where.type}: loss "
            f"{float(metrics['loss']):.6f} ({time.perf_counter() - t0:.2f} s)")
        if where.type == "cuda":      # the card's own floor, see above
            gen = torch.Generator(device=where).manual_seed(SEED)
            q = tree_map(lambda t: (t.detach() * (1 + 1e-6 * torch.randn(
                t.shape, generator=gen, device=where))).requires_grad_(True),
                p)
            _, g2 = loss_and_grads(q, b, 0)
            grads["floor"] = [x.detach().cpu() if x is not None
                              else torch.zeros_like(y.cpu())
                              for x, y in zip(g2, tree_leaves(q))]
            flash_delta = A.flash_delta           # the planted fault
            A.flash_delta = lambda o, do: torch.zeros_like(flash_delta(o,
                                                                       do))
            try:
                _, g3 = loss_and_grads(p, b, 0)
            finally:
                A.flash_delta = flash_delta
            grads["fault"] = [x.detach().cpu() if x is not None
                              else torch.zeros_like(y.cpu())
                              for x, y in zip(g3, tree_leaves(p))]

    def worst_of(got, want):
        worst, worst_i = 0.0, -1
        for i, (a, b) in enumerate(zip(got, want)):
            nb = float(b.norm())
            err = float((a - b).norm()) / nb if nb > 0 else float(a.norm())
            if not math.isfinite(err):
                raise PhaseError(f"grad check: leaf {i} is not finite")
            if err > worst:
                worst, worst_i = err, i
        return worst, worst_i

    worst, worst_i = worst_of(grads["cuda"], grads["cpu"])
    floor, floor_i = worst_of(grads["floor"], grads["cuda"])
    fault, fault_i = worst_of(grads["fault"], grads["cpu"])
    log(f"  grad check: worst per-leaf relative L2 error {worst:.3e} (leaf "
        f"{worst_i} of {len(grads['cpu'])}; tol {TOL_GRAD_REL}); the card's "
        f"own floor under a 1e-6 perturbation {floor:.3e} (leaf {floor_i}); "
        f"with delta dropped from the flash backward {fault:.3e} (leaf "
        f"{fault_i})")
    if worst > TOL_GRAD_REL:
        raise PhaseError(f"grad check: leaf {worst_i} relative error "
                         f"{worst:.3e} > {TOL_GRAD_REL}")
    if fault <= TOL_GRAD_REL:
        raise PhaseError(f"grad check: with delta dropped from the flash "
                         f"backward the worst leaf reads {fault:.3e}, within "
                         f"the tolerance {TOL_GRAD_REL}: the check cannot "
                         f"see such a fault")


# ---------------------------------------------------------------------------
# Phase 4h: the release's other trainers (x-vector, text and audio
# translators, summarizer)
# ---------------------------------------------------------------------------

# The trainers' runs, cut to fit the phase: (steps, batch) and the data.
XV_STEPS, XV_BATCH = 8, 64            # the full 48-utterance eval at step 8
TT_STEPS, TT_BATCH, TT_EVAL = 20, 128, 64
AT_STEPS, AT_BATCH, AT_TRAIN, AT_EVAL = 20, 64, 256, 32
SM_STEPS, SM_BATCH, SM_POOL, SM_TRAIN, SM_EVAL = 20, 32, 96, 64, 8
# One update on the card against the same update on the CPU: the gradients
# per leaf within TOL_GRAD_REL (phase 4b's criterion) and the loss within
# TOL_TRAINER_LOSS_REL (f32 sums in another order; bf16 roundings of the
# x-vector's convolution inputs flipped by them).
TOL_TRAINER_LOSS_REL = 1e-3


def _trainer_update_check(label, dev, loss, params, args_on,
                          loss_tol=TOL_TRAINER_LOSS_REL) -> dict:
    """The gradient of ``loss(params, *args_on(device))`` on the card and
    on the CPU from the same parameters and batch, leaf by leaf."""
    import torch
    from omnilingual_asr_torch.train.step import (tree_leaves, trainable,
                                                  value_and_grads)

    def run(where):
        p = trainable(params, where)
        value, grads = value_and_grads(loss, p, *args_on(where))
        return float(value), [torch.zeros(x.shape) if g is None
                              else g.detach().cpu()
                              for g, x in zip(grads, tree_leaves(p))]

    return _compare_on_devices(label, dev, run, loss_tol)


def _compare_on_devices(label, dev, run, loss_tol) -> dict:
    """``run(device)`` -> (loss, gradient leaves on the CPU), on the card
    and on the CPU: every leaf within TOL_GRAD_REL relative L2 and the loss
    within ``loss_tol`` relative, or the phase fails."""
    import torch

    got = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        value, grads = run(where)
        got.append((value, grads, time.perf_counter() - t0))
    (lc, gc, tc), (lp, gp, tp) = got
    worst, worst_i = 0.0, -1
    for i, (a, b) in enumerate(zip(gc, gp)):
        nb = float(b.norm())
        err = float((a - b).norm()) / nb if nb > 0 else float(a.norm())
        if not math.isfinite(err):
            raise PhaseError(f"{label}: gradient leaf {i} is not finite")
        if err > worst:
            worst, worst_i = err, i
    loss_rel = abs(lc - lp) / max(abs(lp), 1e-30)
    out = {"loss_cuda": lc, "loss_cpu": lp, "loss_rel": loss_rel,
           "grad_worst_rel": worst, "grad_worst_leaf": worst_i,
           "n_leaves": len(gp), "cuda_s": tc, "cpu_s": tp}
    if worst > TOL_GRAD_REL or loss_rel > loss_tol or not math.isfinite(lc):
        raise PhaseError(f"{label}: one update on the card against the CPU: "
                         f"{out} (tol {TOL_GRAD_REL} per leaf, loss "
                         f"{loss_tol})")
    return out


def _trainer_drive(label, fn, k1) -> tuple:
    """Drives one trainer: every launch count set to 0 and the card's peak
    memory reset just before ``fn()``, both read just after. Its losses
    must be finite, K1 launched ``k1`` times and no other kernel."""
    import torch

    _read_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, run = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want["log_mel_frames"] = k1
    if launches != want:
        raise PhaseError(f"{label}: launches {launches}, expected {want}")
    if not run.losses or not all(math.isfinite(x) for x in run.losses):
        raise PhaseError(f"{label}: losses {run.losses}")
    steps = len(run.losses)
    secs = {k: round(v, 4) for k, v in run.seconds.items()}
    log(f"  trainer {json.dumps({'trainer': label, 'wall_s': wall, 'steps': steps, 'steps_per_s': steps / run.seconds['steps'], 'seconds': secs, 'peak_card_gb': peak / 1e9, 'losses': [round(x, 4) for x in run.losses], 'evals': run.evals, 'launches': launches})}")
    return params, run, launches


def _loads_back(label, got, want, half=False) -> None:
    """The saved file's tree, loaded by the port's loader, equal to the
    trained parameters at the file's precision (f16 or f32)."""
    import torch
    from omnilingual_asr_torch.models.zoo import flatten

    a, b = flatten(got), flatten(want)
    if a.keys() != b.keys():
        raise PhaseError(f"{label}: the saved file's leaves differ")
    for k in a:
        w = b[k].detach().cpu()
        w = w.half().float() if half else w.float()
        if not torch.equal(a[k].cpu().float(), w):
            raise PhaseError(f"{label}: saved leaf {k} does not load back")


def run_trainers(dev, cfg, params, smi) -> dict:
    """Phase 4h. The four trainers the port lacked, each through its own
    functions on the card from a seeded init, cut as the constants above
    say: the x-vector (``PipelineConfig()``'s, batch 64 of 4 s, the eval
    at the last step), the text translator at the release's dims, the
    audio translator and the summarizer on the release ASR. Each must give
    finite losses, its count of K1 launches (one a x-vector step and eval
    batch, one a frozen-encoder batch of 64 utterances, one a
    conversation; no other kernel), one update equal to the CPU's, and a
    file that loads back. Then an engine with the trained x-vector,
    summarizer and each translator by explicit path answers the golden
    file with its structure whole. Returns the launches."""
    import tempfile

    import numpy as np
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.models.translation import (
        load_translator, text_translator_init, translator_init)
    from omnilingual_asr_torch.models.xvector import xvector_init
    from omnilingual_asr_torch.models.zoo import load_xvector
    from omnilingual_asr_torch.ops.mel import MelFrontend
    from omnilingual_asr_torch.train import summary_train as sm
    from omnilingual_asr_torch.train import text_translator_train as tt
    from omnilingual_asr_torch.train import translator_train as at
    from omnilingual_asr_torch.train import xvector_train as xv
    from omnilingual_asr_torch.train.synth import LEXICON_SIZE

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def gen():
        return torch.Generator().manual_seed(SEED)

    asr = str(RELEASE / "asr.npz")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # The x-vector: PipelineConfig()'s embedder, batch 64 of 4 s.
        xcfg = PipelineConfig()
        x0 = xvector_init(gen(), xcfg)
        n_eval = xv.EVAL_SPEAKERS * xv.EVAL_PER_SPEAKER
        xp, _, launches = _trainer_drive(
            "xvector", lambda: xv.train_xvector(
                steps=XV_STEPS, batch_size=XV_BATCH, seed=SEED,
                ckpt_dir=str(tmp / "xv"), log_every=XV_STEPS,
                eval_every=XV_STEPS, device=dev, init_params=x0),
            XV_STEPS + math.ceil(n_eval / XV_BATCH))
        add(launches)
        win = int(4.0 * xcfg.frontend.sample_rate)
        wf = xv.window_frames(xcfg, win)
        batch = xv.BatchPool(xcfg, batch_size=XV_BATCH, win=win, wf=wf,
                             seed=SEED + 1).next_batch()
        check = _trainer_update_check(
            "xvector", dev, xv.loss_fn, x0, lambda d: (
                MelFrontend(xcfg.frontend, d), *xv.batch_tensors(batch, d),
                wf))
        log(f"  xvector update on the card against the CPU {json.dumps(check)}")
        _loads_back("xvector", load_xvector(tmp / "xv" / "xvector.npz",
                                            xcfg), xp, half=True)

        # The text translator at the release's dims (no real corpus where
        # humanize/babel give none).
        t0_params = text_translator_init(gen(), cfg, n_layers=4)
        tp, _, launches = _trainer_drive(
            "text_translator", lambda: tt.train_translator(
                str(tmp / "tt.npz"), steps=TT_STEPS, batch_size=TT_BATCH,
                n_eval=TT_EVAL, seed=SEED, eval_every=TT_STEPS,
                log_every=TT_STEPS, cfg=cfg, device=dev,
                init_params=t0_params), 0)
        add(launches)
        tables, english = tt._lang_tables()
        batch = tt.make_batch(np.random.default_rng(SEED), tables, english,
                              LEXICON_SIZE, cfg.vocab, TT_BATCH, noise=True,
                              g=tt._grammar_tables(tables, english))
        check = _trainer_update_check(
            "text_translator", dev, tt.loss_fn, t0_params,
            lambda d: (*tt.batch_tensors(batch, d), cfg))
        log(f"  text_translator update on the card against the CPU "
            f"{json.dumps(check)}")
        _loads_back("text_translator", load_translator(tmp / "tt.npz", cfg),
                    tp)

        # The audio translator on the release ASR (its bank kept for the
        # update check).
        banks = {}

        def keep(inner, key):
            def wrapped(*args, **kwargs):
                out = inner(*args, **kwargs)
                banks[key] = out
                return out
            return wrapped

        a0 = translator_init(gen(), cfg, n_layers=4)
        build_bank = at.build_bank
        at.build_bank = keep(build_bank, "translator")
        try:
            ap, _, launches = _trainer_drive(
                "translator", lambda: at.train_translator(
                    asr_ckpt=asr, out_dir=str(tmp / "at"), steps=AT_STEPS,
                    batch_size=AT_BATCH, n_train=AT_TRAIN, n_eval=AT_EVAL,
                    seed=SEED, cfg=cfg, log_every=AT_STEPS, device=dev,
                    init_params=a0),
                math.ceil((AT_TRAIN + AT_EVAL) / at.ENCODE_BATCH))
        finally:
            at.build_bank = build_bank
        add(launches)
        bank = banks["translator"][0]
        idx = torch.arange(AT_BATCH)
        check = _trainer_update_check(
            "translator", dev, at.loss_fn, a0, lambda d: (
                tuple(b.to(d) for b in bank), idx.to(d), cfg))
        log(f"  translator update on the card against the CPU "
            f"{json.dumps(check)}")
        _loads_back("translator", load_translator(
            tmp / "at" / "translator.npz", cfg), ap)

        # The summarizer on the release ASR.
        s0 = translator_init(gen(), cfg, n_layers=2)
        build_bank = sm.build_bank
        sm.build_bank = keep(build_bank, "summarizer")
        try:
            sp, _, launches = _trainer_drive(
                "summarizer", lambda: sm.train_summarizer(
                    asr_ckpt=asr, out_dir=str(tmp / "sm"), steps=SM_STEPS,
                    batch_size=SM_BATCH, pool_size=SM_POOL,
                    n_train=SM_TRAIN, n_eval=SM_EVAL, seed=SEED, cfg=cfg,
                    log_every=SM_STEPS, device=dev, init_params=s0),
                SM_TRAIN + SM_EVAL)
        finally:
            sm.build_bank = build_bank
        add(launches)
        bank = banks["summarizer"][0]
        rows = torch.arange(SM_BATCH)
        check = _trainer_update_check(
            "summarizer", dev, sm.loss_fn, s0, lambda d: (
                *(b.to(d)[rows.to(d)] for b in bank), cfg))
        log(f"  summarizer update on the card against the CPU "
            f"{json.dumps(check)}")
        _loads_back("summarizer", load_translator(
            tmp / "sm" / "summarizer.npz", cfg, n_layers=2), sp)

        # The trained files serve the golden file through the engine.
        for label, translator in (("text", tmp / "tt.npz"),
                                  ("audio", tmp / "at" / "translator.npz")):
            t0 = time.perf_counter()
            engine = TranscriptionEngine(
                config=cfg, params=params, device=dev,
                xvector_params=load_xvector(tmp / "xv" / "xvector.npz",
                                            cfg, dev),
                translator_path=str(translator),
                summarizer_path=str(tmp / "sm" / "summarizer.npz"))
            rows = []
            decode = engine._translator.decode

            def counting(enc, *args, **kwargs):
                rows.append(enc.shape[0])
                return decode(enc, *args, **kwargs)

            engine._translator.decode = counting
            res = engine.transcribe(golden.GOLDEN_WAV).to_dict()
            segs = res["segments"]
            foreign = [s for s in segs if s["language_code"] != "en"]
            if (not segs or not foreign or not rows
                    or sum(rows) < len(foreign)
                    or not isinstance(res["summary"], str)
                    or not res["summary"]
                    or any(s["translation"] is not None for s in segs
                           if s["language_code"] == "en")):
                raise PhaseError(f"trainers: the engine with the {label} "
                                 f"translator answered {res}")
            log(f"  engine with the trained files ({label} translator): "
                f"{len(segs)} segments, {len(foreign)} non-English, "
                f"{sum(rows)} spans decoded, translations "
                f"{[s['translation'] for s in foreign]}, summary "
                f"{res['summary']!r} ({time.perf_counter() - t0:.2f} s)")
    log(f"  trainers launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4i: the rest of training (BEST-RQ pretraining, the device pool, the
# manifest trainer, AED)
# ---------------------------------------------------------------------------

# The runs, cut in steps and data to fit the phase (PERF.md section 4).
PRE_STEPS, PRE_BATCH, PRE_WARMUP = 12, 64, 2   # pretrain_main's defaults
POOL_STEPS, POOL_BATCH, POOL_SIZE, POOL_REFRESH = 20, 16, 512, 5
MAN_FILES, MAN_BATCH, MAN_STEPS, MAN_PRE_STEPS = 48, 16, 6, 4
MAN_WINDOW_SECONDS = 15.0
AED_STEPS, AED_BATCH, AED_LAYERS, AED_MAX_LEN = 10, 16, 4, 256
# Rows of each card-vs-CPU update (the CPU runs d512 x 12 on them).
CHECK_ROWS = 2
# One update on the card against the CPU: the loss within this, relative
# (the gradients within TOL_GRAD_REL, phase 4b's criterion).
TOL_REST_LOSS_REL = 1e-4


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield value
    finally:
        setattr(obj, name, old)


def _timed(parts, key, fn):
    """``fn`` adding its wall seconds to ``parts[key]``."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
    return timed


def _timed_batches(cls, parts, key="synth"):
    """A subclass of a batch iterator whose waits for a batch add to
    ``parts[key]``."""
    class Timed(cls):
        def __next__(self):
            t0 = time.perf_counter()
            try:
                return super().__next__()
            finally:
                parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
    return Timed


def _one_producer(cls):
    """A batcher class that draws with one producer thread, whatever the
    caller asks: its batches come in the order of its one seeded
    generator."""
    class Ordered(cls):
        def __init__(self, *args, **kwargs):
            kwargs["n_threads"] = 1
            super().__init__(*args, **kwargs)
    return Ordered


def _per_step(k1=0, flash=0):
    """Launches of each kernel a step: ``flash`` counts K2, K3, K6 and K7
    (one each a layer in kernel mode); K3 split over a model axis none."""
    return {"log_mel_frames": k1, "flash_attention": flash,
            "fused_conv_module": flash, "quantized_matmul": 0,
            "quantized_matmul_a8": 0, "flash_attention_bwd_dq": flash,
            "flash_attention_bwd_dkv": flash, "fused_conv_module_split": 0}


class _StepWatch:
    """Wraps a train step: each call waited for, its seconds, its metrics
    (finite, or the phase fails) and the launches since the previous step
    ended (``want`` of each kernel exactly, every kernel it does not name
    0, or the phase fails)."""

    def __init__(self, label, want):
        self.label = label
        self.want = {**{fn.__name__: 0 for fn in _counters()}, **want}
        want = self.want
        self.rows, self.seconds = [], 0.0
        self.last = {k: 0 for k in want}

    def wrap(self, fn):
        import torch

        def watched(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            now = _read_counters(reset=False)
            n = {k: now[k] - self.last[k] for k in now}
            self.last = now
            m = {k: float(v) for k, v in out[3].items()}
            self.seconds += secs
            self.rows.append({"step": len(self.rows) + 1, "step_s": secs,
                              **m})
            if not all(math.isfinite(v) for v in m.values()):
                raise PhaseError(f"{self.label} step {len(self.rows)}: "
                                 f"metrics {m}")
            if n != self.want:
                raise PhaseError(f"{self.label} step {len(self.rows)}: "
                                 f"launches {n}, expected {self.want}")
            return out
        return watched

    def factory(self, make, captured):
        """``make`` (a make_*_step) whose init state is kept in
        ``captured`` (and a CPU copy of its first parameters in
        ``self.initial``) and whose step (the second element) is
        watched."""
        def made(*args, **kwargs):
            out = list(make(*args, **kwargs))
            init = out[0]

            def init_state(seed=0):
                from omnilingual_asr_torch.train.step import tree_map

                captured.append(init(seed))
                st = captured[-1]
                p = st.params if hasattr(st, "params") else st[0]
                if hasattr(p, "full"):          # a mesh's MeshParams
                    p = p.full()
                self.initial = tree_map(
                    lambda t: t.detach().cpu().clone(), p)
                return st

            out[0], out[1] = init_state, self.wrap(out[1])
            return tuple(out)
        return made

    def losses(self):
        return [r["loss"] for r in self.rows]


def _rest_drive(label, fn, parts, watch):
    """Drives one run: every launch count set to 0 and the card's peak
    memory reset just before ``fn()``, both read just after; logs the run's
    seconds by part, steps a second and peak memory. Returns (fn's result,
    launches)."""
    import torch

    _read_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    steps = len(watch.rows)
    parts = dict(parts, steps=watch.seconds)
    if not steps:
        raise PhaseError(f"{label}: no step was watched")
    step_s = sorted(r["step_s"] for r in watch.rows)
    log("  rest " + json.dumps({
        "run": label, "wall_s": wall, "steps": steps,
        "steps_per_s": steps / watch.seconds,
        "step_s_median": step_s[len(step_s) // 2],
        "seconds": {k: round(v, 4) for k, v in parts.items()},
        "peak_card_gb": peak / 1e9,
        "losses": [round(x, 4) for x in watch.losses()],
        "launches": launches}))
    return out, launches


def _write_manifest(root: Path, n: int) -> Path:
    """n seeded synthetic utterances (``eval_set``) as 16 kHz int16 WAVs and
    a JSONL manifest of them."""
    import numpy as np
    from omnilingual_asr_torch.train.synth import SAMPLE_RATE, eval_set

    root.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, ex in enumerate(eval_set(n, seed=SEED + 40)):
        pcm = (np.clip(ex.samples, -1.0, 1.0) * 32767).astype(np.int16)
        with wave.open(str(root / f"u{i:03d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLE_RATE)
            w.writeframes(pcm.tobytes())
        lines.append(json.dumps({"audio": f"u{i:03d}.wav", "text": ex.text,
                                 "language": ex.language,
                                 "emotion": ex.emotion}))
    path = root / "manifest.jsonl"
    path.write_text("\n".join(lines) + "\n")
    return path


def run_rest_of_training(dev, smi) -> dict:
    """Phase 4i. The rest of training at ``PipelineConfig()`` width, each
    run cut as the constants above say: (a) ``pretrain_main`` at its
    defaults (batch 64 of 8 s, the mu-law wire, English sentences at 0.65,
    a codebook of 8192 x 16), its checkpoint then warm-starting one
    ``train_synth --init-encoder`` step; (b) ``train_synth`` in kernel mode
    with a device pool of 512 on the mu-law wire, English sentences at
    0.65, refreshed every 5 steps; (c) the manifest trainer (``cli.train``,
    then ``cli.pretrain``) over 48 written WAVs; (d) AED's joint loss for 10
    steps, then its greedy decode. Each run: finite losses, exact launches
    a step, its seconds by part; (a), (b) and (d) one update on the card
    against the CPU; the checkpoints load back. Returns the launches."""
    import dataclasses
    import tempfile

    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.models import zoo
    from omnilingual_asr_torch.models.aed import (aed_greedy_decode,
                                                  aed_init, aed_loss)
    from omnilingual_asr_torch.ops.attention import REFERENCE_BLOCK_Q
    from omnilingual_asr_torch.ops.mel import MelFrontend
    from omnilingual_asr_torch.train import cli, device_pool
    from omnilingual_asr_torch.train import pretrain as pre
    from omnilingual_asr_torch.train import pretrain_cli, synth_train
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_optimizer,
                                                  mel_from_samples,
                                                  train_update, trainable,
                                                  tree_leaves, tree_map)
    from omnilingual_asr_torch.train.synth import SynthBatcher

    cfg = PipelineConfig()
    L = cfg.encoder.n_layers
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def on(tree, where):
        return tree_map(lambda t: t.detach().to(where), tree)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) BEST-RQ pretraining at pretrain_main's defaults.
        parts, captured = {}, []
        watch = _StepWatch("pretrain", _per_step(k1=1))
        with contextlib.ExitStack() as st:
            st.enter_context(_patched(
                pretrain_cli, "make_pretrain_step",
                watch.factory(pretrain_cli.make_pretrain_step, captured)))
            # One producer thread: one seeded generator hands the batches
            # over in one order, so every call trains on the same stream
            # (pretrain_main's own 2 threads fill one queue in timing
            # order, and the gate below read differently call to call).
            st.enter_context(_patched(pretrain_cli, "SynthBatcher",
                                      _timed_batches(_one_producer(
                                          SynthBatcher), parts)))
            st.enter_context(_patched(zoo, "save_checkpoint", _timed(
                parts, "save", zoo.save_checkpoint)))
            st.enter_context(_patched(pretrain_cli, "save_train_state",
                                      _timed(parts, "save",
                                             pretrain_cli.save_train_state)))
            _, launches = _rest_drive("pretrain", lambda: (
                pretrain_cli.pretrain_main(
                    steps=PRE_STEPS, batch_size=PRE_BATCH, cfg=cfg,
                    warmup_steps=PRE_WARMUP, ckpt_dir=str(tmp / "bestrq"),
                    seed=SEED, log_every=PRE_STEPS, save_every=PRE_STEPS,
                    device=dev)), parts, watch)
        add(launches)
        losses = watch.losses()
        if not losses[-1] < losses[0]:
            raise PhaseError(f"pretrain: the masked CE did not fall over "
                             f"{PRE_STEPS} steps: {losses}")
        if launches["log_mel_frames"] != PRE_STEPS:
            raise PhaseError(f"pretrain: launches {launches}")
        params, quantizer, _ = captured[0]
        init_params = watch.initial
        last = tmp / "bestrq" / "last"
        for name in ("head.npz", "config.json", "train_state.npz"):
            if not (last / name).is_file():
                raise PhaseError(f"pretrain: no {name} in {last}")
        _loads_back("pretrain", zoo.load_checkpoint(last / "asr.npz", cfg),
                    params["encoder"])
        # One update on the card against the CPU: the same mu-law rows, mel
        # and targets from the CPU, the step's draws from the CPU.
        pcfg = pre.PretrainConfig()
        b = SynthBatcher(cfg, batch_size=CHECK_ROWS, seed=SEED + 31,
                         n_threads=1, english_sentence_p=0.65,
                         real_fraction=0.0)
        try:
            hb = next(iter(b))
        finally:
            b.close()
        cpu = torch.device("cpu")
        mel_b = mel_from_samples(
            {"samples": torch.from_numpy(device_pool.encode_wire(
                hb["samples"], "mulaw")),
             "mask": torch.from_numpy(hb["mask"])},
            MelFrontend(cfg.frontend, cpu))
        q_cpu = on(quantizer, cpu)
        targets = pre.quantize_targets(q_cpu, mel_b["mel"],
                                       cfg.encoder.subsample_factor)
        draws = pre.step_draws(0, *hb["mask"].shape, cfg, pcfg, cpu)
        check = _trainer_update_check(
            "pretrain", dev, lambda p, *a: pre.pretrain_loss(p, *a)[0],
            init_params, lambda d: (
                on(q_cpu, d), on(mel_b, d), draws[0].to(d), draws[1].to(d),
                cfg, pcfg, targets.to(d)), loss_tol=TOL_REST_LOSS_REL)
        log(f"  pretrain update on the card against the CPU "
            f"{json.dumps(check)}")

        # (a2) The pretrained encoder warm-starts supervised training: one
        # step at learning rate 0 leaves the trunk equal to the file.
        parts, captured = {}, []
        watch = _StepWatch("init_encoder", _per_step(k1=1))
        with _patched(synth_train, "make_train_step", watch.factory(
                synth_train.make_train_step, captured)):
            (sp, _), launches = _rest_drive(
                "init_encoder", lambda: synth_train.train_synth(
                    steps=1, batch_size=TRAIN_BATCH, cfg=cfg, seed=SEED,
                    init_encoder=str(last / "asr.npz"), device=dev,
                    log_every=1, eval_every=1000), parts, watch)
        add(launches)
        _loads_back("init_encoder", zoo.load_checkpoint(last / "asr.npz",
                                                        cfg), sp["asr"])

        # (b) The device pool in kernel mode on the mu-law wire.
        parts, captured, pool_seen = {}, [], {}
        watch = _StepWatch("device_pool", _per_step(k1=1, flash=L))
        to_device = synth_train.pool_to_device

        def keep_pool(pool_np, where):
            t0 = time.perf_counter()
            pool = to_device(pool_np, where)
            torch.cuda.synchronize()
            parts["upload"] = time.perf_counter() - t0
            pool_seen.update(pool=pool, ptrs={
                k: v.data_ptr() for k, v in pool.items()})
            return pool

        class TimedEval(synth_train.Evaluator):
            def run(self, params):
                return _timed(parts, "eval", super().run)(params)

        with contextlib.ExitStack() as st:
            st.enter_context(_patched(
                synth_train, "make_pool_train_step",
                watch.factory(synth_train.make_pool_train_step, captured)))
            st.enter_context(_patched(synth_train, "SynthBatcher",
                                      _timed_batches(SynthBatcher, parts)))
            st.enter_context(_patched(synth_train, "build_pool", _timed(
                parts, "bake", synth_train.build_pool)))
            st.enter_context(_patched(synth_train, "pool_to_device",
                                      keep_pool))
            st.enter_context(_patched(synth_train, "Evaluator", TimedEval))
            _, launches = _rest_drive("device_pool", lambda: (
                synth_train.train_synth(
                    steps=POOL_STEPS, batch_size=POOL_BATCH, cfg=cfg,
                    seed=SEED, pallas_kernels=True, device_pool=POOL_SIZE,
                    pool_refresh_every=POOL_REFRESH, wire="mulaw",
                    english_sentences=0.65, device=dev,
                    log_every=POOL_STEPS, eval_every=1000)), parts, watch)
        add(launches)
        pool = pool_seen["pool"]
        pool_bytes = sum(v.numel() * v.element_size() for v in pool.values())
        moved = [k for k, v in pool.items()
                 if v.data_ptr() != pool_seen["ptrs"][k]]
        if pool["samples"].dtype != torch.uint8 or moved or \
                pool["samples"].shape[0] != POOL_SIZE:
            raise PhaseError(f"device_pool: samples {pool['samples'].dtype} "
                             f"{tuple(pool['samples'].shape)}, reallocated "
                             f"{moved}")
        log(f"  device pool on the card: {pool_bytes / 1e6:.1f} MB "
            f"({json.dumps({k: [list(v.shape), str(v.dtype)] for k, v in pool.items()})}); "
            f"baked in {parts['bake']:.3f} s, uploaded in "
            f"{parts['upload']:.3f} s; refreshed in place "
            f"{POOL_STEPS // POOL_REFRESH} times")
        # One pool step on the card against the CPU: the same rows, the
        # gain, SNR and noise drawn on the CPU, SpecAugment off.
        kcfg = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, use_flash_attention=True, use_fused_conv=True))
        rows = {k: v[:CHECK_ROWS].cpu() for k, v in pool.items()}
        host = {k: v.numpy() for k, v in rows.items()}
        scalars = {"w_spk": 1.0, "w_trans": 1.0, "w_aug": 1.0,
                   "w_fce": 0.0, "w_ctc": 1.0,
                   CTC_INFEASIBLE: ctc_rows(host, kcfg)}
        gen = torch.Generator().manual_seed(SEED)
        draws = device_pool.augment_draws(gen, CHECK_ROWS,
                                          rows["samples"].shape[1],
                                          (15.0, 40.0), (0.7, 1.3))
        pool_params = watch.initial

        def pool_run(where):
            _, _, _, lg = device_pool.make_pool_train_step(
                kcfg, where, with_translator=True)
            p = trainable(pool_params, where)
            m, g = lg(p, on(rows, where),
                      torch.arange(CHECK_ROWS, device=where), 0, scalars,
                      tuple(x.to(where) for x in draws))
            return float(m["loss"]), [
                torch.zeros(x.shape) if y is None else y.detach().cpu()
                for y, x in zip(g, tree_leaves(p))]

        check = _compare_on_devices("device_pool", dev, pool_run,
                                    TOL_REST_LOSS_REL)
        log(f"  device-pool step on the card against the CPU "
            f"{json.dumps(check)}")

        # (c) The manifest trainer over written WAVs, then its pretrain mode.
        manifest = _write_manifest(tmp / "manifest", MAN_FILES)
        parts, captured = {}, []
        watch = _StepWatch("manifest_train", _per_step(k1=1))
        with contextlib.ExitStack() as st:
            st.enter_context(_patched(cli, "make_train_step", watch.factory(
                cli.make_train_step, captured)))
            st.enter_context(_patched(cli, "BatchLoader", _timed_batches(
                cli.BatchLoader, parts, "load")))
            st.enter_context(_patched(cli, "save_checkpoint", _timed(
                parts, "save", cli.save_checkpoint)))
            mp, launches = _rest_drive("manifest_train", lambda: cli.train(
                str(manifest), steps=MAN_STEPS, batch_size=MAN_BATCH,
                cfg=cfg, window_seconds=MAN_WINDOW_SECONDS,
                ckpt=str(tmp / "man_asr.npz"), log_every=MAN_STEPS,
                seed=SEED, device=dev), parts, watch)
        add(launches)
        _loads_back("manifest_train", zoo.load_checkpoint(
            tmp / "man_asr.npz", cfg), mp)
        parts, captured = {}, []
        watch = _StepWatch("manifest_pretrain", _per_step(k1=1))
        with contextlib.ExitStack() as st:
            st.enter_context(_patched(pre, "make_pretrain_step",
                                      watch.factory(pre.make_pretrain_step,
                                                    captured)))
            st.enter_context(_patched(cli, "BatchLoader", _timed_batches(
                cli.BatchLoader, parts, "load")))
            st.enter_context(_patched(cli, "save_checkpoint", _timed(
                parts, "save", cli.save_checkpoint)))
            pp, launches = _rest_drive("manifest_pretrain", lambda: (
                cli.pretrain(str(manifest), steps=MAN_PRE_STEPS,
                             batch_size=MAN_BATCH, cfg=cfg,
                             window_seconds=MAN_WINDOW_SECONDS,
                             ckpt=str(tmp / "man_pre.npz"),
                             log_every=MAN_PRE_STEPS, seed=SEED,
                             device=dev)), parts, watch)
        add(launches)
        _loads_back("manifest_pretrain", zoo.load_checkpoint(
            tmp / "man_pre.npz", cfg), pp["encoder"])

        # (d) AED: joint CTC/CE steps on synthetic 8 s windows, then the
        # greedy decode.
        parts = {}
        watch = _StepWatch("aed", _per_step(k1=1))
        a0 = aed_init(torch.Generator().manual_seed(SEED), cfg,
                      decoder_layers=AED_LAYERS)
        fe = MelFrontend(cfg.frontend, dev)
        batches = []

        def aed_run():
            params = trainable(a0, dev)
            tx = make_optimizer(lr=1e-3, warmup_steps=2,
                                decay_steps=AED_STEPS)
            opt = tx.init(params)
            b = _timed_batches(SynthBatcher, parts)(
                cfg, batch_size=AED_BATCH, seed=SEED + 32, n_threads=2,
                reuse_pool=1024, reuse_p=0.8)

            def one(p, hb):
                batch = mel_from_samples({
                    "samples": torch.from_numpy(device_pool.encode_wire(
                        hb["samples"], "i16")).to(dev),
                    "mask": torch.from_numpy(hb["mask"]).to(dev)}, fe)
                batch["labels"] = torch.from_numpy(hb["labels"]).to(dev)
                batch["label_mask"] = torch.from_numpy(
                    hb["label_mask"]).to(dev)
                batches.append((hb, batch))
                loss = train_update(tx, opt, lambda q, bb: aed_loss(
                    q, bb, cfg)[0], p, batch)
                return p, opt, None, {"loss": loss}

            step = watch.wrap(one)
            try:
                it = iter(b)
                for _ in range(AED_STEPS):
                    step(params, next(it))
            finally:
                b.close()
            t0 = time.perf_counter()
            mel = batches[-1][1]
            ids = aed_greedy_decode(params, mel["mel"], mel["mask"], cfg,
                                    max_len=AED_MAX_LEN)
            torch.cuda.synchronize()
            parts["decode"] = time.perf_counter() - t0
            return ids

        ids, launches = _rest_drive("aed", aed_run, parts, watch)
        add(launches)
        if (tuple(ids.shape) != (AED_BATCH, AED_MAX_LEN)
                or int(ids.min()) < 0
                or int(ids.max()) >= cfg.vocab.vocab_size):
            raise PhaseError(f"aed: decoded ids {tuple(ids.shape)} in "
                             f"[{int(ids.min())}, {int(ids.max())}]")
        log(f"  aed greedy decode [{AED_BATCH}, {AED_MAX_LEN}] in "
            f"{parts['decode']:.3f} s; first row's first ids "
            f"{ids[0, :16].tolist()}")
        hb = {k: v[:CHECK_ROWS] for k, v in batches[0][0].items()}
        mel_b = mel_from_samples(
            {"samples": torch.from_numpy(device_pool.encode_wire(
                hb["samples"], "i16")),
             "mask": torch.from_numpy(hb["mask"])},
            MelFrontend(cfg.frontend, cpu))
        mel_b["labels"] = torch.from_numpy(hb["labels"])
        mel_b["label_mask"] = torch.from_numpy(hb["label_mask"])
        check = _trainer_update_check(
            "aed", dev, lambda p, bb: aed_loss(p, bb, cfg)[0], a0,
            lambda d: (on(mel_b, d),), loss_tol=TOL_REST_LOSS_REL)
        log(f"  aed update on the card against the CPU {json.dumps(check)}")
    log(f"  rest_of_training launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4j: the device mesh without tensor parallelism and the packed wire
# ---------------------------------------------------------------------------

MESH_SEQ_SHARDS = 4         # sequence mode's second mesh
MESH_SEQ_SECONDS = 330.0    # the tiled file of phase 4e
MESH_DP_SHARDS = 2          # data-parallel windows
MESH_EXPERTS = 8
MESH_EP = (2, 4)            # the all-to-all conformer's (data, model) mesh
MESH_EP_CAPACITY = 16.0     # nothing drops: equal to the dense dispatch
MESH_PP = (4, 4)            # pipeline stages and microbatches
MESH_RING_T, MESH_RING_SHARDS = 4096, 8
MESH_WIRE_ROUNDS = 6        # warm 120 s requests a wire setting
# Sequence mode's length ceiling on one card: files of these minutes
# tried at one shard and at MESH_SEQ_SHARDS, in turn until one runs out of
# memory; a run and an out-of-memory at each count bracket the ceiling.
MESH_CEILING_MINUTES = {1: (40, 50), MESH_SEQ_SHARDS: (180, 240)}
# The grafted MoE model: every expert the release's second FFN times
# (1 + N(0, MESH_EXPERT_NOISE)) and a router N(0, 1) * MESH_ROUTER_SCALE,
# both from SEED: a seeded MoE whose greedy ids are not near ties (a
# random trunk's are, below the card-vs-CPU floor).
MESH_EXPERT_NOISE = 0.01
MESH_ROUTER_SCALE = 30.0
# ring_attention against plain full attention (f32 both): the JAX tests'
# tolerance at T = 4096.
TOL_RING_ATOL, TOL_RING_RTOL = 5e-5, 1e-3
# Whole models against each other (bf16 dense layers; the pipeline and the
# all-to-all conformer): max abs difference over the largest magnitude,
# tests/test_torch_model.py's REL_MODEL.
TOL_MESH_REL_MODEL = 3e-2


def _mesh_devices(dev, n: int, distinct: bool):
    """n shards: all on ``dev``, or spread over the visible cards."""
    import torch

    if not distinct:
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _seq_ids(engine, path) -> list:
    out = engine._forward_sequence(engine._load_audio(path))
    return [out[0]["ctc_ids"].astype(int).tolist()]


def _win_ids(engine, path) -> list:
    samples = engine._load_audio(path)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    return [o["ctc_ids"].astype(int).tolist()
            for outs in engine._forward_batches(windows, n_last) for o in outs]


def _timed_request(engine, path, dev):
    """(result dict, wall seconds, peak card bytes, launches) of one
    ``transcribe``; the counts are set to 0 before it and read after."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _read_counters()
    t0 = time.perf_counter()
    res = engine.transcribe(path).to_dict()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (res, secs, torch.cuda.max_memory_allocated(dev),
            _read_counters())


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _mesh_sequence(dev, cfg, params, xvector, tiled, distinct, total):
    """(a) Sequence mode on the golden and the tiled file at one shard and
    at MESH_SEQ_SHARDS: the golden result against golden_sequence.json,
    the shards' ids against one shard's, K1 launches (one mel, plus the
    crop batches), wall seconds and peak memory beside window mode."""
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import MeshConfig
    from omnilingual_asr_torch.engine import SPK_CROP_BATCH
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.parallel.mesh import build_mesh

    stored = golden.load_golden_sequence()
    window = TranscriptionEngine(config=cfg, params=params,
                                 xvector_params=xvector, device=dev)
    window.transcribe(golden.GOLDEN_WAV)               # warm
    engines = {}
    for n in (1, MESH_SEQ_SHARDS):
        engines[n] = TranscriptionEngine(
            config=cfg, params=params, xvector_params=xvector,
            long_mode="sequence",
            mesh=build_mesh(MeshConfig(data=n),
                            _mesh_devices(dev, n, distinct)))
        engines[n].transcribe(golden.GOLDEN_WAV)       # warm
    ids = {}
    for name, path in (("golden", golden.GOLDEN_WAV), ("tiled", tiled)):
        res_w, secs_w, peak_w, _ = _timed_request(window, path, dev)
        for n, eng in engines.items():
            res, secs, peak, counts = _timed_request(eng, path, dev)
            _add(total, counts)
            n_seg = len(res["segments"])
            crops = -(-n_seg // SPK_CROP_BATCH) if n_seg > 1 else 0
            log("  mesh sequence " + json.dumps({
                "file": name, "shards": n, "seconds": secs,
                "peak_bytes": peak, "segments": n_seg,
                "window_mode_seconds": secs_w,
                "window_mode_peak_bytes": peak_w,
                "window_mode_segments": len(res_w["segments"]),
                "launches": counts, "crop_batches": crops}))
            if counts["log_mel_frames"] != 1 + crops:
                raise PhaseError(f"sequence mode {name} x{n}: K1 launched "
                                 f"{counts['log_mel_frames']} times, "
                                 f"expected 1 + {crops} crop batches")
            if counts["flash_attention"] or counts["fused_conv_module"]:
                raise PhaseError(f"sequence mode {name} x{n}: K2/K3 "
                                 f"launched ({counts})")
            ids[name, n] = _seq_ids(eng, path)
            if name == "golden":
                bad = golden.result_mismatches(stored["result"], res,
                                               tone_mass=stored["tone_mass"])
                agree = golden.ctc_agreement(stored["ctc_ids"], ids[name, n])
                log(f"  sequence x{n} golden: {n_seg} segments; ids agree "
                    f"with golden_sequence.json on {agree:.4%}")
                if bad or agree < golden.MIN_CTC_AGREEMENT:
                    raise PhaseError(f"sequence x{n} golden: {bad}, ids "
                                     f"{agree:.4f}")
        agree = golden.ctc_agreement(ids[name, 1],
                                     ids[name, MESH_SEQ_SHARDS])
        log(f"  sequence {name}: {MESH_SEQ_SHARDS} shards agree with one "
            f"on {agree:.4%} of ids")
        if agree < golden.MIN_CTC_AGREEMENT:
            raise PhaseError(f"sequence {name}: shards agree on {agree:.4f}")
    return engines


def _mesh_ceiling(dev, engines) -> dict:
    """The longest file sequence mode's forward takes on this card, at
    one shard and at MESH_SEQ_SHARDS: MESH_CEILING_MINUTES tried in order,
    stopping at the first that runs out of memory (tiled golden audio)."""
    import numpy as np
    import torch
    from omnilingual_asr_torch import testing as golden

    base = engines[1]._load_audio(golden.GOLDEN_WAV)
    sr = engines[1].config.frontend.sample_rate
    out = {}
    for n, minutes in MESH_CEILING_MINUTES.items():
        runs = []
        for m in minutes:
            samples = np.resize(base, int(m * 60 * sr))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                engines[n]._forward_sequence(samples)
                torch.cuda.synchronize()
                runs.append({"minutes": m, "seconds":
                             time.perf_counter() - t0, "peak_bytes":
                             torch.cuda.max_memory_allocated(dev)})
            except torch.cuda.OutOfMemoryError:
                runs.append({"minutes": m, "out_of_memory": True})
                break
            finally:
                del samples
                torch.cuda.empty_cache()
        out[n] = runs
        log("  sequence ceiling " + json.dumps({"shards": n, "runs": runs}))
    return out


def _mesh_ring(dev, distinct) -> None:
    """(b) ring_attention at T = 4096 over 8 shards against plain full
    attention."""
    import numpy as np
    import torch
    from omnilingual_asr_torch.ops.ring_attention import ring_attention
    from omnilingual_asr_torch.parallel.mesh import Mesh

    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    q, k, v = (torch.randn(1, MESH_RING_T, 1, 64, generator=gen, device=dev)
               for _ in range(3))
    mask = torch.ones(1, MESH_RING_T, dtype=torch.bool, device=dev)
    mesh = Mesh(np.asarray(_mesh_devices(dev, MESH_RING_SHARDS, distinct),
                           dtype=object), ("data",))
    t0 = time.perf_counter()
    got = ring_attention(q, k, v, mask, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    s = torch.einsum("bthd,bshd->bhts", q, k) / 8.0
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)
    err = (got - want).abs()
    bad = int((err > TOL_RING_ATOL + TOL_RING_RTOL * want.abs()).sum())
    log(f"  ring attention T={MESH_RING_T} over {MESH_RING_SHARDS} shards: "
        f"max abs err {float(err.max()):.3e} against full attention "
        f"({secs:.3f} s)")
    if bad:
        raise PhaseError(f"ring attention: {bad} elements outside atol "
                         f"{TOL_RING_ATOL} + rtol {TOL_RING_RTOL}")


def _mesh_data_parallel(dev, cfg, params, xvector, tiled, distinct, total):
    """(c) Data-parallel windows: MESH_DP_SHARDS shards of 2 windows
    against one shard of 2, result for result (each shard's program sees
    the one-shard program's shapes and rows), and against one shard of 4
    by ids (a batch of 4 rounds its reductions in another order on the
    card), unquantized and under "a8", on the golden and the 120 s file;
    K1-K3 (and K5) launches a shard batch."""
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import MeshConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.parallel.mesh import build_mesh

    L = cfg.encoder.n_layers
    per_shard = WINDOWS_PER_BATCH // MESH_DP_SHARDS
    for quantize in (False, "a8"):
        def engine(b, mesh=None):
            return TranscriptionEngine(
                config=cfg, params=params, xvector_params=xvector,
                quantize=quantize, batch_windows_per_device=b, mesh=mesh,
                device=None if mesh else dev)

        same = engine(per_shard)
        four = engine(WINDOWS_PER_BATCH)
        dp = engine(per_shard, build_mesh(
            MeshConfig(data=MESH_DP_SHARDS),
            _mesh_devices(dev, MESH_DP_SHARDS, distinct)))
        for name, path in (("golden", golden.GOLDEN_WAV), ("tiled", tiled)):
            want, secs_same, _, _ = _timed_request(same, path, dev)
            want4, secs_four, _, _ = _timed_request(four, path, dev)
            got, secs, _, counts = _timed_request(dp, path, dev)
            _add(total, counts)
            n_shard_batches = _n_batches(dp, [path]) * MESH_DP_SHARDS
            per = {k: v / n_shard_batches for k, v in counts.items()}
            agree4 = golden.ctc_agreement(_win_ids(four, path),
                                          _win_ids(dp, path))
            log("  mesh data-parallel " + json.dumps({
                "quantize": quantize, "file": name, "seconds": secs,
                "one_shard_of_2_seconds": secs_same,
                "one_shard_of_4_seconds": secs_four,
                "equal_to_one_shard_of_2": got == want,
                "ids_agree_one_shard_of_4": agree4,
                "text_mismatches_one_shard_of_4": len(
                    golden.result_mismatches(want4, got)),
                "launches_per_shard_batch": per}))
            if got != want or agree4 < golden.MIN_CTC_AGREEMENT:
                raise PhaseError(
                    f"data-parallel {quantize} {name}: "
                    f"{golden.result_mismatches(want, got)}, ids against "
                    f"one shard of 4 {agree4:.4f}")
            want_per = {"log_mel_frames": 1, "flash_attention": L,
                        "fused_conv_module": L,
                        "quantized_matmul_a8": (2 * L + 2 if quantize
                                                else 0)}
            for k, n in want_per.items():
                if counts[k] != n * n_shard_batches:
                    raise PhaseError(f"data-parallel {quantize} {name}: {k} "
                                     f"launched {counts[k]}, expected {n} x "
                                     f"{n_shard_batches} shard batches")


def _graft_moe(params, n_experts: int):
    """The release tree with each block's second FFN a mixture of
    ``n_experts`` seeded perturbations of it behind a seeded router."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 50)
    out = {**params, "blocks": []}
    for blk in params["blocks"]:
        f = {k: {n: t.detach().cpu() for n, t in v.items()}
             for k, v in blk["ffn2"].items()}
        d = f["w1"]["w"].shape[0]

        def noisy(t):
            return torch.stack([t * (1 + MESH_EXPERT_NOISE * torch.randn(
                t.shape, generator=gen)) for _ in range(n_experts)])

        dev = blk["ffn2"]["w1"]["w"].device
        moe = {"ln": f["ln"],
               "router": {"w": MESH_ROUTER_SCALE * torch.randn(
                   d, n_experts, generator=gen)},
               "w1": noisy(f["w1"]["w"]), "b1": noisy(f["w1"]["b"]),
               "w2": noisy(f["w2"]["w"]), "b2": noisy(f["w2"]["b"])}
        out["blocks"].append({**blk, "ffn2": {
            k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                else v.to(dev)) for k, v in moe.items()}})
    return out


def _mesh_moe(dev, cfg, params, xvector, tiled, distinct, total):
    """(d) MoE: the engine with the grafted release MoE on the card against
    the port's CPU engine; the all-to-all conformer on a (2, 4) mesh
    against dense dispatch; the drop count at capacity 1; one kernel-mode
    training step at PipelineConfig() with 8 experts and one update on the
    card against the CPU."""
    import dataclasses

    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import MeshConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.models.conformer import asr_forward
    from omnilingual_asr_torch.models.moe import moe_ffn_init
    from omnilingual_asr_torch.models.zoo import tree_to
    from omnilingual_asr_torch.parallel.expert_dispatch import ep_moe_apply
    from omnilingual_asr_torch.parallel.mesh import build_mesh

    L = cfg.encoder.n_layers
    mcfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, n_experts=MESH_EXPERTS))
    mparams = _graft_moe(params, MESH_EXPERTS)
    card = TranscriptionEngine(config=mcfg, params=mparams,
                               xvector_params=xvector, device=dev)
    cpu = TranscriptionEngine(config=mcfg, params=tree_to(mparams, "cpu"),
                              xvector_params=tree_to(xvector, "cpu"),
                              device="cpu")
    for name, path in (("golden", golden.GOLDEN_WAV), ("tiled", tiled)):
        res, secs, peak, counts = _timed_request(card, path, dev)
        _add(total, counts)
        n_b = _n_batches(card, [path])
        for k, n in (("log_mel_frames", 1), ("flash_attention", L),
                     ("fused_conv_module", L)):
            if counts[k] != n * n_b:
                raise PhaseError(f"MoE engine {name}: {k} launched "
                                 f"{counts[k]}, expected {n} x {n_b}")
        agree = golden.ctc_agreement(_win_ids(cpu, path),
                                     _win_ids(card, path))
        log("  mesh moe engine " + json.dumps({
            "file": name, "seconds": secs, "peak_bytes": peak,
            "segments": len(res["segments"]), "ids_agree_cpu": agree,
            "launches_per_batch": {k: v / n_b for k, v in counts.items()}}))
        if agree < golden.MIN_CTC_AGREEMENT:
            raise PhaseError(f"MoE engine {name}: card and CPU ids agree "
                             f"on {agree:.4f}")
    del cpu
    # The all-to-all conformer on a (data, model) mesh of shards, with
    # seeded experts (moe_ffn_init) in the release trunk: the grafted
    # router above is so peaked that f32 rounding in the blocks before it
    # moves near-tie gates, and its outputs differ card vs CPU by ~0.1 of
    # their largest magnitude in either dispatch.
    gen_cpu = torch.Generator().manual_seed(SEED + 54)
    sparams = {**params, "blocks": [
        {**blk, "ffn2": tree_to(moe_ffn_init(
            gen_cpu, cfg.encoder.d_model, MESH_EXPERTS,
            cfg.encoder.ffn_mult), dev)} for blk in params["blocks"]]}
    ecfg = mcfg.replace(encoder=dataclasses.replace(
        mcfg.encoder, moe_dispatch="alltoall",
        moe_capacity_factor=MESH_EP_CAPACITY))
    mesh = build_mesh(MeshConfig(*MESH_EP),
                      _mesh_devices(dev, MESH_EP[0] * MESH_EP[1], distinct))
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    mel = torch.randn(2, 768, cfg.frontend.n_mels, generator=gen,
                      device=dev) * 2.0 - 5.0
    mask = torch.ones(2, 768, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ep = asr_forward(sparams, mel, mask, ecfg, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dense = asr_forward(sparams, mel, mask, mcfg)
        x = torch.randn(2 * 192, cfg.encoder.d_model, generator=gen,
                        device=dev)
        stats = {}
        ep_moe_apply(sparams["blocks"][0]["ffn2"], x, mesh,
                     capacity_factor=1.0, data_axis="data", stats=stats)
    errs = {}
    for key in ("ctc_logits", "encoder_states"):
        a, b = ep[key].float(), dense[key].float()
        errs[key] = float((a - b).abs().max() / b.abs().max())
    log("  mesh moe all-to-all " + json.dumps({
        "mesh": mesh.shape, "capacity_factor": MESH_EP_CAPACITY,
        "seconds": secs, "rel_err_vs_dense": errs,
        "capacity_1_dropped": stats["dropped"],
        "capacity_1_tokens": x.shape[0],
        "capacity_1_slots": stats["capacity"]}))
    if max(errs.values()) > TOL_MESH_REL_MODEL:
        raise PhaseError(f"all-to-all conformer against dense: {errs}")
    _moe_train_step(dev, total)


def _moe_train_step(dev, total):
    """One kernel-mode training step at PipelineConfig() with MESH_EXPERTS
    experts, batch TRAIN_BATCH: finite loss, moe_aux, exactly K1 1 and K2,
    K3, K6, K7 n_layers each; then one update on the card against the CPU
    at batch 2 (gradients within testing.TRAINER_GRAD_REL a leaf)."""
    import dataclasses

    import numpy as np
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.ops import attention as A
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_train_step,
                                                  tree_leaves, tree_map)
    from omnilingual_asr_torch.train.synth import SynthBatcher

    cfg = PipelineConfig()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, n_experts=MESH_EXPERTS, use_flash_attention=True,
        use_fused_conv=True))
    L = cfg.encoder.n_layers
    mult = A.REFERENCE_BLOCK_Q * cfg.encoder.subsample_factor

    def batch_of(n, seed):
        batcher = SynthBatcher(cfg, batch_size=n, seed=seed,
                               frame_multiple=mult, n_threads=1)
        try:
            b = next(iter(batcher))
        finally:
            batcher.close()
        b["samples"] = np.clip(b["samples"] * 32768.0, -32768,
                               32767).astype(np.int16)
        return b

    def on(b, where):
        out = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
        out[CTC_INFEASIBLE] = ctc_rows(b, cfg)
        return out

    init, train_step, loss_and_grads = make_train_step(cfg, dev,
                                                       from_samples=True)
    state = init(SEED)
    big = batch_of(TRAIN_BATCH, SEED + 52)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _read_counters()
    t0 = time.perf_counter()
    out = train_step(state.params, state.opt_state, on(big, dev), 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _read_counters()
    _add(total, counts)
    metrics = {k: float(v) for k, v in out[3].items()}
    log("  mesh moe train step " + json.dumps({
        "experts": MESH_EXPERTS, "batch": TRAIN_BATCH, "seconds": secs,
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "metrics": metrics, "launches": counts}))
    if "moe_aux" not in metrics or not all(
            math.isfinite(v) for v in metrics.values()):
        raise PhaseError(f"MoE train step: metrics {metrics}")
    for k, n in (("log_mel_frames", 1), ("flash_attention", L),
                 ("fused_conv_module", L), ("flash_attention_bwd_dq", L),
                 ("flash_attention_bwd_dkv", L)):
        if counts[k] != n:
            raise PhaseError(f"MoE train step: {k} launched {counts[k]} "
                             f"times, expected {n}")
    small = batch_of(2, SEED + 53)
    grads, losses = {}, {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        _, _, lg = make_train_step(cfg, where, from_samples=True)
        p = tree_map(lambda t: t.detach().to(where).requires_grad_(True),
                     state.params)
        m, g = lg(p, on(small, where), 0)
        losses[label] = float(m["loss"])
        grads[label] = [x.detach().cpu() if x is not None
                        else torch.zeros_like(y.detach().cpu())
                        for x, y in zip(g, tree_leaves(p))]
    _read_counters()
    worst = 0.0
    for a, b in zip(grads["card"], grads["cpu"]):
        nb = float(b.norm())
        err = float((a - b).norm()) / nb if nb > 0 else float(a.norm())
        worst = max(worst, err)
    log(f"  mesh moe update on the card against the CPU: loss "
        f"{losses['card']:.6f} / {losses['cpu']:.6f}, worst leaf gradient "
        f"relative L2 {worst:.3e} (tol {golden.TRAINER_GRAD_REL})")
    if not math.isfinite(worst) or worst > golden.TRAINER_GRAD_REL:
        raise PhaseError(f"MoE update: worst gradient leaf {worst:.3e}")


def _mesh_pipeline(dev, cfg, params, distinct) -> None:
    """(e) pipeline_forward with MESH_PP stages and microbatches at the
    release block width against apply_stacked_blocks."""
    import numpy as np
    import torch
    from omnilingual_asr_torch.models import layers
    from omnilingual_asr_torch.parallel.mesh import Mesh
    from omnilingual_asr_torch.parallel.pipeline import (
        apply_stacked_blocks, pipeline_forward, stack_blocks)

    S, M = MESH_PP
    enc = cfg.encoder
    stacked = stack_blocks(params["blocks"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    T = 768
    x_mb = torch.randn(M, 2, T, enc.d_model, generator=gen, device=dev)
    mask = torch.ones(2, T, dtype=torch.bool, device=dev)
    mask[1, 500:] = False
    cos, sin = layers.rope_angles(T, enc.head_dim, device=dev)
    mesh = Mesh(np.asarray(_mesh_devices(dev, S, distinct), dtype=object),
                ("stage",))
    with torch.inference_mode():
        t0 = time.perf_counter()
        got = pipeline_forward(stacked, x_mb, mask, cos, sin, cfg, mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        errs = []
        for m in range(M):
            want = apply_stacked_blocks(stacked, x_mb[m], mask, cos, sin,
                                        cfg, torch.bfloat16)
            errs.append(float((got[m] - want).abs().max()
                              / want.abs().max()))
    log(f"  mesh pipeline S={S} M={M}: relative errors against the "
        f"stacked blocks {errs} ({secs:.3f} s)")
    if max(errs) > TOL_MESH_REL_MODEL:
        raise PhaseError(f"pipeline against stacked blocks: {errs}")


def _mesh_wire(dev, cfg, params, xvector, tiled, total) -> None:
    """(f) The packed wire on the 120 s file: results with it on equal
    results with it off; device-to-host copies a batch and warm seconds,
    the two engines' requests interleaved (on, off, off, on, ...)."""
    import dataclasses

    from omnilingual_asr_torch.engine import TranscriptionEngine

    engines, runs = {}, {}
    for pack in (True, False):
        c = cfg.replace(decode=dataclasses.replace(cfg.decode,
                                                   wire_pack=pack))
        engines[pack] = TranscriptionEngine(config=c, params=params,
                                            xvector_params=xvector,
                                            device=dev)
        engines[pack].transcribe(tiled)                       # warm
        runs[pack] = {"warm_seconds": [], "copies": engines[pack].d2h_copies}
    for rnd in range(MESH_WIRE_ROUNDS):
        for pack in ((True, False) if rnd % 2 == 0 else (False, True)):
            res, secs, _, counts = _timed_request(engines[pack], tiled, dev)
            _add(total, counts)
            runs[pack]["warm_seconds"].append(secs)
            runs[pack]["result"] = res
    n_b = _n_batches(engines[True], [tiled])
    for pack, r in runs.items():
        r["warm_seconds_median"] = statistics.median(r["warm_seconds"])
        r["d2h_copies_per_batch"] = ((engines[pack].d2h_copies - r["copies"])
                                     / (MESH_WIRE_ROUNDS * n_b))
    log("  mesh packed wire " + json.dumps({
        ("on" if k else "off"): {n: v for n, v in r.items()
                                 if n not in ("result", "copies")}
        for k, r in runs.items()}))
    if runs[True]["result"] != runs[False]["result"]:
        raise PhaseError("the packed wire changes the 120 s result")
    if runs[True]["d2h_copies_per_batch"] != 1:
        raise PhaseError(f"packed wire: {runs[True]['d2h_copies_per_batch']}"
                         f" copies a batch")


def run_mesh(dev, cfg, params, xvector, smi) -> dict:
    """Phase 4j. Meshes are shards on ``dev`` (and, where more than one
    card is visible, (a)-(e) again over distinct cards). Returns the
    launches of each kernel over the phase's requests and steps."""
    import torch
    from omnilingual_asr_torch import testing as golden

    tiled = PKG / "_build" / "smoke_tiled.wav"
    write_tiled_wav(golden.GOLDEN_WAV, tiled, TILED_SECONDS)
    long_path = PKG / "_build" / "mesh_330.wav"
    write_tiled_wav(golden.GOLDEN_WAV, long_path, MESH_SEQ_SECONDS)
    total: dict = {}
    variants = [False] + ([True] if torch.cuda.device_count() > 1 else [])
    for distinct in variants:
        where = "distinct cards" if distinct else f"shards on {dev}"
        log(f"  mesh variant: {where}")
        t0 = time.perf_counter()
        engines = _mesh_sequence(dev, cfg, params, xvector, long_path,
                                 distinct, total)
        log(f"  (a) sequence mode {time.perf_counter() - t0:.2f} s")
        if not distinct:
            t0 = time.perf_counter()
            _mesh_ceiling(dev, engines)
            log(f"  sequence ceiling {time.perf_counter() - t0:.2f} s")
        del engines
        torch.cuda.empty_cache()
        for label, fn in (
                ("(b) ring attention", lambda: _mesh_ring(dev, distinct)),
                ("(c) data-parallel windows", lambda: _mesh_data_parallel(
                    dev, cfg, params, xvector, tiled, distinct, total)),
                ("(d) mixture of experts", lambda: _mesh_moe(
                    dev, cfg, params, xvector, tiled, distinct, total)),
                ("(e) pipeline", lambda: _mesh_pipeline(
                    dev, cfg, params, distinct))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            log(f"  {label} {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _mesh_wire(dev, cfg, params, xvector, tiled, total)
    log(f"  (f) packed wire {time.perf_counter() - t0:.2f} s")
    log(f"  mesh launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4k: tensor parallelism in serving
# ---------------------------------------------------------------------------

TP_MESHES = ((1, 2), (1, 4), (2, 2))   # (data, model) of the release engines
TP_MOE_MESH = (1, 4)        # the all-to-all MoE engine
TP_SEQ_MESH = (2, 2)        # sequence mode beside a model axis
TP_D512_MODEL = 2           # the d512 seed in crop mode
TP_ROUNDS = 3               # warm 120 s requests a model axis (medians)


def _tp_engine(dev, cfg, params, xvector, shape, distinct, **kw):
    """The engine on a (data, model) mesh of shards of ``dev`` (or of the
    visible cards), WINDOWS_PER_BATCH windows a batch in all."""
    from omnilingual_asr_torch.config import MeshConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.parallel.mesh import build_mesh

    data, model = shape
    return TranscriptionEngine(
        config=cfg, params=params, xvector_params=xvector,
        batch_windows_per_device=WINDOWS_PER_BATCH // data,
        mesh=build_mesh(MeshConfig(data=data, model=model),
                        _mesh_devices(dev, data * model, distinct)), **kw)


def _tp_launches(label, counts, shape, n_batches, layers, crops=0) -> None:
    """A TP engine's launches over ``n_batches`` batches: per data row's
    shard batch K1 once and K2 and split K3 once a model shard a layer;
    whole K3, K4 and K5 never; K1 once more a crop batch."""
    data, model = shape
    rows = n_batches * data
    want = {"log_mel_frames": rows + crops,
            "flash_attention": rows * model * layers,
            "fused_conv_module_split": rows * model * layers,
            "fused_conv_module": 0, "quantized_matmul": 0,
            "quantized_matmul_a8": 0}
    bad = {k: (counts.get(k, 0), n) for k, n in want.items()
           if counts.get(k, 0) != n}
    if bad:
        raise PhaseError(f"{label}: launches (got, want) {bad}")


def _tp_release(dev, cfg, params, xvector, tiled, distinct, total) -> None:
    """(a) The release engine at TP_MESHES, unquantized and under
    quantize=True, on the golden and the tiled 120 s file: each golden
    result held to golden.json (unquantized) or to the (1, 1)
    quantize=True engine on this card by ``result_mismatches``; the
    greedy ids of the meshes' golden windows together on
    MIN_CTC_AGREEMENT of the same reference's, and of their 120 s
    windows together on MIN_CTC_AGREEMENT of the (1, 1) engine's (pooled
    as testing.py pools files: the golden file's 191 frames hold near
    ties, top-two gaps of 0.006-0.03 against ~0.06 of logit movement
    between two f32 orders, which one flip turns into 0.5 %); each
    mesh's own agreement is printed; launches."""
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine

    L = cfg.encoder.n_layers
    stored = golden.load_golden()
    for quantize in (False, True):
        base = TranscriptionEngine(config=cfg, params=params,
                                   xvector_params=xvector, device=dev,
                                   quantize=quantize)
        want = {"golden": base.transcribe(golden.GOLDEN_WAV).to_dict(),
                "ids": _win_ids(base, golden.GOLDEN_WAV),
                "tiled_ids": _win_ids(base, tiled)}
        if not quantize:
            want["golden"] = stored["result"]
            want["ids"] = stored["ctc_ids"]
        pooled = {"want": [], "got": [], "want_t": [], "got_t": []}
        for shape in TP_MESHES:
            eng = _tp_engine(dev, cfg, params, xvector, shape, distinct,
                             quantize=quantize)
            label = f"TP {shape} quantize={quantize}"
            res, secs, peak, counts = _timed_request(eng, golden.GOLDEN_WAV,
                                                     dev)
            _add(total, counts)
            _tp_launches(label + " golden", counts, shape,
                         _n_batches(eng, [golden.GOLDEN_WAV]), L)
            bad = golden.result_mismatches(
                want["golden"], res,
                tone_mass=stored["tone_mass"] if not quantize else None)
            ids = _win_ids(eng, golden.GOLDEN_WAV)
            res_t, secs_t, peak_t, counts_t = _timed_request(eng, tiled,
                                                             dev)
            _add(total, counts_t)
            _tp_launches(label + " 120 s", counts_t, shape,
                         _n_batches(eng, [tiled]), L)
            ids_t = _win_ids(eng, tiled)
            pooled["want"] += want["ids"]
            pooled["got"] += ids
            pooled["want_t"] += want["tiled_ids"]
            pooled["got_t"] += ids_t
            log("  tp release " + json.dumps({
                "mesh": shape, "quantize": quantize,
                "golden_against": "golden.json" if not quantize
                else "(1, 1) quantize=True on this card",
                "golden_mismatches": bad,
                "golden_ids_agree": golden.ctc_agreement(want["ids"], ids),
                "tiled_ids_agree_1x1": golden.ctc_agreement(
                    want["tiled_ids"], ids_t),
                "golden_seconds": secs, "tiled_seconds": secs_t,
                "tiled_peak_bytes": peak_t,
                "tiled_segments": len(res_t["segments"]),
                "launches_golden": counts}))
            if bad:
                raise PhaseError(f"{label}: golden {bad}")
        agree = golden.ctc_agreement(pooled["want"], pooled["got"])
        agree_t = golden.ctc_agreement(pooled["want_t"], pooled["got_t"])
        log(f"  tp release quantize={quantize}: golden ids of the "
            f"{len(TP_MESHES)} meshes agree on {agree:.4%}, their 120 s ids "
            f"with (1, 1)'s on {agree_t:.4%}")
        if min(agree, agree_t) < golden.MIN_CTC_AGREEMENT:
            raise PhaseError(f"TP quantize={quantize}: golden ids "
                             f"{agree:.4f}, 120 s ids {agree_t:.4f}")
        del base, eng


def _tp_refusals(dev, cfg, params, xvector) -> None:
    """(b) The int8 kernel modes at model 2 raise, as the JAX engine's."""
    for quantize in ("a8", "w8"):
        try:
            _tp_engine(dev, cfg, params, xvector, (1, 2), False,
                       quantize=quantize)
        except ValueError as e:
            if "model-parallel axis 1" not in str(e):
                raise
            log(f"  tp refusal quantize={quantize!r}: {e}")
            continue
        raise PhaseError(f"quantize={quantize!r} at model 2 did not raise")


def _tp_moe(dev, cfg, params, xvector, tiled, distinct, total) -> None:
    """(e) The release with MESH_EXPERTS grafted experts at TP_MOE_MESH
    with all-to-all dispatch inside the blocks (capacity where nothing
    drops) against the dense engine without a model axis, by ids."""
    import dataclasses

    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine

    mcfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, n_experts=MESH_EXPERTS))
    acfg = mcfg.replace(encoder=dataclasses.replace(
        mcfg.encoder, moe_dispatch="alltoall",
        moe_capacity_factor=MESH_EP_CAPACITY))
    mparams = _graft_moe(params, MESH_EXPERTS)
    dense = TranscriptionEngine(config=mcfg, params=mparams,
                                xvector_params=xvector, device=dev)
    a2a = _tp_engine(dev, acfg, mparams, xvector, TP_MOE_MESH, distinct)
    for name, path in (("golden", golden.GOLDEN_WAV), ("tiled", tiled)):
        res, secs, _, counts = _timed_request(a2a, path, dev)
        _add(total, counts)
        _tp_launches(f"TP MoE {name}", counts, TP_MOE_MESH,
                     _n_batches(a2a, [path]), cfg.encoder.n_layers)
        agree = golden.ctc_agreement(_win_ids(dense, path),
                                     _win_ids(a2a, path))
        log("  tp moe all-to-all engine " + json.dumps({
            "mesh": TP_MOE_MESH, "experts": MESH_EXPERTS, "file": name,
            "seconds": secs, "segments": len(res["segments"]),
            "ids_agree_dense_1x1": agree}))
        if agree < golden.MIN_CTC_AGREEMENT:
            raise PhaseError(f"TP MoE {name}: ids agree with dense on "
                             f"{agree:.4f}")


def _tp_d512_crop(dev, tiled, distinct, total) -> None:
    """(f) The d512 seed in crop mode at model TP_D512_MODEL (the crop
    re-embedding's trunk on plain ops over the shards), greedy, held to
    golden_d512_crop.json where stable (testing.d512_mismatches with
    near_ties: segments, times, speakers, languages, emotions, summary
    and the pooled ids held; a segment's text free where the fixture's
    feed has a near tie in it)."""
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import config_for_checkpoint
    from omnilingual_asr_torch.engine import SPK_CROP_BATCH
    from omnilingual_asr_torch.models.zoo import load_checkpoint

    base = config_for_checkpoint(str(D512))
    params = load_checkpoint(D512, base, dev)
    shape = (1, TP_D512_MODEL)
    eng = _tp_engine(dev, base, params, None, shape, distinct,
                     speaker_mode="crop")
    results, ids = {}, {}
    for name, path in (("golden", golden.GOLDEN_WAV), ("tiled", tiled)):
        res, secs, _, counts = _timed_request(eng, path, dev)
        _add(total, counts)
        n_seg = len(res["segments"])
        crops = -(-n_seg // SPK_CROP_BATCH) if n_seg > 1 else 0
        _tp_launches(f"TP d512 crop {name}", counts, shape,
                     _n_batches(eng, [path]), base.encoder.n_layers, crops)
        results[name] = res
        ids[name] = _win_ids(eng, path)
        log("  tp d512 crop " + json.dumps({
            "model": TP_D512_MODEL, "file": name, "seconds": secs,
            "segments": n_seg, "crop_batches": crops}))
    free = {n: golden.d512_greedy_near_ties(n) for n in results}
    bad = golden.d512_mismatches("greedy", results, ids, near_ties=True)
    log(f"  tp d512 crop: texts free where the fixture has a near tie "
        f"(segments {free}); texts equal on "
        + json.dumps({n: sum(a["text"] == b["text"] for a, b in zip(
            golden.load_golden_d512()["files"][n]["greedy"]["result"][
                "segments"], r["segments"])) for n, r in results.items()}))
    if bad:
        raise PhaseError("TP d512 crop: " + "; ".join(bad))


def _tp_sequence(dev, cfg, params, xvector, distinct, total) -> None:
    """(g) Sequence mode on a TP_SEQ_MESH mesh (over the data axis, the
    parameters gathered per data row) on the golden file, held to
    golden_sequence.json."""
    from omnilingual_asr_torch import testing as golden

    eng = _tp_engine(dev, cfg, params, xvector, TP_SEQ_MESH, distinct,
                     long_mode="sequence")
    res, secs, _, counts = _timed_request(eng, golden.GOLDEN_WAV, dev)
    _add(total, counts)
    stored = golden.load_golden_sequence()
    bad = golden.result_mismatches(stored["result"], res,
                                   tone_mass=stored["tone_mass"])
    agree = golden.ctc_agreement(stored["ctc_ids"],
                                 _seq_ids(eng, golden.GOLDEN_WAV))
    log("  tp sequence " + json.dumps({
        "mesh": TP_SEQ_MESH, "seconds": secs, "mismatches": bad,
        "ids_agree": agree, "launches": counts}))
    if bad or agree < golden.MIN_CTC_AGREEMENT:
        raise PhaseError(f"TP sequence mode: {bad}, ids {agree:.4f}")


def _tp_costs(dev, cfg, params, xvector, tiled, distinct, total) -> None:
    """(h) Warm 120 s request seconds (median of TP_ROUNDS), peak card
    memory and what a request adds to the memory held before it
    (``request_bytes``) at model 1, 2 and 4 (data 1), the engines'
    requests interleaved. Reported, not held: on one card the shards run
    in turn."""
    import torch

    engines = {m: _tp_engine(dev, cfg, params, xvector, (1, m), distinct)
               for m in (1, 2, 4)}
    runs = {m: {"seconds": [], "peak_bytes": 0, "request_bytes": 0}
            for m in engines}
    for m, eng in engines.items():
        eng.transcribe(tiled)                          # warm
    for rnd in range(TP_ROUNDS):
        order = list(engines) if rnd % 2 == 0 else list(engines)[::-1]
        for m in order:
            start = torch.cuda.memory_allocated(dev)
            _, secs, peak, counts = _timed_request(engines[m], tiled, dev)
            _add(total, counts)
            r = runs[m]
            r["seconds"].append(secs)
            r["peak_bytes"] = max(r["peak_bytes"], peak)
            r["request_bytes"] = max(r["request_bytes"], peak - start)
    for m, r in runs.items():
        r["median_seconds"] = statistics.median(r["seconds"])
    log("  tp request costs (120 s, warm) " + json.dumps(runs))


def run_tp(dev, cfg, params, xvector, smi) -> dict:
    """Phase 4k. Tensor parallelism in serving with the release weights,
    meshes as shards on ``dev`` (and, where more than one card is
    visible, (a), (e) and (g) again over distinct cards): (a) the release
    engine at TP_MESHES; (b) the int8 kernel modes refused at model 2;
    (e) the all-to-all MoE engine; (f) the d512 seed in crop mode; (g)
    sequence mode beside a model axis; (h) request seconds and peak
    memory at model 1, 2 and 4. (c) and (d), the split K3 and K2 at one
    shard's heads, run in phase 3. Returns the launches of each kernel."""
    import torch

    tiled = PKG / "_build" / "smoke_tiled.wav"
    write_tiled_wav(PKG / "testdata" / "golden.wav", tiled, TILED_SECONDS)
    total: dict = {}
    variants = [False] + ([True] if torch.cuda.device_count() > 1 else [])
    for distinct in variants:
        where = "distinct cards" if distinct else f"shards on {dev}"
        log(f"  tp variant: {where}")
        steps = [("(a) release engines", lambda: _tp_release(
                     dev, cfg, params, xvector, tiled, distinct, total)),
                 ("(e) all-to-all experts", lambda: _tp_moe(
                     dev, cfg, params, xvector, tiled, distinct, total)),
                 ("(g) sequence mode", lambda: _tp_sequence(
                     dev, cfg, params, xvector, distinct, total))]
        if not distinct:
            steps[1:1] = [("(b) int8 kernel modes", lambda: _tp_refusals(
                dev, cfg, params, xvector))]
            steps += [("(f) d512 crop", lambda: _tp_d512_crop(
                          dev, tiled, distinct, total)),
                      ("(h) request costs", lambda: _tp_costs(
                          dev, cfg, params, xvector, tiled, distinct,
                          total))]
        for label, fn in steps:
            t0 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            log(f"  {label} {time.perf_counter() - t0:.2f} s")
    log(f"  tp launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4l: training over the (data, model) mesh
# ---------------------------------------------------------------------------

MT_STEPS = 3                 # train_synth steps over MT_MESH
MT_MESH = (2, 2)             # train_synth's (data, model) mesh
MT_CHECK_MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))  # updates against (1, 1)
MT_TIMED = ((1, 1), (2, 2), (1, 4))   # step seconds and peak memory
MT_TIMED_STEPS = 3           # timed steps a mesh, after one warm step
MT_POOL = 32                 # entries of the pool step's pool
# One update over a mesh against the same update on one device of the
# card: the loss within TOL_MT_LOSS_REL (bf16 roundings of each shard's
# partial sums), the gradients per leaf within TOL_GRAD_REL (phase 4b's).
TOL_MT_LOSS_REL = 1e-3
MT_SCALARS = {"w_spk": 1.0, "w_trans": 1.0, "w_aug": 1.0, "w_fce": 0.5,
              "w_ctc": 1.0}


def _mt_launches(shape, layers: int) -> dict:
    """The kernels a kernel-mode mesh train step launches from a sample
    wire: K1 once a data row; K2, K6 and K7 once a model shard a layer a
    row; K3 whole once a layer a row at model 1, split (counted once a
    shard) above it; no int8 kernel."""
    data, model = shape
    split = model > 1
    return {"log_mel_frames": data,
            "flash_attention": layers * data * model,
            "flash_attention_bwd_dq": layers * data * model,
            "flash_attention_bwd_dkv": layers * data * model,
            "fused_conv_module": 0 if split else layers * data,
            "fused_conv_module_split": layers * data * model if split else 0,
            "quantized_matmul": 0, "quantized_matmul_a8": 0}


def _mt_host_batch(cfg, seed, bake=False):
    """One SynthBatcher batch of TRAIN_BATCH 8 s windows padded for the
    flash blocks (one producer: the same batch every call)."""
    from omnilingual_asr_torch.ops.attention import REFERENCE_BLOCK_Q
    from omnilingual_asr_torch.train.synth import SynthBatcher

    b = SynthBatcher(cfg, batch_size=TRAIN_BATCH, seed=seed, n_threads=1,
                     frame_multiple=REFERENCE_BLOCK_Q * 4, bake_mode=bake)
    try:
        return next(iter(b))
    finally:
        b.close()


def _mt_worst(got, want, names):
    """(worst per-leaf relative L2, its leaf's name)."""
    worst, worst_i = 0.0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        nb = float(b.norm())
        err = float((a - b).norm()) / nb if nb > 0 else float(a.norm())
        if not math.isfinite(err):
            raise PhaseError(f"mesh training: gradient leaf {names[i]} is "
                             f"not finite")
        if err > worst:
            worst, worst_i = err, i
    return worst, names[worst_i]


def _mt_compare(label, one, mesh, names) -> dict:
    """One device's (loss, grads) against a mesh's: the loss within
    TOL_MT_LOSS_REL, each leaf within TOL_GRAD_REL, or the phase fails."""
    loss_rel = abs(mesh[0] - one[0]) / max(abs(one[0]), 1e-30)
    worst, leaf = _mt_worst(mesh[1], one[1], names)
    out = {"check": label, "loss_1x1": one[0], "loss_mesh": mesh[0],
           "loss_rel": loss_rel, "grad_worst_rel": worst,
           "grad_worst_leaf": leaf}
    log("  mesh training update " + json.dumps(out))
    if (not math.isfinite(mesh[0]) or loss_rel > TOL_MT_LOSS_REL
            or worst > TOL_GRAD_REL):
        raise PhaseError(f"mesh training {label}: {out} (loss tol "
                         f"{TOL_MT_LOSS_REL}, grads {TOL_GRAD_REL})")
    return out


def _mt_grads(make, where, params, args, place_kw=None):
    """``make(where)`` -> (init, step, loss_and_grads); the loss and the
    whole leaves' gradients (on the CPU) from ``params`` (a whole tree)."""
    import torch
    from omnilingual_asr_torch.parallel.mesh import Mesh
    from omnilingual_asr_torch.train.step import tree_leaves, trainable

    init, _, lg = make(where)
    if isinstance(where, Mesh):
        p = init.place(params, **(place_kw or {}))
        m, g = lg(p, *args)
        grads = p.merge(g)
    else:
        p = trainable(params, where)
        m, g = lg(p, *args)
        grads = [torch.zeros_like(x) if a is None else a
                 for a, x in zip(g, tree_leaves(p))]
    torch.cuda.synchronize()
    return float(m["loss"]), [x.detach().cpu() for x in grads]


def run_mesh_training(dev, smi, profile: bool = False) -> dict:
    """Phase 4l. Training over a (data, model) mesh at ``PipelineConfig()``
    width (d512 x 12, 8 heads), kernel mode, the translator on, meshes as
    shards of ``dev`` (and the update checks again over distinct cards
    where more than one is visible): (1) ``train_synth`` over MT_MESH for
    MT_STEPS steps from host batches of 16 8 s windows, each step's
    launches exactly (``_mt_launches``) and finite losses; (2) one update
    at each of MT_CHECK_MESHES against the (1, 1) update on the card from
    the same parameters and batch (SpecAugment on: its draws over the
    global batch); (3) one pool step at (2, 2) and one pretraining update
    at (2, 1) against one device; (4) (1)'s checkpoint equal to the
    gathered parameters and serving from the one-device engine; (5) step
    seconds and peak memory at MT_TIMED, printed, not held, and with
    ``profile`` (``--profile``) one more step of each under the profiler
    (device events, busy share). Returns the launches of each kernel."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.config import MeshConfig, PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.models import zoo
    from omnilingual_asr_torch.models.conformer import asr_init
    from omnilingual_asr_torch.models.translation import translator_init
    from omnilingual_asr_torch.parallel.mesh import build_mesh
    from omnilingual_asr_torch.train import device_pool, synth_train
    from omnilingual_asr_torch.train import pretrain as pre
    from omnilingual_asr_torch.train.augment import SpecAugmentConfig
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_optimizer,
                                                  make_train_step,
                                                  trainable, tree_leaves)

    base = PipelineConfig()
    cfg = base.replace(encoder=dataclasses.replace(
        base.encoder, use_flash_attention=True, use_fused_conv=True))
    L = cfg.encoder.n_layers
    total: dict = {}

    def mesh_of(shape, distinct=False):
        data, model = shape
        return build_mesh(MeshConfig(data=data, model=model),
                          _mesh_devices(dev, data * model, distinct))

    # (1) train_synth over MT_MESH, host batches, kernel mode.
    parts, captured = {}, []
    watch = _StepWatch("mesh train_synth", _mt_launches(MT_MESH, L))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with contextlib.ExitStack() as st:
            st.enter_context(_patched(synth_train, "make_train_step",
                                      watch.factory(
                                          synth_train.make_train_step,
                                          captured)))
            st.enter_context(_patched(synth_train, "SynthBatcher",
                                      _timed_batches(_one_producer(
                                          synth_train.SynthBatcher), parts)))
            (params, _), launches = _rest_drive(
                "mesh train_synth", lambda: synth_train.train_synth(
                    steps=MT_STEPS, batch_size=TRAIN_BATCH,
                    cfg=base.replace(mesh=MeshConfig(*MT_MESH)),
                    pallas_kernels=True, seed=SEED, ckpt_dir=str(tmp),
                    log_every=1, eval_every=1000, device=dev), parts, watch)
        _add(total, launches)
        # (4) The checkpoint: equal to the gathered parameters, and the
        # one-device engine serves from it.
        whole = params.full()
        saved = zoo.load_checkpoint(tmp / "last" / "asr.npz", base, dev)
        for k, v in zoo.flatten(whole["asr"]).items():
            if not torch.equal(zoo.flatten(saved)[k], v):
                raise PhaseError(f"mesh checkpoint: leaf {k} differs from "
                                 f"the gathered parameters")
        engine = TranscriptionEngine(config=base, params=saved, device=dev)
        before = _read_counters(reset=False)
        res = engine.transcribe(golden.GOLDEN_WAV).to_dict()
        after = _read_counters(reset=False)
        _add(total, {k: after[k] - before[k] for k in after})
        log("  mesh checkpoint " + json.dumps({
            "leaves": len(zoo.flatten(whole["asr"])), "equal": True,
            "engine_segments": len(res["segments"])}))
        del engine, params, whole, saved, captured

    # (2) One update at each mesh against (1, 1), from the same parameters
    # and batch, SpecAugment on.
    full = {"asr": asr_init(torch.Generator().manual_seed(SEED), base),
            "translator": translator_init(
                torch.Generator().manual_seed(SEED + 1), base)}
    names = list(zoo.flatten(full).keys())
    hb = _mt_host_batch(cfg, SEED + 60)
    batch = {k: torch.from_numpy(device_pool.encode_wire(v, "i16")
                                 if k == "samples" else v).to(dev)
             for k, v in hb.items()}
    batch[CTC_INFEASIBLE] = ctc_rows(hb, cfg)
    batch.update(MT_SCALARS)
    aug = SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16,
                            n_time_masks=1, time_mask_width=24)

    def train_make(where):
        return make_train_step(cfg, where, tx=make_optimizer(),
                               from_samples=True, augment=aug,
                               with_translator=True)

    _read_counters()
    one = _mt_grads(train_make, dev, full, (batch, 0))
    variants = [False] + ([True] if torch.cuda.device_count() > 1 else [])
    for distinct in variants:
        for shape in MT_CHECK_MESHES:
            got = _mt_grads(train_make, mesh_of(shape, distinct), full,
                            (batch, 0))
            _mt_compare(f"{shape}{' distinct cards' if distinct else ''}",
                        one, got, names)
    _add(total, _read_counters())

    # (3) One pool step at (2, 2) and one pretraining update at (2, 1)
    # against one device.
    pool_np = device_pool.build_pool(iter([_mt_host_batch(
        cfg, SEED + 61 + i, bake=True) for i in range(2)]), MT_POOL,
        wire="mulaw")
    pool = device_pool.pool_to_device(pool_np, dev)
    idx = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, MT_POOL, TRAIN_BATCH).astype(np.int32)).to(dev)
    scalars = dict(MT_SCALARS)
    scalars[CTC_INFEASIBLE] = ctc_rows(
        {k: v[idx.cpu().numpy()] for k, v in pool_np.items()}, cfg)

    def pool_make(where):
        out = device_pool.make_pool_train_step(
            cfg, where, tx=make_optimizer(), augment=aug,
            with_translator=True)
        return out[0], out[1], out[3]

    _read_counters()
    one_pool = _mt_grads(pool_make, dev, full, (pool, idx, 0, scalars))
    _mt_compare("pool (2, 2)", one_pool,
                _mt_grads(pool_make, mesh_of((2, 2)), full,
                          (pool, idx, 0, scalars)), names)
    pcfg = pre.PretrainConfig()
    pfull = pre.pretrain_init(torch.Generator().manual_seed(SEED + 2), base,
                              pcfg)
    quantizer = {k: v.to(dev) for k, v in pre.make_quantizer(
        torch.Generator().manual_seed(SEED + 3), base, pcfg).items()}
    pbatch = {"samples": torch.from_numpy(device_pool.encode_wire(
        hb["samples"], "mulaw")).to(dev),
        "mask": torch.from_numpy(hb["mask"]).to(dev)}

    def pre_make(where):
        return pre.make_pretrain_step(base, where, pcfg,
                                      tx=make_optimizer(lr=2e-3),
                                      from_samples=True)

    _mt_compare("pretrain (2, 1)",
                _mt_grads(pre_make, dev, pfull, (quantizer, pbatch, 0)),
                _mt_grads(pre_make, mesh_of((2, 1)), pfull,
                          (quantizer, pbatch, 0)),
                list(zoo.flatten(pfull).keys()))
    _add(total, _read_counters())
    del pool

    # (5) Step seconds and peak memory a mesh (printed, not held).
    costs = {}
    for shape in MT_TIMED:
        if shape == (1, 1):
            _, step_fn, _ = train_make(dev)
            state = trainable(full, dev)
            leaves = tree_leaves(state)
        else:
            init, step_fn, _ = train_make(mesh_of(shape))
            state = init.place(full)
            leaves = state.leaves
        opt = make_optimizer().init(leaves)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _read_counters()
        secs = []
        for i in range(1 + MT_TIMED_STEPS):
            t0 = time.perf_counter()
            step_fn(state, opt, batch, i)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = _read_counters()
        want = {k: v * (1 + MT_TIMED_STEPS)
                for k, v in _mt_launches(shape, L).items()}
        bad = {k: (counts.get(k, 0), n) for k, n in want.items()
               if counts.get(k, 0) != n}
        if bad:
            raise PhaseError(f"mesh training {shape} timed steps: launches "
                             f"(got, want) {bad}")
        _add(total, counts)
        costs[str(shape)] = {
            "step_s": secs[1:], "median_s": statistics.median(secs[1:]),
            "warm_step_s": secs[0],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if profile:      # where the step's time goes (--profile only)
            device_profile(f"mesh training step {shape}", lambda: step_fn(
                state, opt, batch, 1 + MT_TIMED_STEPS), top=4)
            _add(total, _read_counters())
        del state, opt
    log("  mesh training step costs (d512 x 12, batch 16, kernel mode, "
        "translator) " + json.dumps(costs))
    log(f"  mesh training launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4m: the f32 encoder, and a mixture of experts trained over the mesh
# ---------------------------------------------------------------------------

F32_ROUNDS = 3               # warm 120 s requests at f32 and bf16 (medians)
F32_TRAIN_STEPS = 3          # kernel-mode f32 train_synth steps at d512 x 12
F32_TIMED_STEPS = 3          # f32 and bf16 steps timed in turn, after a warm one
MM_CHECK_MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))  # updates against (1, 1)
MM_TIMED = ((1, 1), (2, 2), (1, 4))   # steps timed a mesh
MM_STEPS = 3                 # steps a timed mesh
# A mixture of experts over a mesh against one device of the card: the
# loss and moe_aux within TOL_MM_REL (each data row's and model shard's
# bf16 partial sums round where one device rounds the whole; moe_aux's
# router sums are f32), every leaf's gradient within TOL_GRAD_REL (phase
# 4l's gate).
TOL_MM_REL = 1e-4


#: The encoder dtypes beyond bf16 that phases 4m (f32) and 4o (f16)
#: serve and train: (``EncoderConfig.dtype``, the suffix of its flash
#: kernels' counters, its golden fixture's loader in
#: ``omnilingual_asr_torch.testing``).
ENCODER_DTYPES = {"f32": ("float32", "_f32", "load_golden_f32"),
                  "f16": ("float16", "_f16", "load_golden_f16")}


def _at(cfg, name: str):
    """``cfg`` with the encoder at ENCODER_DTYPES[name]'s dtype."""
    return cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, dtype=ENCODER_DTYPES[name][0]))


def _dtype_serving_launches(name: str, layers: int, model: int) -> dict:
    """A batch of the engine at ENCODER_DTYPES[name]: K1 once; that
    dtype's K2 once a model shard a layer; K3 whole once a layer at model
    1, split (once a shard) above it; no other attention kernel and no
    int8 kernel."""
    split = model > 1
    sfx = ENCODER_DTYPES[name][1]
    return {"log_mel_frames": 1,
            **{f"flash_attention{s}": layers * model if s == sfx else 0
               for s in ("", "_f32", "_f16")},
            "fused_conv_module": 0 if split else layers,
            "fused_conv_module_split": layers * model if split else 0,
            "quantized_matmul": 0, "quantized_matmul_a8": 0}


def _dtype_serving(name, dev, cfg, params, xvector, tiled, total,
                   rounds) -> None:
    """(a) The release with the encoder at ENCODER_DTYPES[name] serves the
    golden file (its result held to that dtype's golden fixture by
    ``result_mismatches``, its ids on MIN_CTC_AGREEMENT) and the 120 s
    file (ids on MIN_CTC_AGREEMENT: one of its frames is a tie at f32),
    with one model shard and at (data, model) (1, 2), each batch's
    launches exactly; then ``rounds`` warm 120 s requests at that dtype
    and at bf16 in turns, their seconds printed."""
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.engine import TranscriptionEngine

    dcfg = _at(cfg, name)
    L = cfg.encoder.n_layers
    stored = getattr(golden, ENCODER_DTYPES[name][2])()
    requests = [("golden", golden.GOLDEN_WAV), ("tiled", tiled)]
    engines = {}
    for shape in ((1, 1), (1, 2)):
        label = f"{name} engine {shape}"
        engine = (TranscriptionEngine(config=dcfg, params=params,
                                      xvector_params=xvector, device=dev)
                  if shape == (1, 1) else
                  _tp_engine(dev, dcfg, params, xvector, shape, False))
        # drive_path leaves its launches in the counters: the read after
        # _win_ids below adds them to ``total`` once, with _win_ids' own.
        results, _ = drive_path(
            label, lambda path, cb, e=engine: e.transcribe(
                path, progress_callback=cb).to_dict(),
            engine, requests, _dtype_serving_launches(name, L, shape[1]))
        bad = golden.result_mismatches(stored["result"], results[0],
                                       tone_mass=stored["tone_mass"])
        if bad:
            raise PhaseError(f"{label}: golden_{name} mismatch: "
                             + "; ".join(bad))
        agree = {n: golden.ctc_agreement(want["ctc_ids"],
                                         _win_ids(engine, path))
                 for (n, path), want in zip(requests,
                                            (stored, stored["tiled"]))}
        log(f"  {label} " + json.dumps({
            "golden_segments": len(results[0]["segments"]),
            "tiled_segments": len(results[1]["segments"]),
            "ids_agree": agree}))
        if min(agree.values()) < golden.MIN_CTC_AGREEMENT:
            raise PhaseError(f"{label}: ids agree {agree}")
        _add(total, _read_counters())
        engines[shape] = engine
    bf16 = TranscriptionEngine(config=cfg, params=params,
                               xvector_params=xvector, device=dev)
    secs = {"bf16": [], name: []}
    for _ in range(rounds):
        for n, e in (("bf16", bf16), (name, engines[(1, 1)])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.transcribe(tiled)
            torch.cuda.synchronize()
            secs[n].append(time.perf_counter() - t0)
    _add(total, _read_counters())
    log(f"  {name} request seconds (120 s, warm, interleaved) " + json.dumps(
        {k: {"s": v, "median_s": statistics.median(v)}
         for k, v in secs.items()}))


def _dtype_training(name, dev, total, steps) -> None:
    """(b) ``train_synth`` with the encoder at ENCODER_DTYPES[name] at
    ``PipelineConfig()`` (d512 x 12), kernel mode, batch TRAIN_BATCH of
    8 s, ``steps`` steps: finite losses, each step's launches exactly (K1
    1; that dtype's K2, K6, K7 and K3 12 each; no other attention
    kernel); then one update on the card against the CPU (phase 4b's
    gate, the worst leaf printed)."""
    import numpy as np
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.models import zoo
    from omnilingual_asr_torch.models.conformer import asr_init
    from omnilingual_asr_torch.ops.attention import REFERENCE_BLOCK_Q
    from omnilingual_asr_torch.train import synth_train
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_train_step)
    from omnilingual_asr_torch.train.synth import SynthBatcher

    base = _at(PipelineConfig(), name)
    L = base.encoder.n_layers
    sfx = ENCODER_DTYPES[name][1]
    watch = _StepWatch(f"{name} train_synth", {
        "log_mel_frames": 1, f"flash_attention{sfx}": L,
        f"flash_attention_bwd_dq{sfx}": L, f"flash_attention_bwd_dkv{sfx}": L,
        "fused_conv_module": L})
    parts, captured = {}, []
    with contextlib.ExitStack() as st:
        st.enter_context(_patched(synth_train, "make_train_step",
                                  watch.factory(synth_train.make_train_step,
                                                captured)))
        st.enter_context(_patched(synth_train, "SynthBatcher",
                                  _timed_batches(_one_producer(
                                      synth_train.SynthBatcher), parts)))
        (params, _), launches = _rest_drive(
            f"{name} train_synth", lambda: synth_train.train_synth(
                steps=steps, batch_size=TRAIN_BATCH, cfg=base,
                pallas_kernels=True, seed=SEED, log_every=1,
                eval_every=1000, device=dev), parts, watch)
    _add(total, launches)
    secs = [r["step_s"] for r in watch.rows]
    log(f"  {name} train step seconds " + json.dumps({
        "steps_s": secs, "median_after_first_s":
            statistics.median(secs[1:])}))
    del params, captured

    cfg = base.replace(encoder=dataclasses.replace(
        base.encoder, use_flash_attention=True, use_fused_conv=True))
    batcher = SynthBatcher(cfg, batch_size=CHECK_ROWS, seed=SEED + 80,
                           frame_multiple=REFERENCE_BLOCK_Q * 4,
                           n_threads=1)
    try:
        hb = next(iter(batcher))
    finally:
        batcher.close()
    hb["samples"] = np.clip(hb["samples"] * 32768.0, -32768,
                            32767).astype(np.int16)
    full = asr_init(torch.Generator().manual_seed(SEED + 81), cfg)
    names = list(zoo.flatten(full).keys())

    def make(where):
        return make_train_step(cfg, where, from_samples=True)

    got = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        b = {k: torch.from_numpy(v).to(where) for k, v in hb.items()}
        b[CTC_INFEASIBLE] = ctc_rows(hb, cfg)
        got[label] = _mt_grads(make, where, full, (b, 0))
    _add(total, _read_counters())
    worst, leaf = _mt_worst(got["card"][1], got["cpu"][1], names)
    loss_rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    out = {"loss_card": got["card"][0], "loss_cpu": got["cpu"][0],
           "loss_rel": loss_rel, "grad_worst_rel": worst,
           "grad_worst_leaf": leaf}
    log(f"  {name} update on the card against the CPU " + json.dumps(out))
    if worst > TOL_GRAD_REL or loss_rel > TOL_REST_LOSS_REL:
        raise PhaseError(f"{name} update: {out} (grads {TOL_GRAD_REL}, "
                         f"loss {TOL_REST_LOSS_REL})")


def _f32_step_costs(dev, total) -> None:
    """Step seconds of the f32 encoder beside bf16, on phase 4l's (1, 1)
    step (``make_train_step`` at d512 x 12 from a device batch of 16 8 s
    windows, kernel mode, SpecAugment and the translator on): one warm
    step each, then F32_TIMED_STEPS each in turn; the launches exactly
    (each dtype's attention kernels only)."""
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.models.conformer import asr_init
    from omnilingual_asr_torch.models.translation import translator_init
    from omnilingual_asr_torch.train import device_pool
    from omnilingual_asr_torch.train.augment import SpecAugmentConfig
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_optimizer,
                                                  make_train_step, trainable)

    base = PipelineConfig()
    cfg = base.replace(encoder=dataclasses.replace(
        base.encoder, use_flash_attention=True, use_fused_conv=True))
    L = cfg.encoder.n_layers
    full = {"asr": asr_init(torch.Generator().manual_seed(SEED), base),
            "translator": translator_init(
                torch.Generator().manual_seed(SEED + 1), base)}
    hb = _mt_host_batch(cfg, SEED + 60)
    batch = {k: torch.from_numpy(device_pool.encode_wire(v, "i16")
                                 if k == "samples" else v).to(dev)
             for k, v in hb.items()}
    batch[CTC_INFEASIBLE] = ctc_rows(hb, cfg)
    batch.update(MT_SCALARS)
    aug = SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16,
                            n_time_masks=1, time_mask_width=24)
    runs = {}
    for name, c in (("bf16", cfg), ("f32", _at(cfg, "f32"))):
        _, step_fn, _ = make_train_step(c, dev, tx=make_optimizer(),
                                        from_samples=True, augment=aug,
                                        with_translator=True)
        state = trainable(full, dev)
        runs[name] = (step_fn, state, make_optimizer().init(state))
    n = 1 + F32_TIMED_STEPS
    secs = {"bf16": [], "f32": []}
    _read_counters()
    for i in range(n):
        for name, (step_fn, state, opt) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(state, opt, batch, i)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
    counts = _read_counters()
    _add(total, counts)
    want = {"log_mel_frames": 2 * n, "fused_conv_module": 2 * L * n,
            **{f"{k}{sfx}": L * n for k in (
                "flash_attention", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv") for sfx in ("", "_f32")}}
    bad = {k: (counts.get(k, 0), v) for k, v in want.items()
           if counts.get(k, 0) != v}
    if bad:
        raise PhaseError(f"f32 and bf16 timed steps: launches (got, want) "
                         f"{bad}")
    log("  f32 step costs (d512 x 12, batch 16, kernel mode, translator, "
        "phase 4l's (1, 1) step) " + json.dumps({
            k: {"step_s": v, "median_after_first_s":
                statistics.median(v[1:])} for k, v in secs.items()}))
    del runs, full


@contextlib.contextmanager
def _routing_recorded(tops):
    """Every top-1 routing choice of a forward appended to ``tops`` (the
    one-device MoE and the tensor-parallel one both route through
    ``models.moe.route``)."""
    from omnilingual_asr_torch.models import moe
    from omnilingual_asr_torch.parallel import tensor

    route = moe.route

    def recorded(p, h):
        out = route(p, h)
        tops.append(out[1].detach().cpu())
        return out

    with _patched(moe, "route", recorded), \
            _patched(tensor, "route", recorded):
        yield


def _moe_mesh_training(dev, total) -> None:
    """(c) A mixture of MESH_EXPERTS experts at ``PipelineConfig()`` width,
    kernel mode, batch TRAIN_BATCH of 8 s, trained over meshes as shards
    of ``dev``: one update at each of MM_CHECK_MESHES against one device
    (the loss and moe_aux within TOL_MM_REL, every leaf within
    TOL_GRAD_REL, the routing choices that differ from one device's
    counted); then MM_STEPS steps at each of MM_TIMED, each step's
    launches exactly (``_mt_launches``), finite metrics with moe_aux,
    seconds and peak memory printed."""
    import torch
    from omnilingual_asr_torch.config import MeshConfig, PipelineConfig
    from omnilingual_asr_torch.models import zoo
    from omnilingual_asr_torch.models.conformer import asr_init
    from omnilingual_asr_torch.parallel.mesh import build_mesh
    from omnilingual_asr_torch.train import device_pool
    from omnilingual_asr_torch.train.step import (CTC_INFEASIBLE, ctc_rows,
                                                  make_optimizer,
                                                  make_train_step,
                                                  trainable, tree_leaves)

    base = PipelineConfig()
    cfg = base.replace(encoder=dataclasses.replace(
        base.encoder, n_experts=MESH_EXPERTS, use_flash_attention=True,
        use_fused_conv=True))
    L = cfg.encoder.n_layers
    full = asr_init(torch.Generator().manual_seed(SEED + 70), cfg)
    names = list(zoo.flatten(full).keys())
    hb = _mt_host_batch(cfg, SEED + 71)
    batch = {k: torch.from_numpy(device_pool.encode_wire(v, "i16")
                                 if k == "samples" else v).to(dev)
             for k, v in hb.items()}
    batch[CTC_INFEASIBLE] = ctc_rows(hb, cfg)

    def make(where):
        return make_train_step(cfg, where, tx=make_optimizer(),
                               from_samples=True)

    def mesh_of(shape):
        data, model = shape
        return build_mesh(MeshConfig(data=data, model=model),
                          [dev] * (data * model))

    def update(shape):
        """(loss, moe_aux, whole-leaf grads on the CPU, each block's
        routing over the batch) of one update at ``shape``."""
        tops = []
        one_device = shape == (1, 1)
        init, _, lg = make(dev if one_device else mesh_of(shape))
        with _routing_recorded(tops):
            if one_device:
                p = trainable(full, dev)
                m, g = lg(p, batch, 0)
                g = [torch.zeros_like(x) if a is None else a
                     for a, x in zip(g, tree_leaves(p))]
            else:
                p = init.place(full)
                m, g = lg(p, batch, 0)
                g = p.merge(g)
        torch.cuda.synchronize()
        data = shape[0]
        rows = [tops[r * L:(r + 1) * L] for r in range(data)]
        routing = [torch.cat([r[b] for r in rows]) for b in range(L)]
        return (float(m["loss"]), float(m["moe_aux"]),
                [x.detach().cpu() for x in g], routing)

    _read_counters()
    one = update((1, 1))
    choices = sum(t.numel() for t in one[3])
    for shape in MM_CHECK_MESHES:
        got = update(shape)
        worst, leaf = _mt_worst(got[2], one[2], names)
        out = {"check": shape, "loss_1x1": one[0], "loss_mesh": got[0],
               "loss_rel": abs(got[0] - one[0]) / abs(one[0]),
               "moe_aux_1x1": one[1], "moe_aux_mesh": got[1],
               "moe_aux_rel": abs(got[1] - one[1]) / abs(one[1]),
               "grad_worst_rel": worst, "grad_worst_leaf": leaf,
               "routing_differs": sum(int((a != b).sum()) for a, b in zip(
                   got[3], one[3])), "routing_choices": choices}
        log("  moe mesh update " + json.dumps(out))
        if (out["loss_rel"] > TOL_MM_REL or out["moe_aux_rel"] > TOL_MM_REL
                or worst > TOL_GRAD_REL):
            raise PhaseError(f"moe mesh {shape}: {out} (loss and moe_aux "
                             f"{TOL_MM_REL}, grads {TOL_GRAD_REL})")
    _add(total, _read_counters())

    costs = {}
    for shape in MM_TIMED:
        init, step_fn, _ = make(dev if shape == (1, 1) else mesh_of(shape))
        if shape == (1, 1):
            state = trainable(full, dev)
            leaves = tree_leaves(state)
        else:
            state = init.place(full)
            leaves = state.leaves
        opt = make_optimizer().init(leaves)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _read_counters()
        secs, auxes = [], []
        for i in range(MM_STEPS):
            t0 = time.perf_counter()
            m = step_fn(state, opt, batch, i)[3]
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            m = {k: float(v) for k, v in m.items()}
            if "moe_aux" not in m or not all(math.isfinite(v)
                                             for v in m.values()):
                raise PhaseError(f"moe mesh {shape} step {i}: {m}")
            auxes.append(m["moe_aux"])
        counts = _read_counters()
        want = {k: v * MM_STEPS for k, v in _mt_launches(shape, L).items()}
        bad = {k: (counts.get(k, 0), n) for k, n in want.items()
               if counts.get(k, 0) != n}
        if bad:
            raise PhaseError(f"moe mesh {shape} steps: launches (got, want) "
                             f"{bad}")
        _add(total, counts)
        costs[str(shape)] = {
            "step_s": secs, "median_after_first_s":
                statistics.median(secs[1:]), "moe_aux": auxes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts}
        del state, opt
    log(f"  moe mesh step costs (d512 x 12, {MESH_EXPERTS} experts, batch "
        f"{TRAIN_BATCH}, kernel mode) " + json.dumps(costs))
    del full


def run_f32_moe_mesh(dev, cfg, params, xvector, smi) -> dict:
    """Phase 4m. (a) The release with the f32 encoder serving, with one
    model shard and at (1, 2), held to ``golden_f32.json``; (b) kernel-mode
    f32 training at d512 x 12 and one f32 update on the card against the
    CPU; (c) a mixture of experts trained over (data, model) meshes as
    shards of ``dev``, held to one device. Returns the launches of each
    kernel."""
    import torch

    tiled = PKG / "_build" / "smoke_tiled.wav"
    write_tiled_wav(PKG / "testdata" / "golden.wav", tiled, TILED_SECONDS)
    total: dict = {}
    for label, fn in (
            ("(a) f32 serving", lambda: _dtype_serving(
                "f32", dev, cfg, params, xvector, tiled, total,
                F32_ROUNDS)),
            ("(b) f32 training", lambda: (
                _dtype_training("f32", dev, total, F32_TRAIN_STEPS),
                _f32_step_costs(dev, total))),
            ("(c) moe over the mesh", lambda: _moe_mesh_training(
                dev, total))):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        log(f"  {label} {time.perf_counter() - t0:.2f} s, peak card "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        torch.cuda.empty_cache()
    log(f"  f32 and moe mesh launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4n: the multi-controller mesh (processes joined by init_distributed)
# ---------------------------------------------------------------------------

MP_PROCESSES = 2
MP_UPDATES = ((1, 1), (1, 2))   # each process's (data rows, model shards)
MP_PRETRAIN = (1, 1)
MP_SYNTH = (1, 2)               # train_synth's rows and shards a process
MP_SYNTH_STEPS = 3
MP_TIMED_STEPS = 2              # timed steps a shape, after one warm step
MP_DROPOUT = 0.1
MP_CHILD_TIMEOUT_S = 480        # a child past it is killed and fails


def _unflatten(flat: dict):
    """``models.zoo.flatten``'s inverse: a tree from ``{keystr: leaf}``."""
    from omnilingual_asr_torch.models.zoo import parse_keystr

    root: dict = {}
    for key, v in flat.items():
        path = parse_keystr(key)
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _mp_save(path: Path, flat: dict) -> None:
    import numpy as np

    np.savez(path, **{k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                          else np.asarray(v)) for k, v in flat.items()})


def _mp_inputs(work: Path):
    """Phase 4n's parameters, batches and configs, from SEED: written by
    the parent (``.npz``), read by each process."""
    import dataclasses as dc

    import numpy as np
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.models import zoo
    from omnilingual_asr_torch.train import pretrain as pre
    from omnilingual_asr_torch.train.augment import SpecAugmentConfig
    from omnilingual_asr_torch.train.step import CTC_INFEASIBLE

    base = PipelineConfig()
    cfg = base.replace(encoder=dc.replace(
        base.encoder, use_flash_attention=True, use_fused_conv=True,
        dropout=MP_DROPOUT))
    aug = SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16,
                            n_time_masks=1, time_mask_width=24)
    with np.load(work / "params.npz") as z:
        full = _unflatten({k: torch.from_numpy(z[k]) for k in z.files})
    with np.load(work / "pretrain.npz") as z:
        pflat = {k: torch.from_numpy(z[k]) for k in z.files}
    quantizer = {k[len("q/"):]: v for k, v in pflat.items()
                 if k.startswith("q/")}
    pfull = _unflatten({k: v for k, v in pflat.items()
                        if not k.startswith("q/")})
    with np.load(work / "batch.npz") as z:
        host = {k: z[k] for k in z.files}
    batch = {k: torch.from_numpy(v) for k, v in host.items()
             if k not in MT_SCALARS and k != CTC_INFEASIBLE}
    batch[CTC_INFEASIBLE] = host[CTC_INFEASIBLE]
    batch.update({k: float(host[k]) for k in MT_SCALARS})
    pbatch = {"samples": torch.from_numpy(host["pre_samples"]),
              "mask": batch["mask"]}
    batch.pop("pre_samples")
    return dict(base=base, cfg=cfg, aug=aug, full=full, pfull=pfull,
                quantizer=quantizer, pcfg=pre.PretrainConfig(),
                batch=batch, pbatch=pbatch)


def _mp_to(batch: dict, dev) -> dict:
    import torch

    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def _mp_update(make, mesh, params, args, place=True):
    """One ``loss_and_grads`` of ``make(mesh)`` from ``params``: (loss,
    whole gradients, whole clipped gradients) on the CPU, and the step
    function and placed state for timing."""
    import torch
    from omnilingual_asr_torch.train.step import make_optimizer

    tx = make_optimizer()
    init, step_fn, lg = make(mesh, tx)
    mp = init.place(params)
    m, g = lg(mp, *args)
    clipped = tx.clip_and_zero_nans(g, mp.counted(g))
    torch.cuda.synchronize()
    return ((float(m["loss"]), [x.detach().cpu() for x in mp.merge(g)],
             [x.detach().cpu() for x in mp.merge(clipped)]),
            step_fn, mp, tx)


def _mp_makers(inp):
    from omnilingual_asr_torch.train import pretrain as pre
    from omnilingual_asr_torch.train.step import make_train_step

    def train_make(mesh, tx):
        return make_train_step(inp["cfg"], mesh, tx=tx, from_samples=True,
                               augment=inp["aug"], with_translator=True,
                               dropout=True)

    def pre_make(mesh, tx):
        return pre.make_pretrain_step(inp["cfg"], mesh, inp["pcfg"], tx=tx,
                                      from_samples=True)
    return train_make, pre_make


def _mp_timed(step_fn, mp, tx, args_of, n) -> list:
    """Seconds of one warm and ``n`` timed steps (the first dropped)."""
    import torch

    opt = tx.init(mp.leaves)
    secs = []
    for i in range(1 + n):
        t0 = time.perf_counter()
        step_fn(mp, opt, *args_of(i))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs[1:]


def _mp_child(rank: int, port: int, work: str, device: str) -> None:
    """One process of phase 4n: join the others over ``init_distributed``
    on ``device``, run the updates, the timed steps, the pretraining
    update and ``train_synth``, count its own launches, and write
    ``rank<r>.json`` and rank 0's gradients (``rank0_<job>.npz``) into
    ``work``."""
    import numpy as np
    import torch
    from omnilingual_asr_torch.config import MeshConfig
    from omnilingual_asr_torch.models import zoo
    from omnilingual_asr_torch.ops import cuda_build
    from omnilingual_asr_torch.parallel import mesh as pm
    from omnilingual_asr_torch.train import synth_train

    work = Path(work)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pm.init_distributed(f"127.0.0.1:{port}", MP_PROCESSES, rank,
                        devices=[dev], timeout_s=MP_CHILD_TIMEOUT_S)
    try:
        if dev.type == "cuda":
            # The parent built the library: each process only loads it.
            if not cuda_build.build().cached:
                raise PhaseError("the kernel library was not built before "
                                 "the processes started")
            cuda_build.library()
        inp = _mp_inputs(work)
        L = inp["cfg"].encoder.n_layers
        train_make, pre_make = _mp_makers(inp)
        batch = _mp_to(inp["batch"], dev) if rank == 0 else None
        pbatch = _mp_to(inp["pbatch"], dev) if rank == 0 else None
        out = {"backend": pm.distributed_backend(), "updates": {},
               "launches": {}, "device": str(dev)}

        def launches(label, want):
            got = _read_counters()
            _add(out["launches"], got)
            bad = {k: (got.get(k, 0), n) for k, n in want.items()
                   if got.get(k, 0) != n}
            if bad:
                raise PhaseError(f"multiprocess rank {rank} {label}: "
                                 f"launches (got, want) {bad}")
            return got

        def mesh_of(local):
            rows, model = local
            return pm.build_mesh(MeshConfig(data=rows * MP_PROCESSES,
                                            model=model),
                                 [dev] * (rows * model))

        quantizer = {k: v.to(dev) for k, v in inp["quantizer"].items()}
        jobs = [(f"train {MP_PROCESSES} x {local}", local, train_make,
                 inp["full"], lambda i: (batch, i)) for local in MP_UPDATES]
        jobs.append((f"pretrain {MP_PROCESSES} x {MP_PRETRAIN}",
                     MP_PRETRAIN, pre_make, inp["pfull"],
                     lambda i: (quantizer, pbatch, i)))
        _read_counters()
        for label, local, make, params, args_of in jobs:
            mesh = mesh_of(local)
            pm.process_bytes(reset=True)
            res, step_fn, mp, tx = _mp_update(make, mesh, params,
                                              args_of(0))
            crossed = pm.process_bytes(reset=True)
            launches(label, _mt_launches(local, L))
            secs, reduce_s = [], []
            if not label.startswith("pretrain"):
                secs = _mp_timed(step_fn, mp, tx, args_of, MP_TIMED_STEPS)
                launches(label + " timed", {
                    k: v * (1 + MP_TIMED_STEPS)
                    for k, v in _mt_launches(local, L).items()})
                # What the step's sum of the gradients over the processes
                # costs alone: the same bytes, one collective a bucket.
                blocks = [mp.leaves[idx[0]].detach()
                          for b in mp.blocks for idx in b]
                for _ in range(MP_TIMED_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pm.process_all_reduce_many(blocks)
                    torch.cuda.synchronize()
                    reduce_s.append(time.perf_counter() - t0)
            out["updates"][label] = {
                "loss": res[0], "bytes_crossed": crossed, "step_s": secs,
                "grad_all_reduce_s": reduce_s,
                "grad_sums": [float(x.double().sum()) for x in res[1]]}
            if rank == 0:
                _mp_save(work / f"rank0_{len(out['updates'])}.npz",
                         {f"g{i}": x for i, x in enumerate(res[1])}
                         | {f"c{i}": x for i, x in enumerate(res[2])})
            del step_fn, mp, tx, res
            torch.cuda.empty_cache()

        # train_synth over the processes' mesh, each step's launches exact.
        watch = _StepWatch(f"multiprocess train_synth rank {rank}",
                           _mt_launches(MP_SYNTH, L))
        captured = []
        rows, model = MP_SYNTH
        with _patched(synth_train, "make_train_step", watch.factory(
                synth_train.make_train_step, captured)):
            params, _ = synth_train.train_synth(
                steps=MP_SYNTH_STEPS, batch_size=TRAIN_BATCH,
                cfg=inp["base"].replace(mesh=MeshConfig(
                    data=rows * MP_PROCESSES, model=model)),
                pallas_kernels=True, dropout=MP_DROPOUT, seed=SEED,
                ckpt_dir=str(work / "ckpt"), log_every=1, eval_every=1000,
                device=str(dev))
        _add(out["launches"], _read_counters())
        out["train_synth"] = watch.rows
        whole = params.full()
        _mp_save(work / f"rank{rank}_synth.npz", zoo.flatten(whole["asr"]))
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        pm.shutdown_distributed()


def _mp_run(work: Path, devices) -> list:
    """Start phase 4n's processes (rank r on ``devices[r]``), wait for them
    (killing one past MP_CHILD_TIMEOUT_S) and read what each wrote."""
    import multiprocessing
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for f in work.glob("rank*"):
        f.unlink()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_mp_child, args=(r, port, str(work), d))
             for r, d in enumerate(devices)]
    hung = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + MP_CHILD_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise PhaseError(f"multiprocess: rank(s) {hung} ran past "
                         f"{MP_CHILD_TIMEOUT_S} s and were killed")
    codes = [p.exitcode for p in procs]
    if codes != [0] * MP_PROCESSES:
        raise PhaseError(f"multiprocess: the processes exited {codes}")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(MP_PROCESSES)]


def run_multiprocess(dev, smi) -> dict:
    """Phase 4n. Training over a (data, model) mesh whose data rows lie in
    MP_PROCESSES processes joined by ``parallel.mesh.init_distributed``
    (both on ``dev``, so gloo, each tensor that crosses staged through the
    host; again with one card a process, NCCL, where more than one is
    visible), at ``PipelineConfig()`` width, kernel mode, the translator,
    SpecAugment and dropout 0.1, batch 16 of 8 s, from the parameters and
    batch the parent writes as ``.npz``: (1) one update over
    MP_PROCESSES x (1, 1) and x (1, 2) and one pretraining update over
    MP_PROCESSES x (1, 1), each against the single-process mesh of the
    same global shape on the card (the loss within ``MESH_LOSS_REL``,
    each leaf's gradient and clipped gradient within ``MESH_GRAD_REL``),
    rank 1 holding rank 0's loss and gradient sums; (2) each process's
    launches exact (``_mt_launches`` of its own shards); (3)
    ``train_synth`` for MP_SYNTH_STEPS steps over MP_PROCESSES x (1, 2)
    (rank 0 alone making the batches): finite losses, every step's
    launches exact, rank 0's checkpoint equal to both processes' gathered
    parameters. Prints the backend, each process's step seconds beside
    the single-process step, and the bytes a process hands to collectives
    in an update (not held). Returns the launches of both processes."""
    import tempfile

    import numpy as np
    import torch
    from omnilingual_asr_torch import testing
    from omnilingual_asr_torch.config import MeshConfig, PipelineConfig
    from omnilingual_asr_torch.models import zoo
    from omnilingual_asr_torch.models.conformer import asr_init
    from omnilingual_asr_torch.models.translation import translator_init
    from omnilingual_asr_torch.parallel.mesh import build_mesh
    from omnilingual_asr_torch.train import device_pool
    from omnilingual_asr_torch.train import pretrain as pre
    from omnilingual_asr_torch.train.step import CTC_INFEASIBLE, ctc_rows

    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        base = PipelineConfig()
        full = {"asr": asr_init(torch.Generator().manual_seed(SEED), base),
                "translator": translator_init(
                    torch.Generator().manual_seed(SEED + 1), base)}
        _mp_save(work / "params.npz", zoo.flatten(full))
        pcfg = pre.PretrainConfig()
        pfull = pre.pretrain_init(torch.Generator().manual_seed(SEED + 2),
                                  base, pcfg)
        quant = pre.make_quantizer(torch.Generator().manual_seed(SEED + 3),
                                   base, pcfg)
        _mp_save(work / "pretrain.npz", zoo.flatten(pfull) | {
            f"q/{k}": v for k, v in quant.items()})
        hb = _mt_host_batch(base, SEED + 60)
        arrays = {k: (device_pool.encode_wire(v, "i16") if k == "samples"
                      else v) for k, v in hb.items()}
        arrays["pre_samples"] = device_pool.encode_wire(hb["samples"],
                                                        "mulaw")
        arrays[CTC_INFEASIBLE] = ctc_rows(hb, base)
        arrays.update({k: np.float32(v) for k, v in MT_SCALARS.items()})
        _mp_save(work / "batch.npz", arrays)
        inp0 = _mp_inputs(work)
        train_make, pre_make = _mp_makers(inp0)
        L = inp0["cfg"].encoder.n_layers
        batch = _mp_to(inp0["batch"], dev)
        pbatch = _mp_to(inp0["pbatch"], dev)
        quantizer = {k: v.to(dev) for k, v in inp0["quantizer"].items()}
        names = list(zoo.flatten(full).keys())
        pnames = list(zoo.flatten(pfull).keys())

        # The single-process meshes of the same global shapes (and their
        # step seconds), before the processes take the card.
        refs, single_s, repeat = [], {}, {}
        _read_counters()
        for local in MP_UPDATES:
            shape = (local[0] * MP_PROCESSES, local[1])
            mesh = build_mesh(MeshConfig(*shape), [dev] * (shape[0]
                                                           * shape[1]))
            res, step_fn, mp, tx = _mp_update(train_make, mesh, full,
                                              (batch, 0))
            single_s[str(shape)] = _mp_timed(step_fn, mp, tx,
                                             lambda i: (batch, i),
                                             MP_TIMED_STEPS)
            refs.append((res, names))
            # The card's own spread: the same update again in one process.
            again = _mp_update(train_make, mesh, full, (batch, 0))[0]
            repeat[str(shape)] = {
                "loss_rel": abs(again[0] - res[0]) / abs(res[0]),
                "grad_worst_rel": _mt_worst(again[1], res[1], names)[0]}
            del step_fn, mp, tx, again
        log("  multiprocess single-process repeat " + json.dumps(repeat))
        shape = (MP_PRETRAIN[0] * MP_PROCESSES, MP_PRETRAIN[1])
        res, *_ = _mp_update(pre_make, build_mesh(MeshConfig(*shape), [dev] * (
            shape[0] * shape[1])), pfull, (quantizer, pbatch, 0))
        refs.append((res, pnames))
        _add(total, _read_counters())
        del batch, pbatch, quantizer, inp0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        runs = [([str(dev)] * MP_PROCESSES, "gloo")]
        if torch.cuda.device_count() >= MP_PROCESSES:
            runs.append(([f"cuda:{r}" for r in range(MP_PROCESSES)], "nccl"))
        for devices, want in runs:
            outs = _mp_run(work, devices)
            for out in outs:
                _add(total, out["launches"])
            backend = outs[0]["backend"]
            if any(o["backend"] != want for o in outs):
                raise PhaseError(f"multiprocess: backends "
                                 f"{[o['backend'] for o in outs]}, "
                                 f"expected {want}")
            rows = []
            for k, ((ref, leaf_names), label) in enumerate(zip(
                    refs, outs[0]["updates"])):
                with np.load(work / f"rank0_{k + 1}.npz") as z:
                    grads = [torch.from_numpy(z[f"g{i}"])
                             for i in range(len(leaf_names))]
                    clipped = [torch.from_numpy(z[f"c{i}"])
                               for i in range(len(leaf_names))]
                got = outs[0]["updates"][label]
                other = outs[1]["updates"][label]
                loss_rel = abs(got["loss"] - ref[0]) / max(abs(ref[0]),
                                                           1e-30)
                worst, leaf = _mt_worst(grads, ref[1], leaf_names)
                worst_c, leaf_c = _mt_worst(clipped, ref[2], leaf_names)
                row = {"check": label, "backend": backend,
                       "loss_single": ref[0], "loss_processes": got["loss"],
                       "loss_rel": loss_rel, "grad_worst_rel": worst,
                       "grad_worst_leaf": leaf, "clipped_worst_rel": worst_c,
                       "bytes_crossed_a_process": got["bytes_crossed"],
                       "step_s": {f"rank{r}": o["updates"][label]["step_s"]
                                  for r, o in enumerate(outs)},
                       "grad_all_reduce_s": got["grad_all_reduce_s"]}
                single = single_s.get(str((MP_PROCESSES * MP_UPDATES[k][0],
                                           MP_UPDATES[k][1]))
                                      if k < len(MP_UPDATES) else "")
                if single:
                    row["single_process_step_s"] = single
                log("  multiprocess update " + json.dumps(row))
                if (not math.isfinite(got["loss"])
                        or loss_rel > testing.MESH_LOSS_REL
                        or worst > testing.MESH_GRAD_REL
                        or worst_c > testing.MESH_GRAD_REL):
                    raise PhaseError(f"multiprocess {label}: {row} (loss tol "
                                     f"{testing.MESH_LOSS_REL}, grads "
                                     f"{testing.MESH_GRAD_REL})")
                if (other["loss"] != got["loss"]
                        or other["grad_sums"] != got["grad_sums"]):
                    raise PhaseError(f"multiprocess {label}: rank 1's loss "
                                     f"or gradients differ from rank 0's")
                rows.append(row)
            synth = [o["train_synth"] for o in outs]
            if any(len(s) != MP_SYNTH_STEPS for s in synth):
                raise PhaseError(f"multiprocess train_synth: steps "
                                 f"{[len(s) for s in synth]}")
            with np.load(work / "rank0_synth.npz") as z0, \
                    np.load(work / "rank1_synth.npz") as z1:
                saved = zoo.load_checkpoint(work / "ckpt" / "last" /
                                            "asr.npz", base, "cpu")
                for k, v in zoo.flatten(saved).items():
                    a = v.numpy()
                    if not (np.array_equal(a, z0[k])
                            and np.array_equal(a, z1[k])):
                        raise PhaseError(f"multiprocess train_synth: leaf "
                                         f"{k} of rank 0's checkpoint "
                                         f"differs from a process's "
                                         f"gathered parameters")
            log("  multiprocess train_synth " + json.dumps({
                "backend": backend, "mesh": f"{MP_PROCESSES} x {MP_SYNTH}",
                "losses": [[r["loss"] for r in s] for s in synth],
                "step_s": [[r["step_s"] for r in s] for s in synth],
                "checkpoint_equal": True}))
    log(f"  multiprocess launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4p: Orbax checkpoints, read and written without JAX
# ---------------------------------------------------------------------------

CKPT_TRAIN_STEPS = 3         # train_synth steps resumed from a JAX layout
CKPT_RESUME = (7, 7, 0.0625)  # the written step, Adam count, best score
CKPT_DECODE_ROUNDS = 5       # timed decodes of the fixture's chunks


def _same_leaves(label, got: dict, want: dict) -> None:
    """Equal keys; every leaf equal bit for bit, dtype and shape too."""
    import numpy as np

    if sorted(got) != sorted(want):
        raise PhaseError(f"{label}: keys differ ({len(got)} against "
                         f"{len(want)})")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if (g.dtype, g.shape) != (w.dtype, w.shape) or \
                g.tobytes() != w.tobytes():
            raise PhaseError(f"{label}: leaf {k} differs")


def _jax_layout_train_state(tree, step: int, count: int, best: float):
    """A ``train_state.npz`` as the JAX trainer's ``save_train_state``
    writes it, without JAX: the leaves of its optimizer chain
    (``clip_by_global_norm``, ``zero_nans``, ``adamw``) as ``l00000``...,
    that is N ``found_nan`` flags, Adam's count, N first moments, N second
    moments and the schedule's count, each group in JAX's leaf order (a
    dict's keys sorted), then ``__step__`` and ``__best__``. The moments
    are random (seeded). Returns (the file's arrays, {keystr: (first,
    second moment)})."""
    import numpy as np
    from omnilingual_asr_torch.models import zoo

    flat = zoo.flatten(tree)
    rng = np.random.default_rng(SEED)
    moments = {}
    for k, v in flat.items():
        m = (rng.random(tuple(v.shape), np.float32) - 0.5) * 2e-3
        moments[k] = (m, rng.random(tuple(v.shape), np.float32) * 1e-6
                      + 1e-6)
    order = sorted(flat, key=zoo.parse_keystr)
    n = len(order)
    state = {f"l{j:05d}": np.asarray(False) for j in range(n)}
    state[f"l{n:05d}"] = np.asarray(count, np.int32)
    for j, k in enumerate(order):
        state[f"l{n + 1 + j:05d}"] = moments[k][0]
        state[f"l{2 * n + 1 + j:05d}"] = moments[k][1]
    state[f"l{3 * n + 1:05d}"] = np.asarray(count, np.int32)
    state["__step__"] = np.asarray(step, np.int64)
    state["__best__"] = np.asarray(best, np.float64)
    return state, moments


def _golden_ids(engine) -> list:
    """The engine's greedy CTC ids over the golden file's windows."""
    from omnilingual_asr_torch import testing as golden

    samples = engine._load_audio(golden.GOLDEN_WAV)
    windows = engine._windows(samples)
    n_last = len(samples) - (len(windows) - 1) * engine.window_samples
    return [o["ctc_ids"].astype(int).tolist()
            for outs in engine._forward_batches(windows, n_last)
            for o in outs]


def run_checkpoints(dev, cfg, params, xvector, npz_engine, smi) -> dict:
    """Phase 4p. (a) The committed fixture ``testdata/orbax_jax/`` (written
    by the JAX package's Orbax saves) read by the port, every leaf equal to
    its ``.npz`` twin, and the zstd decoder's (libzstd) rate on its chunks;
    (b) the d512 seed and a translator written as Orbax directories by the
    port, and a train state in the JAX trainer's layout (random moments,
    CKPT_RESUME's step, count and score) beside them, read back bit for
    bit, then ``train_synth`` resumed from that directory in kernel mode
    for CKPT_TRAIN_STEPS steps: before step 1 the trunk equals the
    ``.npz``, the translator the one written, and the optimizer's moments,
    count, step and score what was written; finite losses, each step's
    launches exact; (c) an engine built from the release ASR
    written as an Orbax directory serves the golden file, held to
    ``golden.json``, with greedy ids identical to the ``.npz`` engine's.
    Returns the launches of each kernel."""
    import shutil

    import numpy as np
    import torch
    from omnilingual_asr_torch import testing as golden
    from omnilingual_asr_torch.checkpoint import ocdbt, orbax, zstd
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.models import translation, zoo
    from omnilingual_asr_torch.train import synth_train

    work = PKG / "_build" / "checkpoints"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    total: dict = {}
    try:
        # (a) the fixture
        fixture = PKG / "testdata" / "orbax_jax"
        with np.load(PKG / "testdata" / "orbax_jax_twin.npz") as z:
            twin = {k: z[k] for k in z.files}
        t0 = time.perf_counter()
        got = {zoo.keystr((part,) + p): v for part in ("asr", "translator")
               for p, v in orbax.read_flat(fixture / part).items()}
        read_s = time.perf_counter() - t0
        _same_leaves("(a) fixture", got, twin)
        chunks = []
        for part in ("asr", "translator"):
            store = ocdbt.Store(fixture / part)
            chunks += [store.read(k) for k in store.list()
                       if not k.endswith(".zarray")]
        decoded, secs = 0, []
        for _ in range(CKPT_DECODE_ROUNDS):
            t0 = time.perf_counter()
            decoded = sum(len(zstd.decompress(c)) for c in chunks)
            secs.append(time.perf_counter() - t0)
        log("  checkpoints (a) fixture " + json.dumps({
            "leaves": len(got), "equal_to_twin": True, "chunks": len(chunks),
            "decoded_mb": decoded / 1e6, "read_flat_s": read_s,
            "zstd_decode_s_median": statistics.median(secs),
            "zstd_mb_s": decoded / 1e6 / statistics.median(secs),
            "clock": "host (the card's machine)"}))

        # (b) a JAX-layout run directory, resumed in kernel mode
        dcfg = PipelineConfig()
        t0 = time.perf_counter()
        with np.load(D512) as z:
            seed_npz = {k: z[k].astype(np.float32) for k in z.files}
        npz_s = time.perf_counter() - t0
        seed = zoo.load_checkpoint(D512, dcfg)
        trans = translation.translator_init(
            torch.Generator().manual_seed(SEED), dcfg)
        run = work / "jax_layout"
        t0 = time.perf_counter()
        zoo.save_checkpoint(run / "asr", seed)
        write_s = time.perf_counter() - t0
        translation.save_translator(run / "translator", trans)
        want_trans = {k: v.numpy() for k, v in zoo.flatten(trans).items()}
        step, count, best = CKPT_RESUME
        state, moments = _jax_layout_train_state(
            {"asr": seed, "translator": trans}, step, count, best)
        np.savez(run / "train_state.npz", **state)
        t0 = time.perf_counter()
        back = {zoo.keystr(p): v
                for p, v in orbax.read_flat(run / "asr").items()}
        read_s = time.perf_counter() - t0
        _same_leaves("(b) d512 seed", back, seed_npz)
        _same_leaves("(b) translator", {
            k: v.numpy() for k, v in zoo.flatten(translation.load_translator(
                run / "translator", dcfg)).items()}, want_trans)
        with np.load(run / "train_state.npz") as z:
            _same_leaves("(b) train_state.npz", {k: z[k] for k in z.files},
                         state)
        mb = sum(v.nbytes for v in back.values()) / 1e6
        log("  checkpoints (b) d512 seed as Orbax " + json.dumps({
            "leaves": len(back), "mb": mb, "write_s": write_s,
            "read_s": read_s, "npz_load_s": npz_s,
            "clock": "host (the card's machine)"}))

        restored = []
        load_train_state = synth_train.load_train_state

        def recording(*args, **kwargs):
            out = load_train_state(*args, **kwargs)
            restored.append(out[1:])
            return out

        def first(p, opt_state):
            _same_leaves("(b) the trunk before step 1", {
                k: v.detach().cpu().numpy()
                for k, v in zoo.flatten(p["asr"]).items()}, seed_npz)
            _same_leaves("(b) the translator before step 1", {
                k: v.detach().cpu().numpy()
                for k, v in zoo.flatten(p["translator"]).items()},
                want_trans)
            keys = list(zoo.flatten(p))
            if len(keys) != len(opt_state.leaves):
                raise PhaseError("(b) the optimizer's leaves do not follow "
                                 "the parameter tree")
            got = {}
            for k, leaf in zip(keys, opt_state.leaves):
                st = opt_state.opt.state.get(leaf, {})
                if "exp_avg" not in st:
                    raise PhaseError(f"(b) no restored moments for {k}")
                got[k] = tuple(st[m].detach().cpu().numpy()
                               for m in ("exp_avg", "exp_avg_sq"))
            _same_leaves("(b) first moments before step 1",
                         {k: m for k, (m, _) in got.items()},
                         {k: m for k, (m, _) in moments.items()})
            _same_leaves("(b) second moments before step 1",
                         {k: v for k, (_, v) in got.items()},
                         {k: v for k, (_, v) in moments.items()})
            if int(opt_state.count) != count:
                raise PhaseError(f"(b) Adam's count {opt_state.count}, "
                                 f"{count} written")

        synth_train.load_train_state = recording
        try:
            counts, _, _ = _drive_train_synth(
                "checkpoints (b) resumed", dev, CKPT_TRAIN_STEPS,
                first=first, resume_from=str(run))
        finally:
            synth_train.load_train_state = load_train_state
        if restored != [(step, best)]:
            raise PhaseError(f"(b) the train state restored as {restored}, "
                             f"written as step {step}, best {best}")
        log("  checkpoints (b) resumed " + json.dumps({
            "step": step, "count": count, "best": best,
            "moments_equal": True, "translator_equal": True}))
        _add(total, counts)

        # (c) serving from an Orbax directory
        rel = work / "release_asr"
        t0 = time.perf_counter()
        zoo.save_checkpoint(rel, params)
        write_s = time.perf_counter() - t0
        engine = TranscriptionEngine(
            config=cfg.replace(checkpoint_path=str(rel)),
            xvector_params=xvector, device=dev)
        L = cfg.encoder.n_layers
        results, counts = drive_path(
            "checkpoints (c) orbax engine",
            lambda path, cb: engine.transcribe(
                path, progress_callback=cb).to_dict(),
            engine, [("golden", golden.GOLDEN_WAV)],
            {"log_mel_frames": 1, "flash_attention": L,
             "fused_conv_module": L, "quantized_matmul": 0,
             "quantized_matmul_a8": 0, "flash_attention_bwd_dq": 0,
             "flash_attention_bwd_dkv": 0})
        _add(total, counts)
        check_golden("checkpoints (c) orbax engine", engine, results[0])
        _read_counters()
        if _golden_ids(engine) != _golden_ids(npz_engine):
            raise PhaseError("(c) the Orbax engine's greedy ids differ from "
                             "the .npz engine's")
        _read_counters()
        log("  checkpoints (c) release ASR as Orbax " + json.dumps({
            "write_s": write_s, "golden": "held to golden.json",
            "ids_equal_to_npz_engine": True}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"  checkpoints launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4o: the f16 encoder
# ---------------------------------------------------------------------------

F16_ROUNDS = 3               # warm 120 s requests at f16 and bf16 (medians)
F16_TRAIN_STEPS = 3          # kernel-mode f16 train_synth steps at d512 x 12


def run_f16(dev, cfg, params, xvector, smi) -> dict:
    """Phase 4o. (a) The release with the f16 encoder serving, with one
    model shard and at (1, 2), held to ``golden_f16.json``, beside bf16 in
    turns; (b) kernel-mode f16 training at d512 x 12 and one f16 update on
    the card against the CPU. Returns the launches of each kernel."""
    import torch

    tiled = PKG / "_build" / "smoke_tiled.wav"
    write_tiled_wav(PKG / "testdata" / "golden.wav", tiled, TILED_SECONDS)
    total: dict = {}
    for label, fn in (
            ("(a) f16 serving", lambda: _dtype_serving(
                "f16", dev, cfg, params, xvector, tiled, total,
                F16_ROUNDS)),
            ("(b) f16 training", lambda: _dtype_training(
                "f16", dev, total, F16_TRAIN_STEPS))):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        log(f"  {label} {time.perf_counter() - t0:.2f} s, peak card "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        torch.cuda.empty_cache()
    log(f"  f16 launches {json.dumps(total)} ({smi})")
    return total


# ---------------------------------------------------------------------------
# Phase 4c (--profile): where a request's and a train step's time goes
# ---------------------------------------------------------------------------

def request_seconds(label, engine, path, seconds) -> None:
    """Median wall seconds of warm requests (after one warm-up)."""
    engine.transcribe(path)                       # warm-up
    times = []
    for _ in range(PROFILE_WARM_RUNS):
        t0 = time.perf_counter()
        engine.transcribe(path)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log("  profile " + json.dumps({
        "engine": label, "audio_s": seconds, "request_s_median": med,
        "request_s_all": times, "rtf": seconds / med,
        "stages_last": {k: round(v, 5)
                        for k, v in engine.last_trace.stages.items()}}))


def device_profile(label, fn, top: int) -> None:
    """One warm ``fn()`` (a request, a train step) under ``torch.profiler``:
    device time by kernel and the device's busy share of its wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Only the device's own events (kernels, copies): an operator's entry
    # repeats the time of the kernels it launched.
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    if not rows:
        log(f"  profiler ({label}): no device time recorded (not measured)")
        return
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    log(f"  profile {label}: wall {wall * 1e3:.3f} ms, device "
        f"{total_ms:.3f} ms in {sum(r[1] for r in rows)} device events, "
        f"device busy share {total_ms / 1e3 / wall:.3f}")
    for dev_us, count, key in rows[:top]:
        log(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def run_profile(engines) -> None:
    from omnilingual_asr_torch import testing as golden

    engine = engines["unquantized"]
    work = PKG / "_build" / "profile"
    paths = {}
    for seconds in PROFILE_SECONDS:
        path = work / f"t{int(seconds)}.wav"
        write_tiled_wav(golden.GOLDEN_WAV, path, seconds)
        paths[seconds] = path
        request_seconds("unquantized", engine, path, seconds)
    # The int8 engines at 120 s, in turns with the unquantized one.
    labels = ("unquantized", "a8", "w8")
    times = {label: [] for label in labels}
    for label in labels:
        engines[label].transcribe(paths[120.0])          # warm-up
    for _ in range(INT8_ROUNDS):
        for label in labels:
            t0 = time.perf_counter()
            engines[label].transcribe(paths[120.0])
            times[label].append(time.perf_counter() - t0)
    for label in labels:
        log("  profile " + json.dumps({
            "engine": label, "audio_s": 120.0, "in_turns": INT8_ROUNDS,
            "request_s_median": statistics.median(times[label]),
            "request_s_all": times[label]}))
    for label in labels:
        device_profile(f"{label} 120 s request",
                       lambda e=engines[label]: e.transcribe(paths[120.0]),
                       15 if label == "unquantized" else 8)
    engines["decoders"].transcribe(paths[120.0])          # warm-up
    device_profile("decoders 120 s request",
                   lambda: engines["decoders"].transcribe(paths[120.0]), 15)


PROFILE_TRAIN_STEPS = 6


def profile_train(dev) -> None:
    """Where a warm kernel-mode training step's time goes, at
    ``PipelineConfig()`` dims, batch 16: the host's wait for the batch, the
    upload, forward + loss, backward and the optimizer, each closed by a
    synchronize (medians over PROFILE_TRAIN_STEPS steps after 2 warm-up
    steps), then one whole step under ``torch.profiler``."""
    import dataclasses

    import numpy as np
    import torch
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.ops.attention import REFERENCE_BLOCK_Q
    from omnilingual_asr_torch.ops.mel import MelFrontend
    from omnilingual_asr_torch.train import step
    from omnilingual_asr_torch.train.augment import (SpecAugmentConfig,
                                                     spec_augment)
    from omnilingual_asr_torch.train.synth import SynthBatcher

    cfg = PipelineConfig()
    cfg = cfg.replace(encoder=dataclasses.replace(
        cfg.encoder, use_flash_attention=True, use_fused_conv=True))
    aug = SpecAugmentConfig(n_freq_masks=1, freq_mask_width=16,
                            n_time_masks=1, time_mask_width=24)
    batcher = SynthBatcher(cfg, batch_size=TRAIN_BATCH, seed=SEED + 7,
                           frame_multiple=REFERENCE_BLOCK_Q * 4, n_threads=2,
                           snr_range=(15.0, 40.0), reuse_pool=6144,
                           reuse_p=0.8)
    tx = step.make_optimizer(lr=2e-3)
    init, train_step, _ = step.make_train_step(
        cfg, dev, tx=tx, from_samples=True, with_translator=True,
        augment=aug)
    state = init(SEED)
    params, opt = state.params, state.opt_state
    leaves = step.tree_leaves(params)
    fe = MelFrontend(cfg.frontend, dev)
    phases = {k: [] for k in ("batch_wait", "upload", "forward_loss",
                              "backward", "optimizer")}
    it = iter(batcher)

    def upload(batch):
        batch["samples"] = np.clip(batch["samples"] * 32768.0, -32768,
                                   32767).astype(np.int16)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        b[step.CTC_INFEASIBLE] = step.ctc_rows(batch, cfg)
        return b

    try:
        for i in range(2 + PROFILE_TRAIN_STEPS):
            t0 = time.perf_counter()
            batch = next(it)
            t1 = time.perf_counter()
            b = upload(batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            b = step.mel_from_samples(b, fe)
            gen = torch.Generator(device=dev).manual_seed(i)
            b["mel"] = spec_augment(gen, b["mel"], b["mask"], aug)
            total, _ = step.loss_fn(params["asr"], b, cfg,
                                    trans_params=params["translator"])
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            tx.update(opt, list(grads))
            torch.cuda.synchronize()
            t5 = time.perf_counter()
            if i >= 2:
                for k, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2,
                                          t4 - t3, t5 - t4)):
                    phases[k].append(dt)
        med = {k: statistics.median(v) for k, v in phases.items()}
        log("  profile train step " + json.dumps({
            "steps": PROFILE_TRAIN_STEPS, "median_s": med,
            "step_s_median": sum(med.values()), "all_s": phases}))
        batch = upload(next(it))
        device_profile("kernel-mode train step",
                       lambda: train_step(params, opt, batch, 0), 20)
    finally:
        batcher.close()


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 4c: request seconds by length and a "
                         "torch.profiler device-time breakdown")
    args = ap.parse_args(argv)
    if not PKG.is_dir() or not RELEASE.is_dir():
        print("chip_smoke.py must run from the repository root (it needs "
              "omnilingual_asr_torch/ and checkpoints/release/)",
              file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    os.environ["OMNIASR_RELEASE_DIR"] = ""   # weights load by explicit path

    t_start = time.perf_counter()
    phase = "device"
    try:
        t0 = time.perf_counter()
        smi = nvidia_smi_line()
        dev = torch.device("cuda", 0)
        name = torch.cuda.get_device_name(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        peaks = card_peaks(name)
        log(f"[device] {smi} | torch {torch.__version__} cuda "
            f"{torch.version.cuda} | peaks {peaks} "
            f"({time.perf_counter() - t0:.2f} s)")

        phase = "build"
        t0 = time.perf_counter()
        from omnilingual_asr_torch.ops import cuda_build

        info = cuda_build.build()
        cuda_build.library()
        ptxas = {}
        for name, regs, spills in info.kernels():
            log(f"  {name}: {regs} registers, {spills}")
            ptxas[name] = f"{regs} registers, {spills}"
        if info.cached:
            log("  (a cached build: registers not read in this run)")
        log(f"[build] {'cached' if info.cached else 'built'} "
            f"{info.lib_path.relative_to(ROOT)} in {info.seconds:.2f} s "
            f"({time.perf_counter() - t0:.2f} s)")

        phase = "kernels"
        t0 = time.perf_counter()
        from omnilingual_asr_torch.config import PipelineConfig
        from omnilingual_asr_torch.models.zoo import (load_checkpoint,
                                                      load_xvector)

        cfg = PipelineConfig.from_json(
            (RELEASE / "config.json").read_text(),
            checkpoint_path=str(RELEASE / "asr.npz"))
        params = load_checkpoint(RELEASE / "asr.npz", cfg, dev)
        xvector = load_xvector(RELEASE / "xvector.npz", cfg, dev)
        kernels = [check_k1(dev, peaks, cfg), check_k2(dev, peaks, cfg),
                   check_k3(dev, peaks, cfg, params, ptxas),
                   *check_quant(dev, peaks, params, ptxas),
                   *check_flash_bwd(dev, peaks, PipelineConfig()),
                   *check_flash_f32(dev, peaks, ptxas),
                   *check_flash_f16(dev, peaks, ptxas)]
        for k in kernels:
            log(f"  {k['name']}: max abs err {k['max_abs_err']:.3e} (tol "
                f"{k['tol']}), {k['ms']:.4f} ms (one eager call "
                f"{k['call_ms']:.4f} ms), plain {k['plain_ms']:.4f} ms, "
                f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms "
                f"({k['bound_by']}), {k['shape']}")
            extra = {x: k[x] for x in ("design", "bound_at", "bound_fma_ms",
                                       "tiny_do", "large_do", "ptxas",
                                       "ptxas_earlier") if x in k}
            if extra:
                log(f"    {json.dumps(extra)}")
            for w in (k.get("widths", []) + k.get("head_dims", [])
                      + k.get("shapes", [])):
                log(f"    {json.dumps(w)}")
        log(f"  recorded, not measured in this run: the earlier designs' "
            f"device ms {json.dumps(RECORDED_EARLIER_MS)}")
        log(f"[kernels] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "e2e"
        t0 = time.perf_counter()
        engines, serving = run_e2e(dev, cfg, params, xvector)
        log(f"[e2e] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "train"
        t0 = time.perf_counter()
        training = run_train(dev)
        grad_check(dev)
        log(f"[train] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "decoders"
        t0 = time.perf_counter()
        engines["decoders"], decoding = run_decoders(dev, cfg, params,
                                                     xvector)
        log(f"[decoders] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "server"
        t0 = time.perf_counter()
        served = run_server(engines["decoders"], smi)
        log(f"[server] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "d512"
        t0 = time.perf_counter()
        d512 = run_d512(dev, smi, params, xvector)
        log(f"[d512] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "evals"
        t0 = time.perf_counter()
        evals = run_evals(dev, cfg, params, xvector)
        log(f"[evals] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "trainers"
        t0 = time.perf_counter()
        trainers = run_trainers(dev, cfg, params, smi)
        log(f"[trainers] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "rest"
        t0 = time.perf_counter()
        rest = run_rest_of_training(dev, smi)
        log(f"[rest] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "mesh"
        t0 = time.perf_counter()
        mesh = run_mesh(dev, cfg, params, xvector, smi)
        log(f"[mesh] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "tp"
        t0 = time.perf_counter()
        tp_path = run_tp(dev, cfg, params, xvector, smi)
        log(f"[tp] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "mesh_training"
        t0 = time.perf_counter()
        mesh_training = run_mesh_training(dev, smi, profile=args.profile)
        log(f"[mesh_training] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "f32_moe_mesh"
        t0 = time.perf_counter()
        f32_moe_mesh = run_f32_moe_mesh(dev, cfg, params, xvector, smi)
        log(f"[f32_moe_mesh] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "multiprocess"
        t0 = time.perf_counter()
        multiprocess = run_multiprocess(dev, smi)
        log(f"[multiprocess] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "f16"
        t0 = time.perf_counter()
        f16 = run_f16(dev, cfg, params, xvector, smi)
        log(f"[f16] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "checkpoints"
        t0 = time.perf_counter()
        checkpoints = run_checkpoints(dev, cfg, params, xvector,
                                      engines["unquantized"], smi)
        log(f"[checkpoints] ok ({time.perf_counter() - t0:.2f} s)")

        if args.profile:
            phase = "profile"
            t0 = time.perf_counter()
            run_profile(engines)
            profile_train(dev)
            log(f"[profile] ok ({time.perf_counter() - t0:.2f} s)")

        phase = "report"
        # K3's launches: whole, and split over a model axis (one a shard).
        by_fn = {"log_mel": ("log_mel_frames",),
                 "flash_attention_fwd": ("flash_attention",),
                 "conv_module": ("fused_conv_module",
                                 "fused_conv_module_split"),
                 "q_matmul_w8a16": ("quantized_matmul",),
                 "q8a8_matmul": ("quantized_matmul_a8",),
                 "flash_attention_bwd_dq": ("flash_attention_bwd_dq",),
                 "flash_attention_bwd_dkv": ("flash_attention_bwd_dkv",),
                 "flash_attention_fwd_f32": ("flash_attention_f32",),
                 "flash_attention_bwd_dq_f32": ("flash_attention_bwd_dq_f32",),
                 "flash_attention_bwd_dkv_f32": (
                     "flash_attention_bwd_dkv_f32",),
                 "flash_attention_fwd_f16": ("flash_attention_f16",),
                 "flash_attention_bwd_dq_f16": ("flash_attention_bwd_dq_f16",),
                 "flash_attention_bwd_dkv_f16": (
                     "flash_attention_bwd_dkv_f16",)}
        paths = {"serving": serving, "training": training,
                 "decoders": decoding, "server": served, "d512": d512,
                 "evals": evals, "trainers": trainers,
                 "rest_of_training": rest, "mesh": mesh, "tp": tp_path,
                 "mesh_training": mesh_training,
                 "f32_moe_mesh": f32_moe_mesh, "multiprocess": multiprocess,
                 "f16": f16, "checkpoints": checkpoints}
        line = {"kernels": []}
        for k in kernels:
            fns = by_fn[k["name"]]
            by_path = {p: sum(c.get(f, 0) for f in fns)
                       for p, c in paths.items()}
            line["kernels"].append({
                "name": k["name"], "route": k["route"],
                "source": k["source"], "replaces": k["replaces"],
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                **({"design": k["design"]} if "design" in k else {})})
        log(f"[report] total {time.perf_counter() - t_start:.2f} s")
        print(json.dumps(line), flush=True)
        print(nvidia_smi_line(), flush=True)
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: phase {phase!r} failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
