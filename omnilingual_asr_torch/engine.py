"""TranscriptionEngine on PyTorch: serving on CUDA cards.

The PyTorch port of ``omnilingual_asr_tpu/engine.py``, with the same
surface and semantics: ``transcribe``, ``transcribe_chunked``,
``transcribe_with_retry``, ``transcribe_streaming`` (partial segments after
each device batch, then the final result) and ``health_check``, the 4-step
progress contract, the result types and the StageTrace stage names
(``decode``, ``forward``, ``extract``, ``assemble`` and
``assemble.<sub-stage>``). The JAX engine's single-device modes are all
here: prefix beam search with the lexicon LM (``decode.beam_size > 1``,
``ops/beam.py``, ``ops/lexicon.py``), per-segment speaker re-embedding
(``speaker_mode="crop"``), μ-law ingress (``ingress="mulaw"``,
``audio/codec.py``) and the slim speaker wire (``decode.spk_frame_stride``,
``decode.spk_wire="i8"``), and the mesh modes: windows split over the
``data`` axis of a mesh (``parallel/mesh.py``), tensor parallelism over
its ``model`` axis (each data row's forward over the row's model shards,
``models/conformer.py::tp_asr_forward``; the int8 kernel modes need a
``model`` axis of 1, as in JAX), ``long_mode="sequence"`` (a whole file
as one sequence over the data axis: ring attention and the conv halo
exchange, ``parallel/sequence.py``) and the packed wire
(``decode.wire_pack``: a batch's outputs come back in one device-to-host
copy, ``ops/pack.py``).

Execution model:
- audio is decoded on the host by the native ``omniaudio`` library (and
  resampled there where the build links libav; otherwise by
  ``audio/resample.py``) and cut into fixed 30 s int16 windows;
- windows are batched to a fixed [B, T] shape and run through the per-batch
  program ``_process``: framing, the log-mel kernel (K1), the conformer with
  the flash-attention (K2) and fused conv-module (K3) kernels (and, under
  ``quantize="w8"``/``"a8"``, the int8 matmul kernels K4/K5), the heads, the
  x-vector embedder, argmax, LID confidence and frame energy, all on the card;
- every batch is enqueued on a CUDA stream before any is collected, so host
  extraction of batch k overlaps the device work of later batches; on a
  mesh, each data shard's windows run on its device with the parameters
  replicated there (one copy a distinct device), and the outputs are
  gathered in window order; with a ``model`` axis above 1 the mel runs
  once a data row, on the row's first device, and the conformer over the
  row's model shards, each holding its block of every split parameter
  (``models/conformer.py::asr_param_specs``); the heads, argmax and wire
  packing run on the row's first device;
- CTC collapse, segmentation, pooling, the beam search over the device's
  per-frame top-K scores and whole-file speaker clustering run on the host,
  exactly as in the JAX engine; in crop mode each segment's audio is
  re-embedded by a second forward (16 crops of 6 s a batch, K1 and the
  plain-op trunk, or the x-vector);
- a batch whose device program raises is dispatched once more before the
  error surfaces (not a kernel build failure);
- with decoder weights loaded (the release's text-mode translator and
  fact-conditioned summarizer), segment translations and the neural summary
  are greedy-decoded on the engine's device (``models/translation.py``,
  one CUDA graph a decode step on a card).

The engine runs on CUDA unless the caller passes ``device="cpu"``; then every
kernel wrapper takes its plain PyTorch version. With no CUDA device and no
explicit ``device="cpu"``, construction raises.

One engine serves concurrent requests (the server runs up to four files at
once, one thread each). The work that shares device state, the batched
device program and the decoders (whose CUDA graphs replay over static
buffers and are captured on first use), and the crop re-embedding run under
one lock; host decoding, host extraction and clustering run outside it, so
concurrent requests overlap their host work with each other's device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import os
import threading
import time
import warnings
import wave
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .audio.codec import mulaw_decode, mulaw_encode
from .audio.decode import decode_audio, get_audio_duration
from .audio.native_lib import native_available, native_decode
from .audio.resample import resample
from .config import MeshConfig, PipelineConfig
from .device import exact_f32, resolve_device
from .diarization.cluster import DEFAULT_THRESHOLD as CLUSTER_DEFAULT_THRESHOLD
from .diarization.cluster import cluster_speakers
from .models import languages as lang_table
from .models.conformer import (SPK_DIM, asr_forward, asr_init,
                               asr_param_specs, check_tp_dims,
                               pooled_speaker_embed_np, shard_for_tp,
                               subsampled_mask, tp_asr_forward)
from .models.orthography import ctc_logit_mask
from .models.summarizer import (SummaryDecoder, summary_consistent,
                                template_summary)
from .models.translation import (MAX_SOURCE_LEN, GreedyDecoder,
                                 load_translator, source_to_tokens,
                                 tokens_to_text)
from .models.xvector import xvector_frames
from .models.zoo import (default_release_dir, load_checkpoint, load_xvector,
                         tree_to)
from .ops.attention import REFERENCE_BLOCK_Q
from .ops.beam import LOG_ZERO, ctc_prefix_beam_search
from .ops.conv_module import dense_weight
from .ops.ctc import segments_from_alignment
from .ops.cuda_build import KernelBuildError
from .ops.lexicon import TrieLM, synth_lexicon
from .ops.mel import BLOCK_T, MelFrontend
from .ops.pack import layout_of, pack_tree, unpack_buffer
from .ops.quant import (add_kernel_layouts, quantize_param_tree,
                        quantize_spec_tree)
from .parallel.mesh import Mesh, build_mesh, require_one_process
from .parallel.sequence import sp_conformer_forward
from .types import EMOTIONS, TranscriptSegment, TranscriptionResult
from .utils.tracing import StageTrace

ProgressCallback = Optional[Callable[[str, int], None]]

# Fixed inference window: 30 s at 16 kHz -> 2998 mel frames -> 3072 padded.
WINDOW_SECONDS = 30.0

# Window of the per-segment speaker re-embedding (speaker_mode="crop"):
# longer segments are center-cropped to it. 6 s -> 598 frames -> 768 padded.
SPK_CROP_SECONDS = 6.0
SPK_CROP_BATCH = 16

# AHC merge cut for crop-mode trunk embeddings (the JAX engine's).
CROP_AHC_THRESHOLD = 0.22

# Classes a frame ships to the host for the beam search (at most).
BEAM_TOPK = 8

# AHC merge cut for x-vector embeddings (DecodeConfig.ahc_threshold
# overrides).
XVECTOR_AHC_THRESHOLD = 0.30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ctc_topk(logits: torch.Tensor, k: int):
    """(log-probabilities, classes) of each frame's ``k`` likeliest CTC
    classes, best first: the beam search's feed. A stable descending sort
    orders ties lower class first, as ``jax.lax.top_k`` does."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    top_lp, top_ids = torch.sort(logp, dim=-1, descending=True, stable=True)
    return top_lp[..., :k], top_ids[..., :k]


@dataclasses.dataclass
class _Replica:
    """What one device of the data axis computes a shard batch with: the
    parameters, the x-vector embedder, the mel constants and a stream."""
    device: torch.device
    params: dict
    xvector: Optional[dict]
    frontend: MelFrontend
    stream: Optional["torch.cuda.Stream"]
    #: With a model axis above 1: the row's model shards' trees (shard m
    #: on the row's device m); ``params`` is then unused.
    shards: Optional[List[dict]] = None


def _bf16_conv(params):
    """``params`` with each block's conv-module pointwise weights as
    ``{"w": bf16}`` (a quantized one dequantized in f32 first), as the
    fused conv module takes them; the other leaves shared."""
    blocks = []
    for blk in params["blocks"]:
        conv = dict(blk["conv"])
        for name in ("pw1", "pw2"):
            conv[name] = {"w": dense_weight(conv[name]).to(
                torch.bfloat16).contiguous()}
        blocks.append({**blk, "conv": conv})
    return {**params, "blocks": blocks}


def _progress_reporters(progress_callback: ProgressCallback):
    """(report, report_frac) wrappers over the reference 2-arg callback.

    2-arg callbacks are called exactly once per step; callbacks that take a
    third positional parameter also get intra-step calls carrying a
    ``fraction`` in [0, 1]."""
    if progress_callback is None:
        return (lambda *_: None), (lambda *_: None)
    takes_frac = False
    try:
        sig = inspect.signature(progress_callback)
        n_pos = sum(1 for p in sig.parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
        takes_frac = n_pos >= 3 or any(
            p.kind is p.VAR_POSITIONAL for p in sig.parameters.values())
    except (TypeError, ValueError):
        pass

    def report(step: str, idx: int) -> None:
        progress_callback(step, idx)

    if takes_frac:
        def report_frac(step: str, idx: int, fraction: float) -> None:
            progress_callback(step, idx, fraction)
    else:
        def report_frac(step: str, idx: int, fraction: float) -> None:
            pass

    return report, report_frac


class TranscriptionEngine:
    """Local GPU ASR engine with the JAX engine's surface.

    ``api_key`` and ``model`` are accepted for drop-in compatibility and
    ignored. On CUDA the constructor sets ``torch.backends.cuda.matmul.
    allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` to False for the
    process: the reference accumulates every product in f32.

    ``quantize`` selects int8 serving as in the JAX engine: ``True`` holds
    every dense weight as int8 with per-channel scales and dequantizes it
    into the bf16 matmuls; ``"w8"`` and ``"a8"`` also route the layers that
    the kernels take (in_dim % 128 == 0, out_dim % 512 == 0) through the
    W8A16 kernel K4 or the W8A8 kernel K5 (``ops/quant.py``). Under
    tensor parallelism the kernel modes raise ValueError, as in the JAX
    engine; ``quantize=True`` serves there.

    ``speaker_mode``: ``"inline"`` pools the main forward's speaker frames;
    ``"crop"`` re-embeds each segment's audio in a forward of its own;
    ``"auto"`` (the default) is inline with x-vector weights, crop without.
    ``ingress``: ``"i16"`` ships int16 windows to the card, ``"mulaw"``
    8-bit μ-law codes decoded on the card before the frontend.

    ``mesh`` (``parallel.mesh.build_mesh``): the windows of a batch split
    over its ``data`` axis, ``batch_windows_per_device`` a shard, and in
    sequence mode a file's frames split over it. A ``model`` axis above 1
    is tensor parallelism: each data row's forward (and the crop
    re-embedding's) runs over the row's model shards, which must divide
    the heads, the model and FFN widths and the LID classes (ValueError
    otherwise); sequence mode runs on the parameters gathered on the
    row's first device, as the JAX engine passes them replicated. Devices
    may repeat (a mesh of shards on one card). Without a mesh, an engine
    given ``device`` runs on a mesh of that one device, and one given neither
    spans every visible CUDA device along ``data`` (the JAX engine spans
    ``jax.devices()``); its primary device (the mesh's first) runs the
    crop re-embedding and the decoders.
    """

    def __init__(
        self,
        api_key: Optional[str] = None,
        model: str = "local-gpu",
        *,
        config: Optional[PipelineConfig] = None,
        params=None,
        device=None,
        batch_windows_per_device: int = 4,
        window_seconds: float = WINDOW_SECONDS,
        enable_translation: bool = False,
        translator_params=None,
        translator_path: Optional[str] = None,
        summarizer_params=None,
        summarizer_path: Optional[str] = None,
        quantize: "bool | str" = False,
        long_mode: str = "window",
        ingress: Optional[str] = None,
        speaker_mode: Optional[str] = None,
        xvector_params=None,
        xvector_path: Optional[str] = None,
        mesh: Optional[Mesh] = None,
    ) -> None:
        if long_mode not in ("window", "sequence"):
            raise ValueError(f"long_mode must be 'window' or 'sequence', "
                             f"got {long_mode!r}")
        speaker_mode = speaker_mode or os.getenv(
            "OMNIASR_SPEAKER_MODE", "auto")
        if speaker_mode not in ("auto", "crop", "inline"):
            raise ValueError(f"speaker_mode must be 'auto', 'crop' or "
                             f"'inline', got {speaker_mode!r}")
        if quantize not in (False, True, "a8", "w8"):
            raise ValueError(f"quantize must be False, True, 'a8' or 'w8', "
                             f"got {quantize!r}")
        ingress = ingress or os.getenv("OMNIASR_INGRESS", "i16")
        if ingress not in ("i16", "mulaw"):
            raise ValueError(f"ingress must be 'i16' or 'mulaw', "
                             f"got {ingress!r}")
        #: "window": 30 s windows batched over the mesh's data axis.
        #: "sequence": a whole file as one sequence split over that axis.
        self.long_mode = long_mode
        self.ingress = ingress

        self.config = config or PipelineConfig.from_env()
        cfg = self.config
        self.model = model
        if mesh is None:
            if device is not None:
                # This process's one device (build_mesh would span the
                # processes after init_distributed).
                mesh = Mesh([[resolve_device(device)]], ("data", "model"))
            else:
                resolve_device(None)   # raises without CUDA
                mesh = build_mesh(cfg.mesh)
        elif device is not None and resolve_device(device) != \
                mesh.devices.flat[0]:
            raise ValueError(f"device {device!r} is not the mesh's first "
                             f"device {mesh.devices.flat[0]}")
        require_one_process(mesh, "serving")
        #: Model shards a data row's forward splits over (1: no tensor
        #: parallelism).
        self.n_model = mesh.shape.get("model", 1)
        if self.n_model > 1:
            if quantize in ("a8", "w8"):
                raise ValueError(
                    "quantize='a8'/'w8' (the int8 kernels K5/K4) requires "
                    "model-parallel axis 1; use quantize=True with tensor "
                    "parallelism")
            check_tp_dims(self.config, self.n_model)
        self.mesh = mesh
        self.device = mesh.devices.flat[0]
        exact_f32(mesh.distinct_devices())
        self.last_trace: Optional[StageTrace] = None
        #: Held around the work that shares device state: the batched
        #: device program (enqueue) and the decoders.
        self._device_lock = threading.Lock()

        release = default_release_dir()

        def released(name: str) -> Optional[str]:
            if release is None:
                return None
            p = release / f"{name}.npz"
            return str(p) if p.is_file() else None

        def load_decoder(explicit_path, env_name, release_name, n_layers):
            """Explicit paths must load (errors propagate); a discovered
            release file is best-effort: it may belong to another config
            (a tiny test config, say), and is then skipped."""
            path = explicit_path or os.getenv(env_name)
            if path:
                return load_translator(path, cfg, n_layers=n_layers)
            path = released(release_name)
            if path:
                try:
                    return load_translator(path, cfg, n_layers=n_layers)
                except (KeyError, ValueError):
                    return None
            return None

        # Translation and the neural summary need trained decoder weights: a
        # random decoder would write noise where None and the template are
        # schema-valid. The decoders are never quantized.
        if translator_params is None:
            translator_params = load_decoder(
                translator_path, "OMNIASR_TRANSLATOR", "translator", 4)
        if enable_translation and translator_params is None:
            warnings.warn(
                "enable_translation=True but no translator checkpoint is "
                "available (pass translator_params/translator_path or set "
                "OMNIASR_TRANSLATOR); translation stays disabled.",
                stacklevel=2)
        #: The translator's decoder (text mode when its tree has "src").
        self._translator: Optional[GreedyDecoder] = None
        if translator_params is not None:
            self._translator = GreedyDecoder(
                tree_to(translator_params, self.device), cfg)
        if summarizer_params is None:
            summarizer_params = load_decoder(
                summarizer_path, "OMNIASR_SUMMARIZER", "summarizer", 2)
        self._summarizer: Optional[SummaryDecoder] = None
        if summarizer_params is not None:
            self._summarizer = SummaryDecoder(
                cfg, tree_to(summarizer_params, self.device))

        # Dedicated speaker embedder: explicit params/path must load; a
        # discovered release file is best-effort.
        self._xvector = xvector_params
        if self._xvector is None:
            xp = xvector_path or os.getenv("OMNIASR_XVECTOR")
            if xp:
                self._xvector = load_xvector(xp, cfg)
            elif released("xvector"):
                try:
                    self._xvector = load_xvector(released("xvector"), cfg)
                except (KeyError, ValueError):
                    self._xvector = None
        if self._xvector is not None and cfg.encoder.subsample_factor != 4:
            raise ValueError(
                "the x-vector embedder emits frames at 1/4 mel rate; "
                "encoder.subsample_factor must be 4 to align with it")
        if speaker_mode == "auto":
            speaker_mode = "inline" if self._xvector is not None else "crop"
        self.speaker_mode = speaker_mode
        #: The beam search's lexicon LM, built on first use.
        self._lexicon_lm = None

        if params is None:
            if cfg.checkpoint_path:
                params = load_checkpoint(cfg.checkpoint_path, cfg)
            else:
                warnings.warn(
                    "No ASR checkpoint found (checkpoint_path unset and no "
                    "release discovered): serving RANDOM-INIT weights — "
                    "transcriptions will be noise.", stacklevel=2)
                params = asr_init(torch.Generator().manual_seed(cfg.seed),
                                  cfg)
        # Host copy of the active embedder's pooling projection, taken
        # before quantization so that the host matmul stays f32.
        pool_src = self._xvector if self._xvector is not None else params
        self._spk_pool = {"spk_proj": {
            k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in pool_src["spk_proj"].items()}}
        #: Quantized-kernel mode of the dense layers: "a8" (K5), "w8" (K4)
        #: or None (quantize=True and unquantized serving).
        self._quant_kernel = quantize if quantize in ("a8", "w8") else None
        # The placement of the ASR tree over the model axis.
        specs = asr_param_specs(cfg)
        if quantize:
            # Int8 serving: every dense weight is held as int8 plus a
            # per-channel scale. quantize=True dequantizes it into the bf16
            # matmuls; "a8"/"w8" route the layers the kernels take through
            # K5/K4, which read a K-contiguous copy kept from here on. The
            # x-vector embedder stays unquantized (it is held apart).
            params = quantize_param_tree(params)
            specs = quantize_spec_tree(specs)
            if self._quant_kernel is not None:
                params = add_kernel_layouts(params)
        self.params = tree_to(params, self.device)
        if self._xvector is not None:
            self._xvector = tree_to(self._xvector, self.device)

        # Window geometry.
        fe = cfg.frontend
        sub = cfg.encoder.subsample_factor
        self.window_samples = int(window_seconds * fe.sample_rate)
        n_frames = fe.frames_for_samples(self.window_samples)
        self.window_frames = _round_up(n_frames, math.lcm(BLOCK_T, sub))
        self.frame_dur_s = fe.hop_length * sub / fe.sample_rate
        #: Windows a batch: ``batch_windows_per_device`` a data shard.
        self.n_data = self.mesh.shape["data"]
        self.shard_batch = batch_windows_per_device
        self.batch_size = batch_windows_per_device * self.n_data
        # Crop geometry: SPK_CROP_SECONDS of samples, their frames padded
        # as a window's are.
        self.crop_samples = int(SPK_CROP_SECONDS * fe.sample_rate)
        self.crop_frames = _round_up(fe.frames_for_samples(self.crop_samples),
                                     math.lcm(BLOCK_T, sub))
        self._frontend = MelFrontend(fe, self.device)

        # Inference config, decided exactly as the JAX engine decides it
        # (engine.py:358-377), so both take the same numerical paths: flash
        # attention when the subsampled window tiles the reference's query
        # blocks, the fused conv module under the reference's 12 MB VMEM
        # estimate.
        t_sub = self.window_frames // sub
        use_flash = t_sub % REFERENCE_BLOCK_Q == 0
        d = cfg.encoder.d_model
        conv_vmem = 4 * (t_sub * d * 3 + t_sub * 2 * d + d * 2 * d + d * d
                         + cfg.encoder.conv_kernel * d)
        use_fused_conv = conv_vmem < 12 * 1024 * 1024
        self.infer_config = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, use_flash_attention=use_flash,
            use_fused_conv=use_fused_conv))
        #: The crop re-embedding's trunk: plain attention and conv module
        #: (as in the JAX engine), on the conv weights as loaded.
        self._crop_config = cfg.replace(encoder=dataclasses.replace(
            cfg.encoder, use_flash_attention=False, use_fused_conv=False))
        #: The parameters as loaded (f32 conv weights): the crop
        #: re-embedding's and sequence mode's.
        self._plain_params = self.params
        #: With a model axis above 1: each distinct data row's model shards
        #: (by the row's devices), cut from the tree as loaded, and the crop
        #: re-embedding's (the primary row's, as loaded).
        row_shards: Dict[tuple, List[dict]] = {}
        self._crop_shards: Optional[List[dict]] = None
        if self.n_model > 1:
            for row in self._mesh_rows():
                if row not in row_shards:
                    row_shards[row] = shard_for_tp(self.params, cfg,
                                                   list(row), specs)
            first = row_shards[self._mesh_rows()[0]]
            if speaker_mode == "crop":
                self._crop_shards = first
            if use_fused_conv:
                row_shards = {row: [_bf16_conv(t) for t in trees]
                              for row, trees in row_shards.items()}
        tp_on = self.n_model > 1
        if use_fused_conv and not tp_on:
            # The fused conv module rounds its pointwise weights to bf16;
            # hold them so once, rather than cast them on every call. A
            # quantized weight is dequantized in f32 first, as the
            # reference feeds its kernel.
            self.params = _bf16_conv(self.params)
        if speaker_mode != "crop" and long_mode != "sequence":
            self._plain_params = self.params
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        #: One replica a distinct data row (the primary's holds the
        #: engine's own tensors), on the row's first device; shard i of a
        #: batch runs on ``self._replicas[i]``. With a model axis above 1
        #: a replica holds its row's model shards.
        primary = _Replica(self.device, None if tp_on else self.params,
                           self._xvector, self._frontend, self._stream,
                           row_shards.get(self._mesh_rows()[0]))
        by_row = {self._mesh_rows()[0]: primary}
        for row in self._mesh_rows():
            if row not in by_row:
                d = row[0]
                by_row[row] = _Replica(
                    d, None if tp_on else tree_to(self.params, d),
                    tree_to(self._xvector, d) if self._xvector else None,
                    MelFrontend(fe, d),
                    torch.cuda.Stream(d) if d.type == "cuda" else None,
                    row_shards.get(row))
        self._replicas = [by_row[row] for row in self._mesh_rows()]
        #: The packed wire's layout of a shard batch's outputs, fixed here
        #: (None: the outputs come back leaf by leaf).
        self._out_layout = (layout_of(self._wire_spec(self.shard_batch))
                            if cfg.decode.wire_pack else None)
        #: Device-to-host copies the window path has made (a packed shard
        #: batch makes one).
        self.d2h_copies = 0
        #: Sequence mode's frontend (pre-emphasis on the host), built on
        #: first use.
        self._seq_frontend: Optional[MelFrontend] = None
        for d in self.mesh.distinct_devices():
            if d.type == "cuda":
                torch.cuda.synchronize(d)   # weights are on the card

    def _mesh_rows(self) -> List[tuple]:
        """Each data row's devices along the model axis, as a tuple; rows
        on the same devices are equal (they share a replica)."""
        return [tuple(row) for row in self.mesh.devices]

    # ------------------------------------------------------------------
    # The per-batch device program
    # ------------------------------------------------------------------

    def _wire_spec(self, B: int) -> Dict[str, tuple]:
        """{name: (dtype, shape)} of ``_process``'s outputs for B windows:
        the packed wire's layout (``ops/pack.py::layout_of``)."""
        cfg = self.config
        Tp = self.window_frames // cfg.encoder.subsample_factor
        stride = max(1, cfg.decode.spk_frame_stride)
        Ts = Tp // stride if stride > 1 else Tp
        spec = {"ctc_ids": (torch.int16, (B, Tp)),
                "lid_ids": (torch.int16, (B, Tp)),
                "lid_conf": (torch.float16, (B, Tp)),
                "emotion_logits": (torch.float16, (B, Tp, len(EMOTIONS))),
                "frame_energy": (torch.float16, (B, Tp)),
                "mask": (torch.bool, (B, Tp))}
        if cfg.decode.spk_wire == "i8":
            spec["speaker_frames_q"] = (torch.int8, (B, Ts, SPK_DIM))
            spec["speaker_scale"] = (torch.float16, (B, Ts))
        else:
            spec["speaker_frames"] = (torch.float16, (B, Ts, SPK_DIM))
        if cfg.decode.beam_size > 1:
            K = min(BEAM_TOPK, 1 + cfg.vocab.n_bytes)
            spec["ctc_topk_logp"] = (torch.float32, (B, Tp, K))
            spec["ctc_topk_ids"] = (torch.int16, (B, Tp, K))
        if self._states_consumer:
            spec["encoder_states"] = (torch.float16,
                                      (B, Tp, cfg.encoder.d_model))
        return spec

    @torch.inference_mode()
    def _process(self, samples_i16: torch.Tensor, n_valid: torch.Tensor,
                 ctc_mask: torch.Tensor,
                 rep: Optional[_Replica] = None) -> Dict[str, torch.Tensor]:
        """Raw int16 samples [B, window_samples] (or uint8 μ-law codes)
        -> compact head outputs, on ``rep``'s device (default: the
        primary's).

        n_valid: [B] int32 valid mel frames per window (0 for a padded
        slot). Outputs carry the JAX engine's wire dtypes (i16 ids, f16
        features; speaker frames mean-pooled over ``decode.spk_frame_stride``
        frames, and as int8 with an f16 scale a frame under
        ``decode.spk_wire="i8"``); host clustering runs on the rounded
        speaker frames. With ``decode.beam_size > 1`` each frame's top
        ``BEAM_TOPK`` CTC log-probabilities and their classes ride along.
        """
        cfg = self.config
        icfg = self.infer_config
        rep = rep or self._replicas[0]
        fe = rep.frontend
        B = samples_i16.shape[0]
        if samples_i16.dtype == torch.uint8:          # μ-law wire format
            samples = mulaw_decode(samples_i16)
        else:
            samples = samples_i16.to(torch.float32) * (1.0 / 32768.0)
        frames, _ = fe.frames_from_signal(samples)      # [B, T_pad, n_fft]
        mel = fe.log_mel(frames)[:, :self.window_frames]
        frame_idx = torch.arange(self.window_frames, device=mel.device)
        mask = frame_idx[None, :] < n_valid[:, None]
        if rep.shards is not None:
            out = tp_asr_forward(rep.shards, mel, mask, icfg)
        else:
            out = asr_forward(rep.params, mel, mask, icfg,
                              quant=self._quant_kernel)
        # Per-subsampled-frame energy (dB proxy) for host-side pooling.
        e = torch.logsumexp(mel, dim=-1) * (10.0 / math.log(10.0))
        sub = icfg.encoder.subsample_factor
        e_sub = e.reshape(B, -1, sub).mean(dim=-1)
        n_real = 1 + cfg.vocab.n_bytes
        masked = out["ctc_logits"] + ctc_mask[None, None, :]
        real = masked[..., :n_real]
        ctc_ids = torch.argmax(real, dim=-1)
        lid_ids = torch.argmax(out["lid_logits"], dim=-1)
        lid_conf = torch.softmax(out["lid_logits"], dim=-1).amax(dim=-1)
        spk_frames = out["speaker_frames"]
        if rep.xvector is not None:
            spk_frames = xvector_frames(rep.xvector, mel, mask)
        stride = max(1, cfg.decode.spk_frame_stride)
        if stride > 1:
            T2 = spk_frames.shape[1] // stride
            spk_frames = spk_frames[:, :T2 * stride].reshape(
                B, T2, stride, spk_frames.shape[-1]).mean(dim=2)
        ret = {
            "ctc_ids": ctc_ids.to(torch.int16),
            "lid_ids": lid_ids.to(torch.int16),
            "lid_conf": lid_conf.to(torch.float16),
            "emotion_logits": out["emotion_logits"].to(torch.float16),
            "frame_energy": e_sub.to(torch.float16),
            "mask": out["mask"],
        }
        if cfg.decode.spk_wire == "i8":
            scale = spk_frames.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
            ret["speaker_frames_q"] = torch.clamp(
                torch.round(spk_frames / scale), -127, 127).to(torch.int8)
            ret["speaker_scale"] = scale[..., 0].to(torch.float16)
        else:
            ret["speaker_frames"] = spk_frames.to(torch.float16)
        if cfg.decode.beam_size > 1:
            top_lp, top_ids = ctc_topk(real, min(BEAM_TOPK, n_real))
            ret["ctc_topk_logp"] = top_lp
            ret["ctc_topk_ids"] = top_ids.to(torch.int16)
        if self._states_consumer:
            # Encoder states for the summarizer or an audio-conditioned
            # translator, f16 on the wire; only copied when one is loaded.
            ret["encoder_states"] = out["encoder_states"].to(torch.float16)
        return ret

    # ------------------------------------------------------------------
    # Feature + forward plumbing
    # ------------------------------------------------------------------

    def _load_audio(self, audio_path: Path) -> np.ndarray:
        target = self.config.frontend.sample_rate
        # Fast path: native decode + resample in one in-process C++ call.
        # The WAV-only build (no libav) returns the file's own rate; unlike
        # the JAX engine, which takes those samples as they are, the port
        # resamples them then (ROADMAP.md, Queue C).
        if native_available():
            out = native_decode(audio_path, target_sr=target)
            if out is not None:
                samples, sr = out
                return (samples if sr == target
                        else resample(samples, sr, target))
        samples, sr = decode_audio(audio_path)
        if sr != target:
            samples = resample(samples, sr, target)
        return samples

    def _stream_windows_wav(self, audio_path: Path):
        """Lazy window stream over a long PCM-16 WAV at the engine rate.

        Returns (window_iter, n_windows, n_samples_last, duration_s), or
        None when the file is decoded whole instead: a non-WAV container,
        another rate or format, or no longer than the chunking threshold."""
        sr = self.config.frontend.sample_rate
        try:
            w = wave.open(str(audio_path), "rb")
        except (OSError, EOFError, wave.Error):
            return None
        try:
            if (w.getcomptype() != "NONE" or w.getsampwidth() != 2
                    or w.getframerate() != sr or w.getnchannels() < 1):
                w.close()
                return None
            n_channels = w.getnchannels()
            n_frames = w.getnframes()
        except (OSError, EOFError, wave.Error):
            w.close()
            return None
        if n_frames / sr <= self.config.chunking.min_duration_for_chunking_s:
            w.close()           # short file: decoded whole instead
            return None
        ws = self.window_samples
        n_windows = (n_frames + ws - 1) // ws
        n_samples_last = n_frames - (n_windows - 1) * ws

        def gen():
            try:
                for i in range(n_windows):
                    x = np.frombuffer(w.readframes(ws), dtype="<i2")
                    if n_channels > 1:
                        x = x.reshape(-1, n_channels).mean(
                            axis=1).astype(np.int16)
                    if len(x) < ws:
                        x = np.pad(x, (0, ws - len(x)))
                    yield (i * ws / sr, x)
            finally:
                w.close()

        return gen(), n_windows, n_samples_last, n_frames / sr

    def _windows(self, samples: np.ndarray) -> List[Tuple[float, np.ndarray]]:
        """Cut samples into fixed windows: [(offset_seconds, samples)]."""
        sr = self.config.frontend.sample_rate
        out = []
        for start in range(0, len(samples), self.window_samples):
            w = samples[start:start + self.window_samples]
            if len(w) < self.window_samples:
                w = np.pad(w, (0, self.window_samples - len(w)))
            out.append((start / sr, w))
        return out

    def _forward_batches(self, windows: Sequence[Tuple[float, np.ndarray]],
                         n_samples_last: int,
                         orthography: Optional[str] = None,
                         batch_progress=None,
                         n_windows: Optional[int] = None):
        """Generator over device batches: yields a list of per-window host
        dicts per completed batch.

        Every batch is enqueued (program and device-to-host copies) before
        the first is collected, so host work on batch k overlaps device
        work on later batches. A batch's windows split over the mesh's data
        shards, ``shard_batch`` each, each shard on its replica's device and
        stream (with a model axis, over the row's model shards from its
        first device); with the packed wire a shard's outputs come back in
        one copy. The enqueue runs under the engine's device lock; the
        collection (waiting on each shard's event) does not. ``windows``
        may be a lazy iterable; pass ``n_windows`` then.
        """
        cfg = self.config
        B, Bs = self.batch_size, self.shard_batch
        n_win = n_windows if n_windows is not None else len(windows)
        win_iter = iter(windows)

        def frames_for(i: int) -> int:
            n_s = n_samples_last if i == n_win - 1 else self.window_samples
            return min(cfg.frontend.frames_for_samples(n_s),
                       self.window_frames)

        pending = []
        with self._device_lock:
            mask = torch.from_numpy(ctc_logit_mask(orthography, cfg.vocab))
            masks = {r.device: mask.to(r.device) for r in self._replicas}
            for r in self._replicas:
                if r.stream is not None:   # starts after earlier default work
                    r.stream.wait_stream(torch.cuda.current_stream(r.device))
            for b0 in range(0, n_win, B):
                batch = [next(win_iter) for _ in range(min(B, n_win - b0))]
                rows = [w for _, w in batch]
                n_valid = [frames_for(b0 + k) for k in range(len(batch))]
                while len(rows) < B:   # pad the batch to its static size
                    rows.append(np.zeros_like(rows[0]))
                    n_valid.append(0)
                rows = np.stack(rows)
                if self.ingress == "mulaw":
                    if rows.dtype == np.int16:
                        rows = rows.astype(np.float32) * (1.0 / 32768.0)
                    rows = mulaw_encode(rows)
                elif rows.dtype != np.int16:
                    rows = np.clip(rows * 32768.0, -32768,
                                   32767).astype(np.int16)
                shards = []
                for i, r in enumerate(self._replicas):
                    sl = slice(i * Bs, (i + 1) * Bs)
                    on_cuda = r.device.type == "cuda"
                    ctx = (torch.cuda.stream(r.stream) if on_cuda
                           else contextlib.nullcontext())
                    with ctx:
                        host = torch.from_numpy(rows[sl])
                        nv = torch.tensor(n_valid[sl], dtype=torch.int32)
                        if on_cuda:
                            host = host.pin_memory()
                        out = self._dispatch_batch(
                            host.to(r.device, non_blocking=True),
                            nv.to(r.device, non_blocking=True),
                            masks[r.device], rep=r)
                        if self._out_layout is None:
                            out = {k: v.to("cpu", non_blocking=on_cuda)
                                   for k, v in out.items()}
                            self.d2h_copies += len(out)
                        else:
                            if layout_of(out) != self._out_layout:
                                raise ValueError(
                                    "the batch's outputs differ from the "
                                    "packed wire's layout")
                            out = pack_tree(out).to("cpu",
                                                    non_blocking=on_cuda)
                            self.d2h_copies += 1
                        done = None
                        if on_cuda:
                            done = torch.cuda.Event()
                            done.record(r.stream)
                    shards.append((out, done))
                pending.append((batch, shards))

        n_batches = len(pending)
        spk_src = "xvector" if self._xvector is not None else "trunk"
        for bi, (batch, shards) in enumerate(pending):
            parts = []
            for out, done in shards:
                if done is not None:
                    done.synchronize()
                parts.append(unpack_buffer(out.numpy(), self._out_layout)
                             if self._out_layout is not None
                             else {k: v.numpy() for k, v in out.items()})
            out = (parts[0] if len(parts) == 1 else
                   {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]})
            ctc = out["ctc_ids"]
            lid = out["lid_ids"]
            lconf = out["lid_conf"].astype(np.float32)
            emo = out["emotion_logits"].astype(np.float32)
            sub_mask = out["mask"]
            spk = self._unpack_speaker_frames(out, sub_mask.shape[1])
            energy = out["frame_energy"].astype(np.float32)
            enc = (out["encoder_states"].astype(np.float32)
                   if "encoder_states" in out else None)
            tk_lp = out.get("ctc_topk_logp")
            tk_id = out.get("ctc_topk_ids")
            outs = []
            for k in range(len(batch)):
                nf_sub = int(sub_mask[k].sum())
                outs.append({
                    "offset_s": batch[k][0],
                    "spk_embedder": spk_src,
                    "ctc_ids": ctc[k, :nf_sub],
                    "lid_ids": lid[k, :nf_sub],
                    "lid_conf": lconf[k, :nf_sub],
                    "emotion_logits": emo[k, :nf_sub],
                    "speaker_frames": spk[k, :nf_sub],
                    "frame_energy": energy[k, :nf_sub],
                    "encoder_states": (enc[k, :nf_sub]
                                       if enc is not None else None),
                    "ctc_topk": ((tk_lp[k, :nf_sub], tk_id[k, :nf_sub])
                                 if tk_lp is not None else None),
                })
            if batch_progress:
                batch_progress(bi + 1, n_batches)
            yield outs

    def _dispatch_batch(self, samples: torch.Tensor, n_valid: torch.Tensor,
                        ctc_mask: torch.Tensor, max_attempts: int = 2,
                        rep: Optional[_Replica] = None):
        """Enqueue one shard batch's device program; a runtime error
        re-dispatches it once on the same device and kernels before the
        last error surfaces. A kernel build failure is raised at once."""
        last = None
        for _ in range(max_attempts):
            try:
                return self._process(samples, n_valid, ctc_mask, rep)
            except KernelBuildError:
                raise
            except RuntimeError as e:
                last = e
        raise last

    def _unpack_speaker_frames(self, out: Dict[str, np.ndarray],
                               n_frames: int) -> np.ndarray:
        """f32 speaker frames [B, n_frames, D] from the wire: int8 times
        its per-frame scale under ``spk_wire="i8"``, and at a pooled stride
        repeated back to the frame rate (the tail frames lost to the floor
        division repeat the last pooled frame)."""
        if "speaker_frames_q" in out:
            spk = (out["speaker_frames_q"].astype(np.float32)
                   * out["speaker_scale"].astype(np.float32)[..., None])
        else:
            spk = out["speaker_frames"].astype(np.float32)
        stride = max(1, self.config.decode.spk_frame_stride)
        if stride > 1:
            spk = np.repeat(spk, stride, axis=1)
            short = n_frames - spk.shape[1]
            if short > 0:
                spk = np.concatenate(
                    [spk, np.repeat(spk[:, -1:], short, axis=1)], axis=1)
        return spk

    # ------------------------------------------------------------------
    # Per-segment speaker re-embedding (speaker_mode="crop")
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _crop_process(self, samples_i16: torch.Tensor,
                      n_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, crop_samples] int16 -> f16 speaker frames and their mask.

        The log-mel runs on K1; then the x-vector embedder when one is
        loaded, else the trunk with plain attention and conv module (the
        JAX engine turns its kernels off for the short crop)."""
        crop_frames = self.crop_frames
        fe = self._frontend
        samples = samples_i16.to(torch.float32) * (1.0 / 32768.0)
        frames, _ = fe.frames_from_signal(samples)
        mel = fe.log_mel(frames)[:, :crop_frames]
        mask = (torch.arange(crop_frames, device=mel.device)[None, :]
                < n_valid[:, None])
        if self._xvector is not None:
            fr = xvector_frames(self._xvector, mel, mask)
            m = subsampled_mask(mask, self.config.encoder.subsample_factor)
        elif self._crop_shards is not None:
            out = tp_asr_forward(self._crop_shards, mel, mask,
                                 self._crop_config)
            fr, m = out["speaker_frames"], out["mask"]
        else:
            out = asr_forward(self._plain_params, mel, mask, self._crop_config,
                              quant=self._quant_kernel)
            fr, m = out["speaker_frames"], out["mask"]
        return {"speaker_frames": fr.to(torch.float16), "mask": m}

    def _segment_crop_embeds(self, samples: np.ndarray,
                             decoded) -> np.ndarray:
        """Pooled speaker embedding per decoded segment, each from its own
        forward over the segment's (center-cropped) audio, in batches of
        SPK_CROP_BATCH crops under the device lock."""
        crop_samples, crop_frames = self.crop_samples, self.crop_frames
        fe = self.config.frontend
        sr = fe.sample_rate
        rows, nvalid = [], []
        n_total = len(samples)
        for s in decoded:
            a = max(0, min(int(s.start * sr), n_total))
            b = max(a, min(int(s.end * sr), n_total))
            if b - a > crop_samples:   # center crop of long segments
                mid = (a + b) // 2
                a = max(0, mid - crop_samples // 2)
                b = a + crop_samples
            row = np.zeros(crop_samples, np.float32)
            row[:b - a] = samples[a:b]
            rows.append(row)
            nvalid.append(min(fe.frames_for_samples(max(b - a, 1)),
                              crop_frames))
        embeds = []
        B = SPK_CROP_BATCH
        for b0 in range(0, len(rows), B):
            chunk = rows[b0:b0 + B]
            nv = nvalid[b0:b0 + B]
            n_live = len(chunk)
            while len(chunk) < B:
                chunk.append(np.zeros(crop_samples, np.float32))
                nv.append(0)
            wire = np.clip(np.stack(chunk) * 32768.0,
                           -32768, 32767).astype(np.int16)
            with self._device_lock:
                out = self._crop_process(
                    torch.from_numpy(wire).to(self.device),
                    torch.tensor(nv, dtype=torch.int32, device=self.device))
                spk = out["speaker_frames"].cpu().numpy().astype(np.float32)
                msk = out["mask"].cpu().numpy().astype(np.float32)
            for k in range(n_live):
                w = msk[k]
                if w.sum() < 1.0:
                    w = np.ones_like(w)
                embeds.append(pooled_speaker_embed_np(
                    self._spk_pool, spk[k], w))
        return np.stack(embeds)

    # ------------------------------------------------------------------
    # Sequence mode (long_mode="sequence")
    # ------------------------------------------------------------------

    #: Bytes of encoder states a device-to-host copy moves in sequence mode.
    STATE_SLICE_BYTES = 32 << 20
    #: Longest file whose encoder states sequence mode brings to the host.
    MAX_STATE_HOURS = 12.0

    @torch.inference_mode()
    def _sequence_mel(self, samples: np.ndarray) -> torch.Tensor:
        """The whole file's log-mel [n_frames, n_mels] on the primary
        device: pre-emphasis over the contiguous signal on the host, then
        hop-aligned chunks of ``window_samples`` with a ``win - hop``
        overlap (so the chunked framing is the contiguous framing) and one
        K1 call over all chunks' frames."""
        fe = self.config.frontend
        if self._seq_frontend is None:
            self._seq_frontend = MelFrontend(
                dataclasses.replace(fe, preemphasis=0.0), self.device)
        n = len(samples)
        x = np.asarray(samples, np.float32)
        x_pe = np.concatenate([x[:1], x[1:] - fe.preemphasis * x[:-1]])
        overlap = fe.win_length - fe.hop_length
        cs = self.window_samples
        chunks = []
        for start in range(0, n, cs):
            c = x_pe[start:start + cs + overlap]
            if len(c) < cs + overlap:
                c = np.pad(c, (0, cs + overlap - len(c)))
            chunks.append(c)
        frames, _ = self._seq_frontend.frames_from_signal(
            torch.from_numpy(np.stack(chunks)).to(self.device))
        mel = self._seq_frontend.log_mel(frames)
        chunk_frames = cs // fe.hop_length
        mel = mel[:, :chunk_frames].reshape(-1, fe.n_mels)
        return mel[:fe.frames_for_samples(n)]

    @torch.inference_mode()
    def _forward_sequence(self, samples: np.ndarray,
                          orthography: Optional[str] = None):
        """A whole file as one sequence split over the mesh's data axis
        (``parallel/sequence.py``): exact mel, then the encoder once, by
        ring attention and the conv halo exchange, in f32. Returns one
        window dict (offset 0) of the file's frames, as the JAX engine's
        ``_forward_sequence``: speaker frames are the trunk's (with an
        x-vector loaded, speakers then come from crop re-embedding), and
        encoder states, when a decoder reads them, come back in
        ``STATE_SLICE_BYTES`` slices up to ``MAX_STATE_HOURS``."""
        cfg = self.config
        fe = cfg.frontend
        n_frames = fe.frames_for_samples(len(samples))
        if n_frames <= 0:
            return []
        with self._device_lock:
            mel = self._sequence_mel(samples)
            n_dev = self.n_data
            sub = cfg.encoder.subsample_factor
            T = _round_up(max(n_frames, 1), n_dev * sub * 2)
            mel = torch.nn.functional.pad(mel, (0, 0, 0, T - mel.shape[0]))
            mask = torch.arange(T, device=self.device) < n_frames
            ctc_mask = torch.from_numpy(
                ctc_logit_mask(orthography, cfg.vocab)).to(self.device)
            want_states = self._states_consumer
            out = sp_conformer_forward(self._plain_params, mel, mask, cfg,
                                       self.mesh, axis="data",
                                       all_heads=True,
                                       with_states=want_states)
            n_real = 1 + cfg.vocab.n_bytes
            masked = out["ctc_logits"] + ctc_mask[None, :]
            e = torch.logsumexp(mel, dim=-1) * (10.0 / math.log(10.0))
            res = {
                "ctc_ids": torch.argmax(masked[:, :n_real], dim=-1),
                "lid_ids": torch.argmax(out["lid_logits"], dim=-1),
                "lid_conf": torch.softmax(out["lid_logits"],
                                          dim=-1).amax(dim=-1),
                "emotion_logits": out["emotion_logits"],
                "speaker_frames": out["speaker_frames"],
                "frame_energy": e.reshape(-1, sub).mean(dim=-1),
            }
            nf_sub = int(out["mask"].sum())
            host = {k: v[:nf_sub].cpu().numpy() for k, v in res.items()}
            enc_states = None
            if want_states:
                max_frames = int(self.MAX_STATE_HOURS * 3600.0
                                 / self.frame_dur_s)
                if nf_sub <= max_frames:
                    enc = out["encoder_states"]
                    step = max(1, self.STATE_SLICE_BYTES
                               // max(1, 2 * enc.shape[-1]))
                    enc_states = np.concatenate([
                        enc[i:min(i + step, nf_sub)].to(torch.float32)
                        .cpu().numpy() for i in range(0, nf_sub, step)])
                else:
                    warnings.warn(
                        f"sequence mode: file has {nf_sub} encoder frames "
                        f"(> {max_frames}); translation/neural summary are "
                        "skipped for this file — use window mode for "
                        "decoder heads on very long audio.", stacklevel=2)
        return [{
            "offset_s": 0.0,
            "spk_embedder": "trunk",
            "ctc_ids": host["ctc_ids"].astype(np.int32),
            "lid_ids": host["lid_ids"].astype(np.int32),
            "lid_conf": host["lid_conf"].astype(np.float32),
            "emotion_logits": host["emotion_logits"].astype(np.float32),
            "speaker_frames": host["speaker_frames"].astype(np.float32),
            "frame_energy": host["frame_energy"].astype(np.float32),
            "encoder_states": enc_states,
            "ctc_topk": None,
        }]

    # ------------------------------------------------------------------
    # Host-side assembly
    # ------------------------------------------------------------------

    def _extract_windows(self, window_outs, decoded=None, seg_meta=None,
                         states=None):
        """Per-window host extraction: segmentation, speaker pooling and,
        with ``decode.beam_size > 1``, each segment's text from the prefix
        beam search (times and words stay the greedy alignment's).

        Called on each completed batch while later batches still run.
        Returns (decoded, seg_meta, states), where ``states`` lists each
        window's encoder states when a decoder consumes them; pass them
        back in to accumulate."""
        cfg = self.config
        decoded = decoded if decoded is not None else []
        seg_meta = seg_meta if seg_meta is not None else []
        states = states if states is not None else []
        for w in window_outs:
            if w.get("encoder_states") is not None:
                states.append(w["encoder_states"])
            segs = segments_from_alignment(
                w["ctc_ids"], self.frame_dur_s, cfg.vocab, cfg.decode,
                time_offset_s=w["offset_s"])
            energy = w["frame_energy"]
            floor = np.percentile(energy, 10.0) if len(energy) else None
            for s in segs:
                f0, f1 = s.frame_start, s.frame_end
                emo_mean = w["emotion_logits"][f0:f1].mean(axis=0)
                spk_span = w["speaker_frames"][f0:f1]
                # Speech-weighted statistics pooling over the window's
                # noise floor.
                if floor is not None:
                    weights = (energy[f0:f1] > floor + 6.0).astype(np.float32)
                    if not weights.any():
                        weights = np.ones(len(spk_span), np.float32)
                else:
                    weights = np.ones(len(spk_span), np.float32)
                spk_mean = pooled_speaker_embed_np(
                    self._spk_pool, spk_span, weights)
                enc_span = (w["encoder_states"][f0:f1]
                            if w.get("encoder_states") is not None else None)
                if w.get("ctc_topk") is not None:
                    text = self._beam_text(w["ctc_topk"], f0, f1)
                    if text:
                        s.text = text
                decoded.append(s)
                seg_meta.append((emo_mean, spk_mean,
                                 (w["lid_ids"][f0:f1], w["lid_conf"][f0:f1]),
                                 enc_span))
        return decoded, seg_meta, states

    def _assemble_global(self, parts, *, language: Optional[str],
                         speaker_count: Optional[str], duration_s: float,
                         samples: Optional[np.ndarray] = None,
                         frames_from: Optional[str] = None):
        """Whole-file assembly over extracted window parts: speaker
        clustering, language and emotion aggregation, translation, summary.

        In crop mode, or in inline mode when the parts' speaker frames are
        not the active embedder's (``frames_from="trunk"``, sequence mode's,
        with an x-vector loaded), with ``samples`` (the file's audio) and
        more than one segment, every segment is re-embedded from its own
        audio (clustering cut ``CROP_AHC_THRESHOLD`` without an x-vector);
        otherwise the segments' pooled embeddings from the main forward are
        clustered.

        Returns (result, profile) where profile maps each sub-stage
        (``cluster``, ``segments``, ``translate``, ``summary``) to seconds.
        """
        cfg = self.config
        decoded, seg_meta, states = parts
        lang_hint_id = lang_table.id_for_language(language) if language else -1
        prof: Dict[str, float] = {}
        t0 = time.perf_counter()

        def mark(name: str) -> None:
            nonlocal t0
            now = time.perf_counter()
            prof[name] = prof.get(name, 0.0) + (now - t0)
            t0 = now

        if not decoded:
            return TranscriptionResult(summary=None, segments=[],
                                       detected_languages=None), prof

        n_clusters = None
        if speaker_count:
            try:
                n_clusters = max(1, int(str(speaker_count).strip()))
            except ValueError:
                n_clusters = None
        active = "xvector" if self._xvector is not None else "trunk"
        want_crop = (self.speaker_mode == "crop"
                     or (frames_from or active) != active)
        used_crop = want_crop and samples is not None and len(decoded) > 1
        if used_crop:
            embeds = self._segment_crop_embeds(samples, decoded)
        else:
            embeds = np.stack([m[1] for m in seg_meta])
        th = cfg.decode.ahc_threshold
        if th is None:
            if self._xvector is not None:
                th = XVECTOR_AHC_THRESHOLD
            elif used_crop:
                th = CROP_AHC_THRESHOLD
            else:
                th = CLUSTER_DEFAULT_THRESHOLD
        labels = cluster_speakers(embeds, n_clusters=n_clusters, threshold=th,
                                  count_mode=cfg.decode.count_mode,
                                  resegment=cfg.decode.resegment)
        mark("cluster")

        segments: List[TranscriptSegment] = []
        all_languages: List[dict] = []
        seen_codes = set()
        emotion_counts = np.zeros(len(EMOTIONS))
        for s, (emo_mean, _, (lid_frames, lid_conf), _), lab in zip(
                decoded, seg_meta, labels):
            langs = self._segment_languages(lid_frames, lid_conf,
                                            lang_hint_id)
            primary = langs[0] if langs else {"name": None, "code": None}
            for lg in langs:
                if lg["code"] and lg["code"] not in seen_codes:
                    seen_codes.add(lg["code"])
                    all_languages.append(
                        {"code": lg["code"], "language": lg["name"]})
            emo_idx = int(np.argmax(emo_mean[: len(EMOTIONS)]))
            # Overall tone: duration-weighted probability mass.
            logits = emo_mean[: len(EMOTIONS)].astype(np.float64)
            p = np.exp(logits - logits.max())
            p /= p.sum()
            emotion_counts += max(s.end - s.start, 1e-3) * p
            segments.append(TranscriptSegment(
                start=round(s.start, 3), end=round(s.end, 3),
                speaker=f"Speaker {int(lab) + 1}", text=s.text,
                language=primary["name"], language_code=primary["code"],
                languages=langs, emotion=EMOTIONS[emo_idx],
                translation=None, words=s.words))
        mark("segments")

        if self._translator is not None:
            with self._device_lock:
                self._translate_segments(segments, seg_meta)
        mark("translate")

        n_speakers = int(labels.max()) + 1 if len(labels) else 0
        top_emotion = EMOTIONS[int(np.argmax(emotion_counts))]
        language_names = [lg["language"] for lg in all_languages]
        summary = template_summary(
            duration_s=duration_s, n_speakers=n_speakers,
            n_segments=len(segments), language_names=language_names,
            top_emotion=top_emotion)
        if self._summarizer is not None and states:
            # The generated summary replaces the template only where it
            # agrees with the engine's own facts; a fact-conditioned
            # checkpoint reads them as a forced prefix.
            with self._device_lock:
                neural = self._summarizer.summarize(states, facts={
                    "n_speakers": n_speakers, "tone": top_emotion,
                    "language_names": language_names})
            if neural and summary_consistent(neural, n_speakers=n_speakers,
                                             tone=top_emotion):
                summary = neural
        mark("summary")
        return TranscriptionResult(
            summary=summary, segments=segments,
            detected_languages=all_languages if all_languages else None,
        ), prof

    def _decode_lm(self):
        """The lexicon trie LM of the beam search's shallow fusion, built
        on first use (``ops/lexicon.py``): ``decode.lexicon`` is "synth"
        (the training corpus's lexicons), "synth_bigram" (plus word bigrams
        of the English sentence bank) or a word-list file (whitespace
        separated, uniform unigram). None when fusion is off
        (``decode.lm_alpha == 0`` or no lexicon)."""
        dec = self.config.decode
        if dec.lm_alpha == 0.0 or not dec.lexicon:
            return None
        if self._lexicon_lm is None:
            if dec.lexicon == "synth":
                lm = synth_lexicon()
            elif dec.lexicon == "synth_bigram":
                lm = synth_lexicon(bigram=True)
            else:
                words = [w.strip() for w in Path(dec.lexicon).read_text(
                    encoding="utf-8").split()]
                lp = -math.log(max(len(words), 1))
                lm = TrieLM((w, lp) for w in words if w)
            self._lexicon_lm = lm
        return self._lexicon_lm

    def _beam_text(self, topk, f0: int, f1: int) -> Optional[str]:
        """One segment's text from the prefix beam search over its frames'
        top-K scores (``ops/beam.py``); None when no beam survives."""
        lp, ids = topk
        dec, vocab = self.config.decode, self.config.vocab
        T = f1 - f0
        dense = np.full((T, 1 + vocab.n_bytes), LOG_ZERO, np.float32)
        dense[np.arange(T)[:, None], ids[f0:f1]] = lp[f0:f1]
        beams = ctc_prefix_beam_search(
            dense, beam_size=dec.beam_size, blank_id=vocab.blank_id,
            topk=ids.shape[-1], lm=self._decode_lm(), lm_alpha=dec.lm_alpha,
            word_bonus=dec.lm_word_bonus)
        if not beams:
            return None
        byte_vals = [vocab.id_to_byte(c) for c in beams[0].prefix]
        return bytes(b for b in byte_vals if 0 <= b < 256).decode(
            "utf-8", errors="replace").strip()

    TRANSLATE_SPAN_FRAMES = 256   # ~10 s of encoder frames per segment
    TRANSLATE_MAX_BYTES = 128

    @property
    def _states_consumer(self) -> bool:
        """True when a decoder needs host copies of the encoder states: the
        neural summarizer, or an audio-conditioned translator (a text-mode
        one reads the transcript)."""
        return (self._summarizer is not None
                or (self._translator is not None
                    and not self._translator.is_text))

    def _translate_segments(self, segments: List[TranscriptSegment],
                            seg_meta) -> None:
        """Fill ``translation`` for non-English segments (None iff English).

        A text-mode translator reads each segment's transcript; an
        audio-conditioned one cross-attends the segment's encoder states,
        in batches of 8 spans of at most TRANSLATE_SPAN_FRAMES frames."""
        if self._translator.is_text:
            self._translate_segments_text(segments)
            return
        todo = [i for i, s in enumerate(segments)
                if s.language_code and s.language_code != "en"
                and seg_meta[i][3] is not None]
        if not todo:
            return
        Te, D = self.TRANSLATE_SPAN_FRAMES, self.config.encoder.d_model
        B = 8
        for b0 in range(0, len(todo), B):
            idxs = todo[b0:b0 + B]
            enc = np.zeros((B, Te, D), np.float32)
            mask = np.zeros((B, Te), bool)
            for row, i in enumerate(idxs):
                span = seg_meta[i][3][:Te]
                enc[row, :len(span)] = span
                mask[row, :len(span)] = True
            toks = self._translator.decode(
                torch.from_numpy(enc), torch.from_numpy(mask),
                max_len=self.TRANSLATE_MAX_BYTES).cpu().numpy()
            for row, i in enumerate(idxs):
                text = tokens_to_text(toks[row], self.config.vocab).strip()
                if text:
                    segments[i].translation = text

    def _translate_segments_text(
            self, segments: List[TranscriptSegment]) -> None:
        """Text-mode translation: segment transcript bytes -> English.

        Long transcripts are split on word boundaries into MAX_SOURCE_LEN
        byte spans, translated independently and joined. Spans are
        memoized by text and decoded in batches of 128 rows (the decode
        runs its TRANSLATE_MAX_BYTES steps whatever the batch width)."""
        todo = [i for i, s in enumerate(segments)
                if s.language_code and s.language_code != "en"
                and (s.text or "").strip()]
        if not todo:
            return

        def spans(text: str) -> List[str]:
            words, cur, out = text.split(), [], []
            n = 0
            for w in words:
                wb = len(w.encode("utf-8")) + 1
                if cur and n + wb > MAX_SOURCE_LEN:
                    out.append(" ".join(cur))
                    cur, n = [], 0
                cur.append(w)
                n += wb
            if cur:
                out.append(" ".join(cur))
            return out or [""]

        jobs = [(i, sp) for i in todo for sp in spans(segments[i].text)]
        memo: Dict[str, str] = {}
        unique = sorted({sp for _, sp in jobs})
        B = 128
        for b0 in range(0, len(unique), B):
            batch = unique[b0:b0 + B]
            ids = np.zeros((B, MAX_SOURCE_LEN), np.int32)
            mask = np.zeros((B, MAX_SOURCE_LEN), bool)
            for row, sp in enumerate(batch):
                ids[row], mask[row] = source_to_tokens(sp, self.config.vocab)
            toks = self._translator.translate_text(
                torch.from_numpy(ids), torch.from_numpy(mask),
                max_len=self.TRANSLATE_MAX_BYTES).cpu().numpy()
            for row, sp in enumerate(batch):
                memo[sp] = tokens_to_text(toks[row],
                                          self.config.vocab).strip()
        results: Dict[int, List[str]] = {}
        for i, sp in jobs:
            text = memo.get(sp, "")
            if text:
                results.setdefault(i, []).append(text)
        for i, parts in results.items():
            segments[i].translation = " ".join(parts)

    def _segment_languages(self, lid_frames: np.ndarray,
                           lid_conf: Optional[np.ndarray],
                           hint_id: int) -> List[dict]:
        """Primary-first language list for a segment (code-switch aware).

        Languages holding >= 20 % of the frame votes are reported, primary
        first, when their mean frame confidence clears
        ``decode.lid_conf_threshold``; a user hint moves its language first
        or stands in when nothing clears the gate."""
        thresh = self.config.decode.lid_conf_threshold
        ids, counts = np.unique(lid_frames, return_counts=True)
        order = np.argsort(-counts)
        total = counts.sum()
        langs = []
        for k in order:
            if counts[k] / total >= 0.2 or not langs:
                if lid_conf is not None and thresh > 0:
                    conf = float(lid_conf[lid_frames == ids[k]].mean())
                    if conf < thresh:
                        continue
                langs.append(lang_table.language_for_id(int(ids[k])))
        if hint_id >= 0:
            hint = lang_table.language_for_id(hint_id)
            codes = [lg["code"] for lg in langs]
            if hint["code"] in codes:
                langs.insert(0, langs.pop(codes.index(hint["code"])))
            elif not langs:
                langs = [hint]
        return langs

    # ------------------------------------------------------------------
    # Public API (reference-compatible)
    # ------------------------------------------------------------------

    def transcribe(
        self,
        audio_path,
        *,
        progress_callback: ProgressCallback = None,
        language: Optional[str] = None,
        speaker_count: Optional[str] = None,
        orthography: Optional[str] = None,
    ) -> TranscriptionResult:
        """Transcribe an audio file on the engine's device.

        Same signature, progress steps and result semantics as the JAX
        engine's ``transcribe``, in window and in sequence mode."""
        report, report_frac = _progress_reporters(progress_callback)
        trace = StageTrace(n_chips=self.mesh.size)
        audio_path = Path(audio_path)
        sr = self.config.frontend.sample_rate
        report("uploading", 0)        # step 0: host decode + resample

        # Long PCM WAV files stream their windows straight off the file so
        # the host decode rides under the device forward; not in sequence
        # mode or crop mode, which read the whole file's samples.
        samples = None
        stream = (self._stream_windows_wav(audio_path)
                  if self.speaker_mode != "crop"
                  and self.long_mode != "sequence" else None)
        if stream is not None:
            win_iter, n_win, n_last, duration_s = stream
        else:
            with trace.stage("decode"):
                samples = self._load_audio(audio_path)
            duration_s = len(samples) / sr
        trace.audio_seconds = duration_s

        report("transcribing", 1)     # step 1: device forward
        frames_from = None
        if self.long_mode == "sequence":
            with trace.stage("forward"):
                outs = self._forward_sequence(samples,
                                              orthography=orthography)
                report_frac("transcribing", 1, 1.0)
            report("processing", 2)
            with trace.stage("assemble"):
                parts = self._extract_windows(outs)
            frames_from = "trunk"
        else:
            if stream is None:
                windows = self._windows(samples)
                n_win = len(windows)
                n_last = (len(samples) - (n_win - 1) * self.window_samples
                          if windows else 0)
                win_iter = windows
            parts = None
            t_extract = 0.0
            with trace.stage("forward"):
                for outs_b in self._forward_batches(
                        win_iter, n_last, orthography=orthography,
                        n_windows=n_win,
                        batch_progress=lambda done, total: report_frac(
                            "transcribing", 1, done / total)):
                    t0 = time.perf_counter()
                    parts = self._extract_windows(outs_b, *(parts or ()))
                    t_extract += time.perf_counter() - t0
            trace.stages["forward"] = max(
                0.0, trace.stages.get("forward", 0.0) - t_extract)
            trace.stages["extract"] = t_extract
            report("processing", 2)   # step 2: whole-file assembly
        with trace.stage("assemble"):
            result, prof = self._assemble_global(
                parts or ([], [], []), language=language,
                speaker_count=speaker_count, duration_s=duration_s,
                samples=samples, frames_from=frames_from)
        trace.stages.update(
            {f"assemble.{k}": round(v, 2) for k, v in prof.items()})
        self.last_trace = trace
        trace.log(file=audio_path.name)
        report("done", 3)
        return result

    def transcribe_streaming(
        self,
        audio_path,
        *,
        language: Optional[str] = None,
        speaker_count: Optional[str] = None,
        orthography: Optional[str] = None,
    ):
        """Generator of results as device batches complete.

        Yields ("partial", list[TranscriptSegment]) after each batch, with
        provisional speakers from online centroid tracking and greedy
        texts, then ("final", TranscriptionResult): the result
        ``transcribe`` returns for the file. The device work runs through
        ``_forward_batches`` under the engine's device lock, as
        ``transcribe``'s does."""
        cfg = self.config
        samples = self._load_audio(Path(audio_path))
        duration_s = len(samples) / cfg.frontend.sample_rate
        windows = self._windows(samples)
        if not windows:
            yield ("final", TranscriptionResult(summary=None, segments=[],
                                                detected_languages=None))
            return
        n_last = len(samples) - (len(windows) - 1) * self.window_samples
        threshold = (XVECTOR_AHC_THRESHOLD if self._xvector is not None
                     else CLUSTER_DEFAULT_THRESHOLD)
        all_outs = []
        centroids: List[np.ndarray] = []   # online speaker centroids
        counts: List[int] = []
        for outs in self._forward_batches(windows, n_last, orthography):
            partial: List[TranscriptSegment] = []
            for w in outs:
                all_outs.append(w)
                segs = segments_from_alignment(
                    w["ctc_ids"], self.frame_dur_s, cfg.vocab, cfg.decode,
                    time_offset_s=w["offset_s"])
                for s in segs:
                    f0, f1 = s.frame_start, s.frame_end
                    emb = pooled_speaker_embed_np(
                        self._spk_pool, w["speaker_frames"][f0:f1],
                        np.ones(f1 - f0, np.float32))
                    lab = self._online_speaker(emb, centroids, counts,
                                               threshold=threshold)
                    langs = self._segment_languages(
                        w["lid_ids"][f0:f1], w["lid_conf"][f0:f1], -1)
                    primary = (langs[0] if langs
                               else {"name": None, "code": None})
                    emo_idx = int(np.argmax(w["emotion_logits"][f0:f1].mean(
                        axis=0)[:len(EMOTIONS)]))
                    partial.append(TranscriptSegment(
                        start=round(s.start, 3), end=round(s.end, 3),
                        speaker=f"Speaker {lab + 1}", text=s.text,
                        language=primary["name"],
                        language_code=primary["code"], languages=langs,
                        emotion=EMOTIONS[emo_idx], translation=None,
                        words=s.words))
            yield ("partial", partial)
        result, _ = self._assemble_global(
            self._extract_windows(all_outs), language=language,
            speaker_count=speaker_count, duration_s=duration_s,
            samples=samples)
        yield ("final", result)

    @staticmethod
    def _online_speaker(emb: np.ndarray, centroids: List[np.ndarray],
                        counts: List[int], threshold: float = 0.45) -> int:
        """Assign an embedding to the nearest running centroid (cosine),
        spawning a new speaker past the distance threshold."""
        e = emb / (np.linalg.norm(emb) + 1e-9)
        best, best_d = -1, 1e9
        for i, c in enumerate(centroids):
            d = 1.0 - float(e @ (c / (np.linalg.norm(c) + 1e-9)))
            if d < best_d:
                best, best_d = i, d
        if best >= 0 and best_d < threshold:
            centroids[best] = ((centroids[best] * counts[best] + e)
                               / (counts[best] + 1))
            counts[best] += 1
            return best
        centroids.append(e)
        counts.append(1)
        return len(centroids) - 1

    def health_check(self) -> dict:
        """Run a trivial program on each distinct device of the mesh;
        returns {"devices": [{"id", "ok"}], "ok"} (with "error" when a
        probe raised)."""
        report = {"devices": [], "ok": True}
        for d in self.mesh.distinct_devices():
            try:
                x = torch.ones((8, 8), device=d)
                ok = abs(float((x * 2.0).sum()) - 128.0) < 1e-3
            except Exception as e:  # noqa: BLE001 — a probe reports
                ok = False
                report["error"] = str(e)
            report["devices"].append({"id": str(d), "ok": ok})
            report["ok"] &= ok
        return report

    def transcribe_chunked(
        self,
        audio_path,
        *,
        progress_callback: ProgressCallback = None,
        language: Optional[str] = None,
        speaker_count: Optional[str] = None,
        orthography: Optional[str] = None,
    ) -> TranscriptionResult:
        """Long-audio entry point; windows already batch on the card and
        speaker clustering is global, so this shares ``transcribe``."""
        return self.transcribe(
            audio_path, progress_callback=progress_callback,
            language=language, speaker_count=speaker_count,
            orthography=orthography)

    def transcribe_with_retry(
        self,
        audio_path,
        *,
        max_retries: int = 3,
        progress_callback: ProgressCallback = None,
        language: Optional[str] = None,
        speaker_count: Optional[str] = None,
        orthography: Optional[str] = None,
    ) -> TranscriptionResult:
        """Retry wrapper: ``max_retries`` attempts with 2**attempt s backoff,
        chunked dispatch for files longer than the chunking threshold."""
        audio_path = Path(audio_path)
        duration = get_audio_duration(audio_path)
        use_chunking = (duration
                        > self.config.chunking.min_duration_for_chunking_s)
        last_error: Optional[Exception] = None
        for attempt in range(max_retries):
            try:
                fn = (self.transcribe_chunked if use_chunking
                      else self.transcribe)
                return fn(audio_path, progress_callback=progress_callback,
                          language=language, speaker_count=speaker_count,
                          orthography=orthography)
            except Exception as e:  # noqa: BLE001 — parity with reference
                last_error = e
                if attempt < max_retries - 1:
                    time.sleep(2 ** attempt)
        raise RuntimeError(
            f"Failed to transcribe after {max_retries} attempts: {last_error}")
