"""TranscriptionEngine on PyTorch: window-mode serving on one CUDA card.

The PyTorch port of ``omnilingual_asr_tpu/engine.py`` in window mode, with
the same surface and semantics: ``transcribe``, ``transcribe_chunked`` and
``transcribe_with_retry``, the 4-step progress contract, the result types and
the StageTrace stage names (``decode``, ``forward``, ``extract``,
``assemble`` and ``assemble.<sub-stage>``).

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
  extraction of batch k overlaps the device work of later batches;
- CTC collapse, segmentation, pooling and whole-file speaker clustering run
  on the host, exactly as in the JAX engine;
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
buffers and are captured on first use), runs under one lock; host decoding,
host extraction and clustering run outside it, so concurrent requests
overlap their host work with each other's device work.
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

from .audio.decode import decode_audio, get_audio_duration
from .audio.native_lib import native_available, native_decode
from .audio.resample import resample
from .config import PipelineConfig
from .diarization.cluster import DEFAULT_THRESHOLD as CLUSTER_DEFAULT_THRESHOLD
from .diarization.cluster import cluster_speakers
from .models import languages as lang_table
from .models.conformer import (asr_forward, asr_init,
                               pooled_speaker_embed_np)
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
from .ops.conv_module import dense_weight
from .ops.ctc import segments_from_alignment
from .ops.mel import BLOCK_T, MelFrontend
from .ops.quant import add_kernel_layouts, quantize_param_tree
from .types import EMOTIONS, TranscriptSegment, TranscriptionResult
from .utils.tracing import StageTrace

ProgressCallback = Optional[Callable[[str, int], None]]

# Fixed inference window: 30 s at 16 kHz -> 2998 mel frames -> 3072 padded.
WINDOW_SECONDS = 30.0

# AHC merge cut for x-vector embeddings (DecodeConfig.ahc_threshold
# overrides).
XVECTOR_AHC_THRESHOLD = 0.30


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the engine runs on CUDA unless "
                "it is constructed with device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    try:
        dev = torch.device(device)
    except RuntimeError as e:
        raise ValueError(f"device must be 'cuda[:N]' or 'cpu', got "
                         f"{device!r}") from e
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               f"device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda[:N]' or 'cpu', got {device!r}")
    return dev


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch engine yet ({item} in "
        f"ROADMAP.md, Queue A)")


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
    """Local GPU ASR engine with the JAX engine's surface (window mode).

    ``api_key`` and ``model`` are accepted for drop-in compatibility and
    ignored. On CUDA the constructor sets ``torch.backends.cuda.matmul.
    allow_tf32`` and ``torch.backends.cudnn.allow_tf32`` to False for the
    process: the reference accumulates every product in f32.

    ``quantize`` selects int8 serving as in the JAX engine: ``True`` holds
    every dense weight as int8 with per-channel scales and dequantizes it
    into the bf16 matmuls; ``"w8"`` and ``"a8"`` also route the layers that
    the kernels take (in_dim % 128 == 0, out_dim % 512 == 0) through the
    W8A16 kernel K4 or the W8A8 kernel K5 (``ops/quant.py``). The JAX
    engine refuses the kernel modes under tensor parallelism; the port runs
    on one card, so that check has no counterpart here.
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
        if long_mode == "sequence":
            raise _not_ported("long_mode='sequence'", "A10")
        if ingress == "mulaw":
            raise _not_ported("ingress='mulaw'", "A9")

        self.config = config or PipelineConfig.from_env()
        cfg = self.config
        if cfg.decode.beam_size > 1:
            raise _not_ported("beam_size > 1 (prefix beam search)", "A13")
        if cfg.decode.spk_frame_stride != 1 or cfg.decode.spk_wire != "f16":
            raise _not_ported("speaker-frame wire slimming (decode."
                              "spk_frame_stride / spk_wire)",
                              "A9, the packed D2H wire")
        self.model = model
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
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
        if speaker_mode == "crop":
            raise _not_ported("speaker_mode='crop' (per-segment speaker "
                              "re-embedding; the default without x-vector "
                              "weights)", "A9")
        self.speaker_mode = speaker_mode

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
        if quantize:
            # Int8 serving: every dense weight is held as int8 plus a
            # per-channel scale. quantize=True dequantizes it into the bf16
            # matmuls; "a8"/"w8" route the layers the kernels take through
            # K5/K4, which read a K-contiguous copy kept from here on. The
            # x-vector embedder stays unquantized (it is held apart).
            params = quantize_param_tree(params)
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
        self.batch_size = batch_windows_per_device
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
        if use_fused_conv:
            # The fused conv module rounds its pointwise weights to bf16;
            # hold them so once, rather than cast them on every call. A
            # quantized weight is dequantized in f32 first, as the
            # reference feeds its kernel.
            for blk in self.params["blocks"]:
                for name in ("pw1", "pw2"):
                    blk["conv"][name] = {"w": dense_weight(
                        blk["conv"][name]).to(torch.bfloat16)}
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            torch.cuda.synchronize(self.device)   # weights are on the card

    # ------------------------------------------------------------------
    # The per-batch device program
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _process(self, samples_i16: torch.Tensor, n_valid: torch.Tensor,
                 ctc_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw int16 samples [B, window_samples] -> compact head outputs.

        n_valid: [B] int32 valid mel frames per window (0 for a padded
        slot). Outputs carry the JAX engine's wire dtypes (i16 ids, f16
        features); host clustering runs on the f16-rounded speaker frames.
        """
        cfg = self.config
        icfg = self.infer_config
        fe = self._frontend
        B = samples_i16.shape[0]
        samples = samples_i16.to(torch.float32) * (1.0 / 32768.0)
        frames, _ = fe.frames_from_signal(samples)      # [B, T_pad, n_fft]
        mel = fe.log_mel(frames)[:, :self.window_frames]
        frame_idx = torch.arange(self.window_frames, device=mel.device)
        mask = frame_idx[None, :] < n_valid[:, None]
        out = asr_forward(self.params, mel, mask, icfg,
                          quant=self._quant_kernel)
        # Per-subsampled-frame energy (dB proxy) for host-side pooling.
        e = torch.logsumexp(mel, dim=-1) * (10.0 / math.log(10.0))
        sub = icfg.encoder.subsample_factor
        e_sub = e.reshape(B, -1, sub).mean(dim=-1)
        n_real = 1 + cfg.vocab.n_bytes
        masked = out["ctc_logits"] + ctc_mask[None, None, :]
        ctc_ids = torch.argmax(masked[..., :n_real], dim=-1)
        lid_ids = torch.argmax(out["lid_logits"], dim=-1)
        lid_conf = torch.softmax(out["lid_logits"], dim=-1).amax(dim=-1)
        spk_frames = out["speaker_frames"]
        if self._xvector is not None:
            spk_frames = xvector_frames(self._xvector, mel, mask)
        ret = {
            "ctc_ids": ctc_ids.to(torch.int16),
            "lid_ids": lid_ids.to(torch.int16),
            "lid_conf": lid_conf.to(torch.float16),
            "emotion_logits": out["emotion_logits"].to(torch.float16),
            "speaker_frames": spk_frames.to(torch.float16),
            "frame_energy": e_sub.to(torch.float16),
            "mask": out["mask"],
        }
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

        Every batch is enqueued on the engine's CUDA stream (program and
        device-to-host copies) before the first is collected, so host work on
        batch k overlaps device work on later batches. The enqueue runs under
        the engine's device lock; the collection (waiting on each batch's
        event) does not. ``windows`` may be a lazy iterable; pass
        ``n_windows`` then.
        """
        cfg = self.config
        B = self.batch_size
        dev = self.device
        n_win = n_windows if n_windows is not None else len(windows)
        win_iter = iter(windows)

        def frames_for(i: int) -> int:
            n_s = n_samples_last if i == n_win - 1 else self.window_samples
            return min(cfg.frontend.frames_for_samples(n_s),
                       self.window_frames)

        on_cuda = dev.type == "cuda"
        ctx = (torch.cuda.stream(self._stream) if on_cuda
               else contextlib.nullcontext())
        pending = []
        with self._device_lock:
            if on_cuda:   # the stream starts after earlier default work
                self._stream.wait_stream(torch.cuda.current_stream(dev))
            with ctx:
                ctc_mask = torch.from_numpy(
                    ctc_logit_mask(orthography, cfg.vocab)).to(dev)
                for b0 in range(0, n_win, B):
                    batch = [next(win_iter)
                             for _ in range(min(B, n_win - b0))]
                    rows = [w for _, w in batch]
                    n_valid = [frames_for(b0 + k) for k in range(len(batch))]
                    while len(rows) < B:   # pad the batch to its static size
                        rows.append(np.zeros_like(rows[0]))
                        n_valid.append(0)
                    rows = np.stack(rows)
                    if rows.dtype != np.int16:
                        rows = np.clip(rows * 32768.0, -32768,
                                       32767).astype(np.int16)
                    host = torch.from_numpy(rows)
                    nv = torch.tensor(n_valid, dtype=torch.int32)
                    if on_cuda:
                        host = host.pin_memory()
                    out = self._process(host.to(dev, non_blocking=True),
                                        nv.to(dev, non_blocking=True),
                                        ctc_mask)
                    out = {k: v.to("cpu", non_blocking=on_cuda)
                           for k, v in out.items()}
                    done = None
                    if on_cuda:
                        done = torch.cuda.Event()
                        done.record(self._stream)
                    pending.append((batch, out, done))

        n_batches = len(pending)
        spk_src = "xvector" if self._xvector is not None else "trunk"
        for bi, (batch, out, done) in enumerate(pending):
            if done is not None:
                done.synchronize()
            out = {k: v.numpy() for k, v in out.items()}
            ctc = out["ctc_ids"]
            lid = out["lid_ids"]
            lconf = out["lid_conf"].astype(np.float32)
            emo = out["emotion_logits"].astype(np.float32)
            spk = out["speaker_frames"].astype(np.float32)
            sub_mask = out["mask"]
            energy = out["frame_energy"].astype(np.float32)
            enc = (out["encoder_states"].astype(np.float32)
                   if "encoder_states" in out else None)
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
                })
            if batch_progress:
                batch_progress(bi + 1, n_batches)
            yield outs

    # ------------------------------------------------------------------
    # Host-side assembly
    # ------------------------------------------------------------------

    def _extract_windows(self, window_outs, decoded=None, seg_meta=None,
                         states=None):
        """Per-window host extraction: segmentation and speaker pooling.

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
                decoded.append(s)
                seg_meta.append((emo_mean, spk_mean,
                                 (w["lid_ids"][f0:f1], w["lid_conf"][f0:f1]),
                                 enc_span))
        return decoded, seg_meta, states

    def _assemble_global(self, parts, *, language: Optional[str],
                         speaker_count: Optional[str], duration_s: float):
        """Whole-file assembly over extracted window parts: speaker
        clustering, language and emotion aggregation, translation, summary.

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
        embeds = np.stack([m[1] for m in seg_meta])
        th = cfg.decode.ahc_threshold
        if th is None:
            th = (XVECTOR_AHC_THRESHOLD if self._xvector is not None
                  else CLUSTER_DEFAULT_THRESHOLD)
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
        engine's ``transcribe`` in window mode."""
        report, report_frac = _progress_reporters(progress_callback)
        trace = StageTrace(n_chips=1)
        audio_path = Path(audio_path)
        sr = self.config.frontend.sample_rate
        report("uploading", 0)        # step 0: host decode + resample

        # Long PCM WAV files stream their windows straight off the file so
        # the host decode rides under the device forward.
        stream = self._stream_windows_wav(audio_path)
        if stream is not None:
            win_iter, n_win, n_last, duration_s = stream
        else:
            with trace.stage("decode"):
                samples = self._load_audio(audio_path)
            duration_s = len(samples) / sr
            windows = self._windows(samples)
            n_win = len(windows)
            n_last = (len(samples) - (n_win - 1) * self.window_samples
                      if windows else 0)
            win_iter = windows
        trace.audio_seconds = duration_s

        report("transcribing", 1)     # step 1: device forward
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
        report("processing", 2)       # step 2: whole-file assembly
        with trace.stage("assemble"):
            result, prof = self._assemble_global(
                parts or ([], [], []), language=language,
                speaker_count=speaker_count, duration_s=duration_s)
        trace.stages.update(
            {f"assemble.{k}": round(v, 2) for k, v in prof.items()})
        self.last_trace = trace
        trace.log(file=audio_path.name)
        report("done", 3)
        return result

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
