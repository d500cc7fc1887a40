"""Fused log-mel frontend: kernel K1 and its plain PyTorch version.

Port of ``omnilingual_asr_tpu/ops/mel_pallas.py``: ``build_mel_constants``,
``MelFrontend`` and the log-mel over pre-cut frames,

    log(max(((F Cw)^2 + (F Sw)^2) FB, floor))

with the Hann window folded into the DFT matrices and the 513 bins padded
with zeros to 576. ``log_mel_frames`` launches the CUDA kernel
(``csrc/mel.cu``) for CUDA tensors and runs ``log_mel_frames_plain`` for
CPU tensors. Both are f32 throughout: the reference computes at
``Precision.HIGHEST``, so TF32 must stay off for the plain version on a card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..audio.frontend import (dft_matrices, hann_window, mel_filterbank,
                              preemphasis)
from ..config import FrontendConfig
from . import cuda_build

#: Frames are padded to a multiple of this, as the reference pads them for
#: its 256-frame kernel blocks; the engine's window length derives from it.
BLOCK_T = 256
#: Frequency bins are zero-padded to a multiple of this (513 -> 576): the
#: CUDA kernel walks the bins in chunks of 64 (``BN`` in ``csrc/mel.cu``).
BIN_CHUNK = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_mel_constants(cfg: FrontendConfig):
    """Windowed DFT and mel matrices, bin axis zero-padded to BIN_CHUNK.

    Returns numpy (cw, sw, fb): cw, sw [n_fft, n_bins_pad], fb
    [n_bins_pad, n_mels], all float32.
    """
    cos_m, sin_m = dft_matrices(cfg)
    win = np.zeros(cfg.n_fft, dtype=np.float32)
    win[: cfg.win_length] = hann_window(cfg.win_length)
    cw = win[:, None] * cos_m
    sw = win[:, None] * sin_m
    pad = _round_up(cfg.n_freqs, BIN_CHUNK) - cfg.n_freqs
    cw = np.pad(cw, ((0, 0), (0, pad)))
    sw = np.pad(sw, ((0, 0), (0, pad)))
    fb = np.pad(mel_filterbank(cfg), ((0, pad), (0, 0)))
    return cw, sw, fb


def log_mel_frames_plain(frames: torch.Tensor, cw: torch.Tensor,
                         sw: torch.Tensor, fb: torch.Tensor,
                         log_floor: float) -> torch.Tensor:
    """Plain PyTorch log-mel over frames [N, n_fft] f32 -> [N, n_mels]."""
    re = frames @ cw
    im = frames @ sw
    power = re * re + im * im
    mel = power @ fb
    return torch.log(torch.clamp(mel, min=log_floor))


def log_mel_frames(frames: torch.Tensor, cw: torch.Tensor, sw: torch.Tensor,
                   fb: torch.Tensor, log_floor: float) -> torch.Tensor:
    """Log-mel over frames [N, n_fft] f32 -> [N, n_mels] f32.

    A CUDA tensor goes to kernel K1; a CPU tensor to the plain version.
    """
    if not frames.is_cuda:
        return log_mel_frames_plain(frames, cw, sw, fb, log_floor)
    n, n_fft = frames.shape
    n_bins = cw.shape[1]
    n_mels = fb.shape[1]
    dev = frames.device
    f32 = torch.float32
    cuda_build.check_tensor(frames, "frames", f32, device=dev)
    cuda_build.check_tensor(cw, "cw", f32, (n_fft, n_bins), dev)
    cuda_build.check_tensor(sw, "sw", f32, (n_fft, n_bins), dev)
    cuda_build.check_tensor(fb, "fb", f32, (n_bins, n_mels), dev)
    if n_mels != 128 or n_fft % 16 or n_bins % 64 or n == 0:
        raise ValueError(
            f"log-mel kernel takes n_mels 128, n_fft % 16 == 0, bins % 64 "
            f"== 0 and at least one frame; got {n_mels}, {n_fft}, {n_bins}, "
            f"{n}")
    out = torch.empty((n, n_mels), dtype=f32, device=dev)
    lib = cuda_build.library()
    err = lib.omni_log_mel(frames.data_ptr(), cw.data_ptr(), sw.data_ptr(),
                           fb.data_ptr(), out.data_ptr(), n, n_fft, n_bins,
                           n_mels, float(log_floor),
                           cuda_build.stream_ptr(dev))
    cuda_build.check(err, "log-mel kernel")
    log_mel_frames.launches += 1
    return out


log_mel_frames.launches = 0


class MelFrontend:
    """Holds the mel constants on a device and cuts frames from samples.

    Frames are cut at length n_fft (not win_length); the zero tail of the
    folded window kills the extra samples, so the result equals
    window-then-zero-pad.
    """

    def __init__(self, cfg: FrontendConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        cw, sw, fb = build_mel_constants(cfg)
        self.cw = torch.from_numpy(cw).to(self.device)
        self.sw = torch.from_numpy(sw).to(self.device)
        self.fb = torch.from_numpy(fb).to(self.device)

    def frames_from_signal(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Pre-emphasis + strided framing at n_fft length.

        x: [..., n] samples. Returns (frames [..., T_pad, n_fft], n_frames)
        with T_pad a multiple of BLOCK_T and the padded rows zero.
        """
        cfg = self.cfg
        x = preemphasis(x.to(torch.float32), cfg.preemphasis)
        lead = x.shape[:-1]
        n_frames = cfg.frames_for_samples(x.shape[-1])
        if n_frames <= 0:
            return x.new_zeros((*lead, BLOCK_T, cfg.n_fft)), 0
        need = (n_frames - 1) * cfg.hop_length + cfg.n_fft
        if need > x.shape[-1]:
            x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
        view = x.unfold(-1, cfg.n_fft, cfg.hop_length)[..., :n_frames, :]
        frames = x.new_zeros((*lead, _round_up(n_frames, BLOCK_T), cfg.n_fft))
        frames[..., :n_frames, :] = view
        return frames, n_frames

    def log_mel(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames [..., n_fft] -> log-mel [..., n_mels]."""
        lead = frames.shape[:-1]
        flat = frames.reshape(-1, self.cfg.n_fft)
        mel = log_mel_frames(flat, self.cw, self.sw, self.fb,
                             self.cfg.log_floor)
        return mel.reshape(*lead, self.cfg.n_mels)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Raw samples [n] -> log-mel [n_frames, n_mels]."""
        frames, n_frames = self.frames_from_signal(x)
        return self.log_mel(frames)[:n_frames]
