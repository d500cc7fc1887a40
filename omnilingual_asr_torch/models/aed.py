"""AED (attention encoder-decoder) ASR: the second model family.

The PyTorch port of ``omnilingual_asr_tpu/models/aed.py``. Where the CTC
family (``conformer.py``) emits frame-synchronous byte posteriors — ideal
for streaming, timestamps, and the segmentation contract — the AED family
decodes bytes autoregressively with cross-attention into the same
conformer encoder (the architecture class of Whisper/LAS). It reuses the
byte decoder from ``translation.py``, so the whole family is a
composition:

    log-mel -> conformer encoder -> transformer byte decoder -> text

Use cases: offline highest-accuracy transcription, and joint CTC/AED
training (CTC loss on the encoder + CE on the decoder), the standard recipe
for fast convergence.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import PipelineConfig
from ..ops.ctc import ctc_loss
from .conformer import asr_forward, asr_init
from .translation import decoder_forward, greedy_translate, translator_init


def aed_init(gen: torch.Generator, cfg: PipelineConfig,
             decoder_layers: int = 4):
    return {
        "encoder": asr_init(gen, cfg),
        "decoder": translator_init(gen, cfg, n_layers=decoder_layers),
    }


def aed_forward(params, mel: torch.Tensor, mask: torch.Tensor,
                tokens: torch.Tensor,
                cfg: PipelineConfig) -> Dict[str, torch.Tensor]:
    """Teacher-forced forward for joint CTC/AED training.

    tokens: [B, Tt] decoder inputs (BOS-shifted byte ids).
    Returns {"ctc_logits", "dec_logits", "mask"}.
    """
    enc_out = asr_forward(params["encoder"], mel, mask, cfg)
    dec_logits = decoder_forward(params["decoder"], tokens,
                                 enc_out["encoder_states"], enc_out["mask"],
                                 cfg, n_heads=cfg.encoder.n_heads)
    return {
        "ctc_logits": enc_out["ctc_logits"],
        "dec_logits": dec_logits,
        "mask": enc_out["mask"],
    }


def aed_loss(params, batch: Dict[str, torch.Tensor], cfg: PipelineConfig,
             ctc_weight: float = 0.3):
    """Joint loss: ctc_weight * CTC + (1-ctc_weight) * label CE.

    batch: mel/mask plus labels [B, L] (byte ids, 0-padded) and
    label_mask [B, L]. Decoder input is the BOS(0)-shifted labels;
    target is labels with EOS(0) at the first pad slot.
    """
    labels = batch["labels"]
    lmask = batch["label_mask"]
    B = labels.shape[0]
    bos = torch.zeros((B, 1), dtype=labels.dtype, device=labels.device)
    dec_in = torch.cat([bos, labels[:, :-1]], dim=1)

    out = aed_forward(params, batch["mel"], batch["mask"], dec_in, cfg)

    l_ctc = ctc_loss(out["ctc_logits"], out["mask"], labels, lmask,
                     blank_id=cfg.vocab.blank_id)

    # CE target: the label at each position; the first padding position
    # learns EOS(0), later padding is ignored.
    first = torch.ones((B, 1), dtype=torch.bool, device=lmask.device)
    eos_pos = (~lmask) & torch.cat([first, lmask[:, :-1]], dim=1)
    target = torch.where(lmask, labels, torch.zeros_like(labels))
    weight = (lmask | eos_pos).to(torch.float32)
    logp = torch.log_softmax(out["dec_logits"].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, target.to(torch.long)[..., None])[..., 0]
    l_ce = (nll * weight).sum() / torch.clamp(weight.sum(), min=1.0)

    total = ctc_weight * l_ctc + (1.0 - ctc_weight) * l_ce
    return total, {"loss": total, "ctc": l_ctc, "ce": l_ce}


@torch.no_grad()
def aed_greedy_decode(params, mel: torch.Tensor, mask: torch.Tensor,
                      cfg: PipelineConfig, max_len: int = 256) -> torch.Tensor:
    """Autoregressive greedy decode: [B, max_len] byte ids (0 = EOS)."""
    enc_out = asr_forward(params["encoder"], mel, mask, cfg)
    return greedy_translate(params["decoder"], enc_out["encoder_states"],
                            enc_out["mask"], cfg, max_len=max_len,
                            n_heads=cfg.encoder.n_heads)
