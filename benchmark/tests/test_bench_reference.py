"""The plain reference against the port's plain path on the CPU at tiny
dims, and a lower-precision run of the port failing the comparison.

Tolerances (relative RMS of the difference): ``F32`` where both sides
compute in f32 and differ only in the order of their sums; ``BF16`` where
the port rounds every product's operands to bf16 (2^-9 relative a
rounding, a few dozen roundings deep) and the reference does not.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import model as M
from benchmark.reference import weights as W
from omnilingual_asr_torch.config import (EncoderConfig, FrontendConfig,
                                          PipelineConfig)

F32 = 1e-4
BF16 = 3e-2


def rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).sum().sqrt() / (b ** 2).sum().sqrt())


def tiny(dtype="float32"):
    return PipelineConfig(encoder=EncoderConfig(
        d_model=64, n_layers=2, n_heads=2, conv_kernel=8, dtype=dtype),
        frontend=FrontendConfig())


def ref_cfg(cfg):
    e = cfg.encoder
    return {"d_model": e.d_model, "n_layers": e.n_layers,
            "n_heads": e.n_heads, "ffn_mult": e.ffn_mult,
            "conv_kernel": e.conv_kernel,
            "subsample_factor": e.subsample_factor,
            "n_mels": cfg.frontend.n_mels, "vocab_size": cfg.vocab.vocab_size}


FE = dataclasses.asdict(FrontendConfig())


def inputs(seed=3, B=2, n=16_000):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, n, generator=g) * 0.1
    consts = M.mel_constants(FE, "cpu")
    T = 256
    mel = M.log_mel(x, FE, consts, T)
    mask = torch.arange(T)[None, :] < torch.tensor([98, 70])[:, None]
    return x, mel, mask


def test_log_mel_matches_the_port():
    from omnilingual_asr_torch.ops.mel import MelFrontend

    x, mel, _ = inputs()
    fe = MelFrontend(FrontendConfig(), "cpu")
    frames, n = fe.frames_from_signal(x)
    want = fe.log_mel(frames)
    assert want.shape == mel.shape
    assert float((want - mel).abs().max()) < 1e-3


@pytest.mark.parametrize("dtype, tol, passes", [
    ("float32", F32, True), ("bfloat16", BF16, True),
    ("bfloat16", F32, False)])
def test_conformer_matches_the_port(dtype, tol, passes):
    from omnilingual_asr_torch.models.conformer import asr_forward

    cfg = tiny(dtype)
    p = W.seeded_tree(W.conformer_spec(ref_cfg(cfg)), 5, "cpu")
    _, mel, mask = inputs()
    ref = M.conformer(p, mel, mask, ref_cfg(cfg))
    with torch.no_grad():
        got = asr_forward(p, mel, mask, cfg)
    m = ref["mask"]
    for a, b in (("ctc_logits", "ctc"), ("lid_logits", "lid"),
                 ("emotion_logits", "emotion"),
                 ("speaker_frames", "speaker")):
        assert (rel(got[a][m], ref[b][m]) < tol) == passes, a


def test_int8_port_fails_the_bf16_tolerance():
    """The port's int8 weights (every dense weight a per-channel int8)
    read further from the reference than the bf16 tolerance."""
    from omnilingual_asr_torch.models.conformer import asr_forward
    from omnilingual_asr_torch.ops.quant import quantize_param_tree

    cfg = tiny("bfloat16")
    p = W.seeded_tree(W.conformer_spec(ref_cfg(cfg)), 5, "cpu")
    _, mel, mask = inputs()
    ref = M.conformer(p, mel, mask, ref_cfg(cfg))
    with torch.no_grad():
        bf = asr_forward(p, mel, mask, cfg)
        q8 = asr_forward(quantize_param_tree(p), mel, mask, cfg)
    m = ref["mask"]
    assert rel(q8["ctc_logits"][m], ref["ctc"][m]) > 2 * rel(
        bf["ctc_logits"][m], ref["ctc"][m])


def test_xvector_matches_the_port():
    from omnilingual_asr_torch.models.xvector import (xvector_frames,
                                                      xvector_init)

    cfg = tiny()
    p = xvector_init(torch.Generator().manual_seed(2), cfg)
    _, mel, mask = inputs()
    ref = M.xvector(p, mel, mask)
    got32 = xvector_frames(p, mel, mask, dtype=torch.float32)
    got16 = xvector_frames(p, mel, mask)
    assert rel(got32, ref) < F32
    assert F32 < rel(got16, ref) < BF16


def test_decoders_match_the_port():
    from omnilingual_asr_torch.models.translation import (
        GreedyDecoder, decoder_forward, encode_source, text_translator_init)

    cfg = tiny()
    p = text_translator_init(torch.Generator().manual_seed(4), cfg)
    g = torch.Generator().manual_seed(1)
    src = torch.randint(1, 257, (3, 12), generator=g)
    msk = torch.arange(12)[None, :] < torch.tensor([12, 7, 3])[:, None]
    tok = torch.randint(1, 257, (3, 9), generator=g)
    mem = M.source_encoder(p, src, msk, 2)
    with torch.no_grad():
        mem_p = encode_source(p, src, msk, cfg, n_heads=2)
        got = decoder_forward(p, tok, mem_p, msk, cfg, n_heads=2)
    assert rel(mem_p[msk], mem[msk]) < BF16
    ref = M.decoder_logits(p, tok, mem, msk, 2)
    assert rel(got, ref) < BF16
    # Greedy tokens of the port, judged teacher-forced: small gaps.
    toks = GreedyDecoder(p, cfg, n_heads=2).translate_text(src, msk,
                                                           max_len=16)
    inp = torch.cat([torch.zeros_like(toks[:, :1]), toks[:, :-1]], 1)
    logits = M.decoder_logits(p, inp.long(), mem, msk, 2)[..., :257]
    gap = max(float(compare._gaps(logits[r], toks[r].long()).max())
              for r in range(3))
    assert gap < 0.05


def test_training_steps_match_the_port():
    """Loss, first clipped gradient and the change over three updates:
    the port at f32 (plain kernels on the CPU, its Optimizer) against
    ``compare.reference_steps`` (AdamW written out)."""
    from omnilingual_asr_torch.train.step import (Optimizer, loss_fn,
                                                  mel_from_samples,
                                                  tree_leaves)
    from omnilingual_asr_torch.ops.mel import MelFrontend

    cfg = tiny()
    c = {"frontend": FE, "encoder": dataclasses.asdict(cfg.encoder),
         "vocab": dataclasses.asdict(cfg.vocab),
         "optimizer": {"lr": 0.05, "weight_decay": 1e-2, "warmup_steps": 2,
                       "decay_steps": 10, "b1": 0.9, "b2": 0.999,
                       "eps": 1e-8, "max_norm": 1.0}}
    p0 = W.seeded_tree(W.conformer_spec(ref_cfg(cfg)), 6, "cpu")
    g = torch.Generator().manual_seed(9)
    batches = []
    for _ in range(3):
        B = 3
        batches.append({
            "samples": torch.randn(B, 16_000, generator=g) * 0.1,
            "mask": (torch.arange(256)[None, :] < 98).expand(B, 256),
            "labels": torch.randint(1, 257, (B, 8), generator=g),
            "label_mask": torch.arange(8)[None, :] < torch.tensor(
                [8, 5, 3])[:, None],
            "lid_label": torch.randint(0, 2048, (B,), generator=g),
            "emotion_label": torch.randint(0, 4, (B,), generator=g),
            "speaker_label": torch.randint(0, 1024, (B,), generator=g)})
    ref = compare.reference_steps(c, p0, batches)
    o = c["optimizer"]
    tx = Optimizer(lr=o["lr"], weight_decay=o["weight_decay"],
                   warmup_steps=o["warmup_steps"],
                   decay_steps=o["decay_steps"])
    p = W.tree_map(lambda t: t.clone().requires_grad_(True), p0)
    st = tx.init(p)
    fe = MelFrontend(cfg.frontend, "cpu")
    got = {"loss": []}
    for k, b in enumerate(batches):
        b = mel_from_samples(b, fe)
        total, _ = loss_fn(p, b, cfg)
        grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True)
        tx.update(st, list(grads))
        got["loss"].append(float(total.detach()))
        if k == 0:
            got["grad_norms"] = torch.stack([
                st.opt.state[x]["exp_avg"].norm() / 0.1 for x in st.leaves])
    got["change"] = torch.stack([(x.detach() - x0).norm() for x, x0 in
                                 zip(W.leaves(p), W.leaves(p0))])
    r = compare.train_readings(got, ref)
    # The port's speaker projection rounds to bf16 at every encoder dtype
    # (as the JAX package's does): ~1e-4 of the loss, a few 1e-4 of a leaf.
    assert r["loss_gap"] < 1e-3 and r["grad_gap"] < 5e-3
    assert r["change_gap"] < 5e-3
    ctl = compare.reference_steps(c, p0, batches, M.fp8_round)
    rc = compare.train_readings(ctl, ref)
    assert rc["grad_gap"] > 100 * r["grad_gap"]
