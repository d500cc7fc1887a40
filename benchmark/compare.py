"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``benchmark/reference/``), number by
number.

Serving (a sample of the window's finished requests, drawn from the seed):
- ``ctc_mean_gap``, ``lid_mean_gap``: the mean over every valid frame of
  every window of the gap, in nats, by which the logit of the frame's
  served CTC class (language class) lies below the reference's best at
  that frame (the widest such gap does not separate bf16 from the int8
  control for CTC: it is set by the one nearest tie);
- ``emotion_err``, ``speaker_err``: the RMS of the served emotion logits'
  (x-vector speaker frames') difference from the reference over the RMS of
  the reference's;
- ``decoder_gap``: the widest gap by which a served decoder token's logit
  lies below the reference decoder's best at its position, teacher-forced
  on the served tokens, up to each row's EOS, over the translator's and the
  summarizer's tokens (forced prefix positions are not judged).
Beside them, for the record: the widest CTC and LID gaps, the decoders'
mean gaps, and each decoder's widest gap alone. The cell's limits file
names the numbers compared.

Training (the first three steps of the object the window then drives):
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  clipped gradient (the program's read from its optimizer state after one
  step), against the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``change_gap``: the same for the norm of each leaf's change over the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import ROOT
from benchmark.reference import exact_f32
from benchmark.reference import model as M
from benchmark.reference import weights as W

N_REAL = 257          # blank + 256 bytes: the classes a served token takes


def steps_to_eos(toks) -> int:
    """Positions a greedy row decoded up to and including its first EOS
    (0), or all of them."""
    toks = np.asarray(toks)
    z = np.flatnonzero(toks == 0)
    return int(z[0]) + 1 if z.size else len(toks)


def enc_cfg(c: dict) -> dict:
    e = c["encoder"]
    return {"d_model": e["d_model"], "n_layers": e["n_layers"],
            "n_heads": e["n_heads"], "ffn_mult": e["ffn_mult"],
            "conv_kernel": e["conv_kernel"],
            "subsample_factor": e["subsample_factor"],
            "n_mels": c["frontend"]["n_mels"],
            "vocab_size": c["vocab"]["vocab_size"]}


def _gaps(ref: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """Per row: best reference logit - reference logit of the served
    class; ref [N, C], served [N] int."""
    pick = ref.gather(1, served.long()[:, None])[:, 0]
    return ref.max(dim=1).values - pick


class _Gap:
    """The widest gap and the mean gap over every position added."""

    def __init__(self):
        self.max, self.sum, self.n = 0.0, 0.0, 0

    def add(self, ref: torch.Tensor, served: torch.Tensor):
        if ref.shape[0] == 0:
            return
        g = _gaps(ref, served)
        self.max = max(self.max, float(g.max()))
        self.sum += float(g.sum())
        self.n += int(g.numel())

    def readings(self, name: str) -> Dict[str, float]:
        n = max(self.n, 1)
        return {f"{name}_gap": self.max, f"{name}_mean_gap": self.sum / n}


class _Rms:
    def __init__(self):
        self.num = 0.0
        self.den = 0.0

    def add(self, got: torch.Tensor, want: torch.Tensor):
        self.num += float(((got - want) ** 2).sum())
        self.den += float((want ** 2).sum())

    @property
    def value(self) -> float:
        return math.sqrt(self.num / self.den) if self.den > 0 else 0.0


def _first(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


@torch.no_grad()
def serve_readings(c: dict, files, served: List[dict], device,
                   control: bool = False):
    """-> (readings, counts): every candidate number, and how many frames,
    requests and decoder tokens they were taken over. Which of them decide
    ``correct`` is the cell's limits file's choice.

    ``control``: the x-vector's frames and the decoders' tokens are the
    reference's own computed in fp8 (the program has no lower-precision
    path for them): at each position of the same prompts and tokens, the
    token the fp8 reference puts first is judged."""
    exact_f32()
    fe, ec = c["frontend"], enc_cfg(c)
    w = c["weights"]
    asr = W.load_npz(ROOT / w["asr"], device)
    xv = W.load_npz(ROOT / w["xvector"], device)
    tr = W.load_npz(ROOT / w["translator"], device)
    sm = W.load_npz(ROOT / w["summarizer"], device)
    consts = M.mel_constants(fe, device)
    heads = ec["n_heads"]
    lowp = M.fp8_round if control else None
    ws = int(c["engine_window_seconds"] * fe["sample_rate"])
    n_frames = M.frames_for_samples(fe, ws)
    block = c["frame_block"]
    wf = -(-n_frames // block) * block
    ctc, lid, trg, smg = _Gap(), _Gap(), _Gap(), _Gap()
    emo, spk = _Rms(), _Rms()
    counts = {"requests": len(served), "frames": 0, "translate_tokens": 0,
              "summary_tokens": 0}
    for req in served:
        x = files[req["file"]]
        n_win = -(-len(x) // ws)
        rows = np.zeros((n_win, ws), np.float32)
        valid = []
        for i in range(n_win):
            seg = x[i * ws:(i + 1) * ws]
            rows[i, :len(seg)] = seg.astype(np.float32) / 32768.0
            valid.append(min(M.frames_for_samples(fe, len(seg)), wf))
        xs = torch.from_numpy(rows).to(device)
        mel = M.log_mel(xs, fe, consts, wf)
        mask = torch.arange(wf, device=device)[None, :] < torch.tensor(
            valid, device=device)[:, None]
        out = M.conformer(asr, mel, mask, ec)
        frames = M.xvector(xv, mel, mask)
        frames_ctl = M.xvector(xv, mel, mask, lowp) if control else None
        means = []
        for wd in req["windows"]:
            i = int(round(float(wd["offset_s"]) / c["engine_window_seconds"]))
            n = len(wd["ctc_ids"])
            counts["frames"] += n
            ids = torch.from_numpy(wd["ctc_ids"].astype(np.int64)).to(device)
            lids = torch.from_numpy(wd["lid_ids"].astype(np.int64)).to(device)
            ctc.add(out["ctc"][i, :n, :N_REAL], ids)
            lid.add(out["lid"][i, :n], lids)
            emo.add(torch.from_numpy(wd["emotion_logits"]).to(device).float(),
                    out["emotion"][i, :n])
            got = (frames_ctl[i, :n] if control else torch.from_numpy(
                wd["speaker_frames"]).to(device).float())
            spk.add(got, frames[i, :n])
            means.append(out["states"][i, :n].mean(dim=0))
        for ids, msk, toks in req["translate"]:
            live = np.flatnonzero(msk.any(axis=1))
            if live.size == 0:
                continue
            ids_t = torch.from_numpy(ids[live].astype(np.int64)).to(device)
            m_t = torch.from_numpy(msk[live]).to(device)
            tk = torch.from_numpy(toks[live].astype(np.int64)).to(device)
            inp = torch.cat([torch.zeros_like(tk[:, :1]), tk[:, :-1]], dim=1)
            mem = M.source_encoder(tr, ids_t, m_t, heads)
            logits = M.decoder_logits(tr, inp, mem, m_t, heads)[..., :N_REAL]
            if control:
                mem_c = M.source_encoder(tr, ids_t, m_t, heads, lowp)
                tk = _first(M.decoder_logits(tr, inp, mem_c, m_t, heads,
                                             lowp)[..., :N_REAL])
            for r in range(len(live)):
                L = steps_to_eos(toks[live[r]])
                counts["translate_tokens"] += L
                trg.add(logits[r, :L], tk[r, :L])
        for enc_mask, forced, toks in req["summary"]:
            Te = enc_mask.shape[1]
            memory = torch.zeros((1, Te, ec["d_model"]), device=device)
            k = min(len(means), Te)
            memory[0, :k] = torch.stack(means[:k])
            m_t = torch.from_numpy(np.asarray(enc_mask, bool)).to(device)
            tk = torch.from_numpy(toks.astype(np.int64)).to(device)
            inp = torch.cat([torch.zeros_like(tk[:, :1]), tk[:, :-1]], dim=1)
            logits = M.decoder_logits(sm, inp, memory, m_t, heads)[0, :, :N_REAL]
            if control:
                tk = _first(M.decoder_logits(sm, inp, memory, m_t, heads,
                                             lowp)[..., :N_REAL])
            free = np.ones(toks.shape[1], bool) if forced is None else \
                np.asarray(forced)[0] < 0
            n_forced = int((~free).sum())
            L = n_forced + steps_to_eos(toks[0, n_forced:])
            judged = torch.from_numpy(np.flatnonzero(free[:L])).to(device)
            counts["summary_tokens"] += int(judged.numel())
            smg.add(logits[judged], tk[0, judged])
    out = {**ctc.readings("ctc"), **lid.readings("lid"),
           "emotion_err": emo.value, "speaker_err": spk.value,
           **trg.readings("translate"), **smg.readings("summary")}
    # Both decoders' tokens together: the summarizer's margins are wide
    # enough that neither bf16 nor fp8 rounding flips more than a rare
    # token, so its widest gap alone does not separate the two.
    out["decoder_gap"] = max(out["translate_gap"], out["summary_gap"])
    return out, counts


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def augment(x_i16, n_valid, gain, snr, noise):
    """Gain, then white noise at ``snr`` dB of the gained signal's power
    over the valid samples, on the valid samples, clipped to [-1, 1]."""
    x = x_i16.to(torch.float32) / 32768.0
    W_ = x.shape[1]
    valid = (torch.arange(W_, device=x.device)[None, :]
             < n_valid[:, None]).to(x.dtype)
    x = x * gain
    p = (x * x * valid).sum(dim=1, keepdim=True) / torch.clamp(
        n_valid[:, None].to(x.dtype), min=1.0) + 1e-12
    return torch.clamp(x + noise * torch.sqrt(p / 10.0 ** (snr / 10.0))
                       * valid, -1.0, 1.0)


def lr_at(opt: dict, count: int) -> float:
    """Warm-up from 0 over ``warmup`` updates, then cosine decay to 5 % of
    ``lr`` at ``decay``."""
    lr, warm, decay = opt["lr"], opt["warmup_steps"], opt["decay_steps"]
    if count < warm:
        return lr * count / warm
    t = min(count - warm, decay - warm)
    return lr * (0.95 * 0.5 * (1.0 + math.cos(math.pi * t / (decay - warm)))
                 + 0.05)


def reference_steps(c: dict, params0: dict, batches, lowp=None) -> dict:
    """The reference's first ``len(batches)`` updates from ``params0``:
    the loss of each, the norms of each leaf's clipped gradient at the
    first, and the norms of each leaf's change after the last.
    AdamW written out: clip by global norm, NaN to zero, decoupled weight
    decay, bias-corrected moments."""
    exact_f32()
    fe, ec, opt = c["frontend"], enc_cfg(c), c["optimizer"]
    device = W.leaves(params0)[0].device
    consts = M.mel_constants(fe, device)
    p = W.tree_map(lambda t: t.detach().clone().requires_grad_(True), params0)
    leaves = W.leaves(p)
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    out = {"loss": []}
    for step, batch in enumerate(batches):
        loss = M.train_loss(p, batch, ec, fe, consts, lowp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads)]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if float(norm) >= opt["max_norm"]:
            grads = [g / norm * opt["max_norm"] for g in grads]
        grads = [torch.where(torch.isnan(g), torch.zeros_like(g), g)
                 for g in grads]
        if step == 0:
            out["grad_norms"] = torch.stack([g.norm() for g in grads])
        lr = lr_at(opt, step)
        t = step + 1
        with torch.no_grad():
            for x, g, mi, vi in zip(leaves, grads, m, v):
                x.mul_(1.0 - lr * wd)
                mi.mul_(b1).add_(g, alpha=1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (vi.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
                x.addcdiv_(mi, denom, value=-lr / (1.0 - b1 ** t))
        out["loss"].append(float(loss.detach()))
        del loss, grads
    out["change"] = torch.stack([(x.detach() - x0).norm() for x, x0 in
                                 zip(leaves, W.leaves(params0))])
    return out


def train_readings(got: dict, ref: dict) -> Dict[str, float]:
    """``got`` and ``ref`` as :func:`reference_steps` returns them."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       ref["loss"]))
    gr, gp = ref["grad_norms"].double(), got["grad_norms"].double()
    med = gr.median()
    grad_gap = float(((gp - gr).abs() / torch.maximum(gr, med)).max())
    moved = gr >= 1e-3 * med
    dr, dp = ref["change"].double()[moved], got["change"].double()[moved]
    change_gap = float(((dp - dr).abs()
                        / torch.maximum(dr, dr.median())).max())
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}
