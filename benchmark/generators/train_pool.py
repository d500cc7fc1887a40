"""Training steps through the device pool's step
(``train/device_pool.py::make_pool_train_step``).

Set-up makes, on the card from the seed, the pool's rows (crops of the
tiled golden dialogue with drawn gain, offset and noise), their targets
(byte labels without adjacent repeats at the mix's lengths, language,
emotion and speaker classes) and the initial weights, and hands the weights
to the step with the optimizer's fresh state. It then drives that object
through the mix's first steps on rows that all differ, reading each step's
loss, the first clipped gradient (from the optimizer's moments after one
step) and each leaf's change after the last of them. The window calls the
same step on the same feed until its seconds are over. Every step's gain,
SNR and noise are drawn by the benchmark on the card from the seed and the
step, and handed to the step. After the window the program's state is
freed and the reference repeats the first steps from the same weights on
the same rows and draws.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import audio, compare, roofline
from benchmark.harness import DeviceTrace, Phases, Record, checks, \
    device_profile, free_device, pipeline_config
from benchmark.reference import model as M
from benchmark.reference import weights as W

def make_pool(mix: dict, c: dict, seed: int, device) -> dict:
    """The pool's tensors on ``device``: int16 rows, their sample counts,
    mel-frame masks, byte labels and classes."""
    import torch

    fe = c["frontend"]
    P = mix["pool_rows"]
    n = int(mix["row_seconds"] * fe["sample_rate"])
    samples = audio.pool_rows(seed, P, n, device, mix["pool_gain"],
                              mix["pool_snr_db"])
    n_frames = M.frames_for_samples(fe, n)
    T = -(-n_frames // c["frame_block"]) * c["frame_block"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    lo, hi = mix["label_bytes"]
    L = torch.randint(lo, hi + 1, (P,), generator=gen, device=device)
    # Byte ids 1..256 with no id equal to the one before it.
    first = torch.randint(1, 257, (P, 1), generator=gen, device=device)
    steps = torch.randint(1, 256, (P, hi - 1), generator=gen, device=device)
    labels = (first - 1 + torch.cat([torch.zeros_like(first),
                                     steps.cumsum(dim=1)], dim=1)) % 256 + 1
    label_mask = torch.arange(hi, device=device)[None, :] < L[:, None]
    return {
        "samples": samples,
        "n_samples": torch.full((P,), n, dtype=torch.int32, device=device),
        "mask": (torch.arange(T, device=device)[None, :] < n_frames
                 ).expand(P, T).contiguous(),
        "labels": (labels * label_mask).to(torch.int32),
        "label_mask": label_mask,
        "lid_label": torch.randint(0, mix["lid_classes"], (P,),
                                   generator=gen, device=device,
                                   dtype=torch.int32),
        "emotion_label": torch.randint(0, 4, (P,), generator=gen,
                                       device=device, dtype=torch.int32),
        "speaker_label": torch.randint(0, mix["speaker_classes"], (P,),
                                       generator=gen, device=device,
                                       dtype=torch.int32),
    }


class Feed:
    """Step k's rows (a permutation of the pool an epoch, from the seed)
    and its gain, SNR and noise draws."""

    def __init__(self, mix: dict, seed: int, device):
        self.mix, self.seed, self.device = mix, seed, device
        self.B, self.P = mix["batch"], mix["pool_rows"]
        self.perms = {}

    def rows(self, k: int):
        import torch

        per_epoch = self.P // self.B
        e, j = divmod(k, per_epoch)
        if e not in self.perms:
            g = torch.Generator().manual_seed(self.seed * 1009 + e)
            self.perms[e] = torch.randperm(self.P, generator=g)
        return self.perms[e][j * self.B:(j + 1) * self.B].to(self.device)

    def draws(self, k: int, width: int):
        import torch

        g = torch.Generator(device=self.device).manual_seed(
            (self.seed * 7919 + k) % (2 ** 63))
        lo, hi = self.mix["gain"]
        gain = lo + (hi - lo) * torch.rand((self.B, 1), generator=g,
                                           device=self.device)
        lo, hi = self.mix["snr_db"]
        snr = lo + (hi - lo) * torch.rand((self.B, 1), generator=g,
                                          device=self.device)
        noise = torch.randn((self.B, width), generator=g, device=self.device)
        return gain, snr, noise


def reference_batch(pool: dict, idx, draws) -> dict:
    b = {k: v.index_select(0, idx) for k, v in pool.items()}
    b["samples"] = compare.augment(b["samples"], b["n_samples"], *draws)
    return b


def run(cell, *, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda:0", control: bool = False, fault=None) -> Record:
    """``control``: the reference in fp8 stands in for the program (no
    window). ``fault``: a function (step, mix) -> a broken step, for the
    tests that see ``correct`` come out false."""
    import torch

    phases = Phases(t_start)
    phases.mark("entered")
    c, mix = cell.config, cell.traffic
    dev = torch.device(device)
    pool = make_pool(mix, c, seed, dev)
    feed = Feed(mix, seed, dev)
    W_ = pool["samples"].shape[1]
    phases.mark("pool")
    params0 = W.seeded_tree(W.conformer_spec(compare.enc_cfg(c)), seed, dev)
    phases.mark("weights")
    n_check = mix["warmup_steps"]
    rec = Record()
    if control:
        batches = [reference_batch(pool, feed.rows(k), feed.draws(k, W_))
                   for k in range(n_check)]
        got = compare.reference_steps(c, params0, batches, M.fp8_round)
        ref = compare.reference_steps(c, params0, batches)
        rec.facts["readings"] = compare.train_readings(got, ref)
        rec.checks = checks(rec.facts["readings"], cell.limits)
        rec.end_to_end = {"setup_s": time.time() - t_start}
        return rec

    from omnilingual_asr_torch.train.device_pool import make_pool_train_step
    from omnilingual_asr_torch.train.step import CTC_INFEASIBLE, \
        make_optimizer

    opt = c["optimizer"]
    tx = make_optimizer(lr=opt["lr"], weight_decay=opt["weight_decay"],
                        warmup_steps=opt["warmup_steps"],
                        decay_steps=opt["decay_steps"])
    _, pool_step, _, _ = make_pool_train_step(
        pipeline_config(c), dev, tx=tx, snr_range=tuple(mix["snr_db"]),
        gain_range=tuple(mix["gain"]))
    if fault is not None:
        pool_step = fault(pool_step, mix)
    params = W.tree_map(lambda t: t.clone().requires_grad_(True), params0)
    opt_state = tx.init(params)
    phases.mark("step_built")
    scalars = {CTC_INFEASIBLE: np.zeros(0, np.int64)}

    def step(k):
        nonlocal params, opt_state
        params, opt_state, _, metrics = pool_step(
            params, opt_state, pool, feed.rows(k), k, scalars,
            feed.draws(k, W_))
        return metrics

    got = {"loss": []}
    for k in range(n_check):
        got["loss"].append(float(step(k)["loss"]))
        phases.mark(f"step.{k}")
        if k == 0:
            b1 = tx.b1
            got["grad_norms"] = torch.stack([
                opt_state.opt.state[p]["exp_avg"].norm() / (1.0 - b1)
                if p in opt_state.opt.state else torch.zeros((), device=dev)
                for p in opt_state.leaves])
    got["change"] = torch.stack([(x.detach() - x0).norm() for x, x0 in
                                 zip(W.leaves(params), W.leaves(params0))])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec.end_to_end["setup_s"] = time.time() - t_start

    k, n_steps = n_check, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(k)
        k += 1
        n_steps += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    slice_out, host = {}, []
    if trace:
        # The traced slice: the mix's next steps on the same object and
        # feed, drained at both ends, after the window has closed.
        with device_profile(slice_out):
            for _ in range(mix["trace_steps"]):
                a = time.perf_counter()
                step(k)
                host.append(("pool_step", a, time.perf_counter()))
                k += 1
            torch.cuda.synchronize()
    rows = n_steps * mix["batch"]
    rec.end_to_end["train_audio_s_per_s"] = rows * mix["row_seconds"] \
        / elapsed
    rec.attempted = n_steps
    e, fe = c["encoder"], c["frontend"]
    n_frames = M.frames_for_samples(fe, W_)
    T = int(pool["mask"].shape[1])
    sub = e["subsample_factor"]
    valid = -(-n_frames // sub)
    per_frame = roofline.encoder_flops_per_frame(
        e["d_model"], e["n_layers"], e["ffn_mult"], e["conv_kernel"],
        fe["n_mels"], sub, valid, c["vocab"]["vocab_size"])
    B, H = mix["batch"], e["n_heads"]
    shape = (B, T // sub, H, e["d_model"] // H, B * valid)
    rec.facts = {"window_s": elapsed,
                 "useful_flops": roofline.train_step_flops(
                     rows * valid, per_frame),
                 "attn_fwd": roofline.k2_attn_fwd(*shape),
                 "attn_bwd_dq": roofline.k6_attn_bwd_dq(*shape),
                 "attn_bwd_dkv": roofline.k7_attn_bwd_dkv(*shape),
                 "setup_phases": phases.marks}
    if trace:
        rec.facts["trace_steps"] = mix["trace_steps"]
    if dev.type == "cuda":
        rec.device["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated())
    if trace and slice_out:
        rec.trace = DeviceTrace(slice_out["ops"], slice_out["start_s"],
                                slice_out["end_s"], host)
        rec.facts["trace_costs"] = {
            k: slice_out.get(k) for k in ("start_cost_s", "stop_cost_s",
                                          "read_cost_s")}

    # The reference, once the program's state is freed.
    del params, opt_state, pool_step
    free_device(dev)
    batches = [reference_batch(pool, feed.rows(j), feed.draws(j, W_))
               for j in range(n_check)]
    ref = compare.reference_steps(c, params0, batches)
    rec.facts["readings"] = compare.train_readings(got, ref)
    rec.checks = checks(rec.facts["readings"], cell.limits)
    return rec
