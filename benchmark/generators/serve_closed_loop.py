"""Closed-loop clients calling ``TranscriptionEngine.transcribe`` on files
tiled from the golden dialogue.

Set-up writes the mix's files (under ``TMPDIR``), builds the engine from
the configuration file (weights by explicit path), and warms it with the
mix's warm-up requests, client after client, each client on a thread of
its own, which builds the kernels and captures the decoders' graphs at the
shapes the window uses. One client at a time does the same work in the same
order in every run, so set-up does not swing with how the clients meet on
the device lock. The window
starts every client together; each sends its next request when the last
returns, until the window's seconds are over, and waits for the one in
flight. A per-thread record takes each request's StageTrace (the engine's
``transcribe_trace`` log event) and, for the comparison with the reference,
the outputs the engine produced: each window's head outputs as they reach
host extraction, and each decode's source and tokens.
"""

from __future__ import annotations

import json
import logging
import shutil
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from benchmark import audio, compare, roofline
from benchmark.reference import model as M
from benchmark.harness import ROOT, Check, DeviceTrace, Phases, Record, \
    RunError, checks, device_profile, free_device, pipeline_config

def build_engine(c: dict, device, overrides=None):
    from omnilingual_asr_torch.engine import TranscriptionEngine

    w = c["weights"]
    kw = dict(c["engine"])
    kw.update(overrides or {})
    return TranscriptionEngine(
        config=pipeline_config(c), device=device,
        translator_path=str(ROOT / w["translator"]),
        summarizer_path=str(ROOT / w["summarizer"]),
        xvector_path=str(ROOT / w["xvector"]), **kw)


class _Capture(logging.Handler):
    """Hands each request's StageTrace to the record of its thread."""

    def __init__(self, local):
        super().__init__(logging.INFO)
        self.local = local

    def emit(self, record):
        rec = getattr(self.local, "rec", None)
        if rec is None:
            return
        try:
            msg = json.loads(record.getMessage())
        except ValueError:
            return
        if msg.get("event") == "transcribe_trace":
            rec["stages"] = msg["stages"]


def install_spies(engine, local):
    """Wraps the engine's host extraction and its decoders so that the
    request running on each thread records what they produced."""
    orig_extract = engine._extract_windows

    def extract(window_outs, *rest):
        rec = getattr(local, "rec", None)
        if rec is not None:
            for w in window_outs:
                rec["windows"].append({k: w[k] for k in (
                    "offset_s", "ctc_ids", "lid_ids", "emotion_logits",
                    "speaker_frames")})
        return orig_extract(window_outs, *rest)

    engine._extract_windows = extract
    tr = engine._translator
    if tr is not None:
        orig_tt = tr.translate_text

        def translate_text(tokens, mask, max_len=128):
            out = orig_tt(tokens, mask, max_len=max_len)
            rec = getattr(local, "rec", None)
            if rec is not None:
                rec["translate"].append((tokens, mask, out))
            return out

        tr.translate_text = translate_text
    sm = engine._summarizer
    if sm is not None:
        dec = sm.decoder
        orig_decode = dec.decode

        def decode(enc, enc_mask, max_len=192, bos_id=0, forced=None):
            out = orig_decode(enc, enc_mask, max_len=max_len, bos_id=bos_id,
                              forced=forced)
            rec = getattr(local, "rec", None)
            if rec is not None:
                rec["summary"].append((enc_mask, forced, out))
            return out

        dec.decode = decode


def _stage_spans(req: dict):
    """(stage, start, end) of one request, laid end to end from its
    StageTrace in the order transcribe runs them."""
    st, t = req.get("stages", {}), req["t0"]
    out = []
    for name in ("decode",):
        if name in st:
            out.append((name, t, t + st[name]))
            t += st[name]
    fwd = st.get("forward", 0.0) + st.get("extract", 0.0)
    out.append(("forward+extract", t, t + fwd))
    t += fwd
    for sub in ("cluster", "segments", "translate", "summary"):
        d = st.get(f"assemble.{sub}", 0.0)
        out.append((f"assemble.{sub}", t, t + d))
        t += d
    return out


def decode_counts(req: dict, cfg: dict) -> dict:
    """Useful decoder work of a request: per translate batch, each real
    row's valid source bytes and steps up to and including its EOS; per
    summary, the steps up to its EOS."""
    tr_rows, sm_steps = [], []
    for tokens, mask, out in req["translate"]:
        m = np.asarray(mask)
        toks = out.cpu().numpy()
        for r in np.flatnonzero(m.any(axis=1)):
            tr_rows.append((int(m[r].sum()), compare.steps_to_eos(toks[r])))
    for enc_mask, forced, out in req["summary"]:
        toks = out.cpu().numpy()[0]
        n_forced = 0 if forced is None else int(
            (np.asarray(forced)[0] >= 0).sum())
        sm_steps.append((int(np.asarray(enc_mask).sum()),
                         n_forced + compare.steps_to_eos(toks[n_forced:])))
    return {"translate_rows": tr_rows, "summary": sm_steps}


def request_flops(req: dict, c: dict) -> float:
    """Model FLOPs of the useful work of one request: every window's valid
    frames through the conformer with its heads and the x-vector, and the
    decoders' steps up to each row's EOS."""
    e, fe = c["encoder"], c["frontend"]
    dec = c["decoders"]
    total = 0.0
    for w in req["windows"]:
        n = len(w["ctc_ids"])
        total += n * roofline.encoder_flops_per_frame(
            e["d_model"], e["n_layers"], e["ffn_mult"], e["conv_kernel"],
            fe["n_mels"], e["subsample_factor"], n, c["vocab"]["vocab_size"])
        total += n * roofline.xvector_flops_per_frame(fe["n_mels"])
    d, V = e["d_model"], c["vocab"]["vocab_size"]
    counts = req["counts"]
    for src, steps in counts["translate_rows"]:
        total += roofline.source_encoder_flops(d, dec["translator_src_layers"],
                                               src)
        total += roofline.decoder_memory_flops(d, dec["translator_layers"],
                                               src)
        total += sum(roofline.decoder_step_flops(
            d, dec["translator_layers"], V, t, src) for t in range(steps))
    for mem, steps in counts["summary"]:
        total += roofline.decoder_memory_flops(d, dec["summarizer_layers"],
                                               mem)
        total += sum(roofline.decoder_step_flops(
            d, dec["summarizer_layers"], V, t, mem) for t in range(steps))
    return total


def run(cell, *, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda:0", control: bool = False) -> Record:
    """``control``: the program's int8 path (``quantize="a8"``) serves, and
    the comparison judges the x-vector and the decoders by the fp8
    reference in their place."""
    overrides = {"quantize": "a8"} if control else None
    phases = Phases(t_start)
    phases.mark("entered")
    mix = cell.traffic
    rng = np.random.default_rng([seed, 1])
    n_samples = int(mix["file_seconds"] * audio.SAMPLE_RATE)
    files = [audio.tiled_file(rng, n_samples, mix["gain"], mix["snr_db"])
             for _ in range(mix["n_files"])]
    phases.mark("files")
    tmp = Path(tempfile.mkdtemp(prefix="bench_wavs_"))
    try:
        paths = []
        for i, x in enumerate(files):
            p = tmp / f"f{i:02d}.wav"
            audio.write_wav(p, x)
            paths.append(p)
        phases.mark("wavs")
        return _run(cell, files, paths, seed, seconds, trace, phases,
                    device, overrides, control)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, files, paths, seed, seconds, trace, phases, device,
         overrides, control) -> Record:
    import torch

    mix, c = cell.traffic, cell.config
    engine = build_engine(c, device, overrides)
    phases.mark("engine")
    local = threading.local()
    logger = logging.getLogger("omniasr")
    handler = _Capture(local)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    install_spies(engine, local)
    n_clients = mix["clients"]
    orders = [np.random.default_rng([seed, 2, k]).permutation(len(paths))
              for k in range(n_clients)]

    def warm(k):
        for j in range(mix["warmup_requests_per_client"]):
            engine.transcribe(paths[orders[k][j % len(paths)]])
            phases.mark(f"warm.{k}.{j}")

    _in_turn(warm, n_clients)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - phases.t_start

    requests, lock = [], threading.Lock()
    failures = []
    sample_rng = np.random.default_rng([seed, 3])
    state = {"n": 0}
    sample = []
    k_sample = mix["check_requests"]
    t0 = time.perf_counter() + 0.05
    t_end = t0 + seconds

    next_file = [mix["warmup_requests_per_client"]] * n_clients

    def client(k, begin, stop, sink=None):
        """Sends requests from ``begin`` until ``stop``; a window's go to
        the comparison's sample and the metrics, a traced slice's to
        ``sink`` (their stages name the device's idle gaps)."""
        while time.perf_counter() < begin:
            time.sleep(0.001)
        while time.perf_counter() < stop:
            f = int(orders[k][next_file[k] % len(paths)])
            next_file[k] += 1
            rec = {"client": k, "file": f, "windows": [], "translate": [],
                   "summary": [], "t0": time.perf_counter()}
            local.rec = rec
            try:
                engine.transcribe(paths[f])
            except Exception as e:     # a failed request counts, the run goes on
                rec["error"] = repr(e)
            finally:
                local.rec = None
            rec["t1"] = time.perf_counter()
            with lock:
                if sink is not None:
                    sink.append(rec)
                    continue
                if "error" in rec:
                    failures.append(rec)
                    continue
                requests.append(rec)
                state["n"] += 1
                if len(sample) < k_sample:
                    sample.append(rec)
                    slim = None
                else:
                    i = int(sample_rng.integers(0, state["n"]))
                    slim = rec
                    if i < k_sample:
                        slim, sample[i] = sample[i], rec
                if slim is not None:    # keeps what mfu counts only
                    slim["windows"] = [
                        {"ctc_ids": w["ctc_ids"]}
                        for w in slim["windows"]]

    _clients(client, n_clients, t0, t_end)
    if device != "cpu":
        torch.cuda.synchronize()
    slice_out: dict = {}
    if trace:
        # The traced slice: the same clients and files, started again once
        # the window's requests are in, under a profiler started while the
        # card is idle; its first seconds ramp the load up and are not in
        # the slice, and every client has finished before it stops.
        with device_profile(slice_out):
            begin = time.perf_counter() + 0.05
            stop = begin + mix["trace_warm_s"] + mix["trace_slice_s"]
            sliced = []
            threads = _start(client, n_clients, begin, stop, sliced)
            while time.perf_counter() < stop - mix["trace_slice_s"]:
                time.sleep(0.001)
            slice_out["start_s"] = time.perf_counter()
            while time.perf_counter() < stop:
                time.sleep(0.001)
            slice_out["slice_end_s"] = time.perf_counter()
            for t in threads:
                t.join()
        slice_out["end_s"] = slice_out.pop("slice_end_s")

    rec = Record()
    rec.attempted = len(requests) + len(failures)
    rec.failed = len(failures)
    done_in_window = [r for r in requests if r["t1"] <= t_end]
    audio_s = sum(len(files[r["file"]]) for r in done_in_window) \
        / audio.SAMPLE_RATE
    rec.end_to_end = {"audio_s_per_s": audio_s / seconds,
                      "setup_s": setup_s}
    if device != "cpu":
        rec.device["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated())
    for r in requests:
        r["counts"] = decode_counts(r, c)
        r["audio_s"] = len(files[r["file"]]) / audio.SAMPLE_RATE
    useful = sum(request_flops(r, c) for r in done_in_window)
    rec.facts = _facts(c, mix, seconds, useful)
    rec.facts["setup_phases"] = phases.marks
    rec.spans = [{"audio_s": r["audio_s"], "stages": r.get("stages", {}),
                  "t0": r["t0"], "t1": r["t1"]} for r in done_in_window]
    rec.facts["latencies_s"] = [r["t1"] - r["t0"]
                                for r in requests + failures]
    if trace:
        host = [s for r in sliced for s in _stage_spans(r)]
        rec.trace = DeviceTrace(slice_out["ops"], slice_out["start_s"],
                                slice_out["end_s"], host)
        rec.facts["trace_costs"] = {
            k: slice_out.get(k) for k in ("start_cost_s", "stop_cost_s",
                                          "read_cost_s")}

    # The comparison, once the window has closed and the program is freed.
    logger.removeHandler(handler)
    checked = [_served(r) for r in sample]
    del engine, requests, sample
    free_device(device)
    readings, rec.facts["compared_counts"] = compare.serve_readings(
        c, files, checked, device, control)
    rec.facts["readings"] = readings
    rec.checks = checks(readings, cell.limits)
    if not checked:
        rec.checks.append(Check("requests_compared", float("inf"), 0.0))
    return rec


def _served(r: dict) -> dict:
    """A sampled request's outputs, on the host."""
    return {"file": r["file"],
            "windows": [{k: np.asarray(v) for k, v in w.items()}
                        for w in r["windows"]],
            "translate": [(np.asarray(t), np.asarray(m), o.cpu().numpy())
                          for t, m, o in r["translate"]],
            "summary": [(np.asarray(m), None if f is None else np.asarray(f),
                         o.cpu().numpy()) for m, f, o in r["summary"]]}


def _facts(c: dict, mix: dict, seconds: float, useful: float) -> dict:
    """The window's seconds and useful FLOPs, and K2's and K3's calls at
    this mix's shapes: a batch of the engine's windows, each file's last
    batch with its own valid frames and padded slots (the bound a call is
    the mean over a file's batches)."""
    e, fe = c["encoder"], c["frontend"]
    sub, B = e["subsample_factor"], c["engine"]["batch_windows_per_device"]
    ws = int(c["engine_window_seconds"] * fe["sample_rate"])
    n_frames = M.frames_for_samples(fe, ws)
    wf = -(-n_frames // c["frame_block"]) * c["frame_block"]
    n = int(mix["file_seconds"] * fe["sample_rate"])
    valid = [-(-min(M.frames_for_samples(fe, min(ws, n - i)), wf) // sub)
             for i in range(0, n, ws)]
    batches = [valid[i:i + B] for i in range(0, len(valid), B)]
    H, D, T = e["n_heads"], e["d_model"] // e["n_heads"], wf // sub
    attn = [roofline.k2_attn_fwd(B, T, H, D, sum(b)) for b in batches]
    return {"window_s": seconds, "useful_flops": useful,
            "attn_fwd": _mean_op(attn),
            "conv_module": roofline.k3_conv_module(B, T, e["d_model"],
                                                   e["conv_kernel"])}


def _mean_op(ops):
    """One call's (flops, bytes) averaged over calls of several shapes."""
    flops = {}
    for f, _ in ops:
        for k, v in f.items():
            flops[k] = flops.get(k, 0.0) + v / len(ops)
    return flops, sum(b for _, b in ops) / len(ops)


def _start(client, n, begin, stop, sink=None):
    ts = [threading.Thread(target=client, args=(k, begin, stop, sink),
                           daemon=True) for k in range(n)]
    for t in ts:
        t.start()
    return ts


def _clients(client, n, begin, stop):
    for t in _start(client, n, begin, stop):
        t.join()


def _in_turn(fn, n):
    """fn(0), ..., fn(n - 1), each on a thread of its own, one after
    another."""
    errors = []

    def wrap(k):
        try:
            fn(k)
        except BaseException as e:     # surfaced below
            errors.append(e)

    for k in range(n):
        t = threading.Thread(target=wrap, args=(k,))
        t.start()
        t.join()
        if errors:
            raise RunError(f"warm-up failed: {errors[0]!r}")
