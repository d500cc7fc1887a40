"""PyTorch port: the span recorder (``utils/tracing.py``) and the spans the
engine, the decoders and the training step record.

Spans record only while a ``torch.profiler`` session records; here that is
a CPU-activity session around a tiny CPU engine (a random text translator
and summarizer) or a tiny pool step. The translator decodes 16 steps here
in place of 128, to keep the tests short.
"""

from __future__ import annotations

import dataclasses
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_torch.models import translation as ptr
from omnilingual_asr_torch.models.summarizer import (SummaryDecoder,
                                                     fact_prefix_ids)
from omnilingual_asr_torch.train import device_pool, step, synth
from omnilingual_asr_torch.types import TranscriptSegment
from omnilingual_asr_torch.utils import tracing
from test_torch_engine_threads import _wav

torch.set_num_threads(2)

SEED = 4_242
STAGE_SPANS = {"decode", "forward", "extract", "assemble",
               "assemble.cluster", "assemble.segments", "assemble.translate",
               "assemble.summary"}


def traced():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    return [_wav(d / f"f{i}.wav", s, SEED + i)
            for i, s in enumerate((5.5, 8.0))]


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_config()
    cfg = cfg.replace(decode=dataclasses.replace(cfg.decode,
                                                 lid_conf_threshold=0.0))
    gen = torch.Generator().manual_seed(SEED)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOM-INIT")
        eng = TranscriptionEngine(
            config=cfg, device="cpu", speaker_mode="inline",
            translator_params=ptr.text_translator_init(gen, cfg, n_layers=2),
            summarizer_params=ptr.translator_init(gen, cfg, n_layers=2))
    eng.TRANSLATE_MAX_BYTES = 16
    return eng


@pytest.fixture(scope="module")
def one_request(engine, files):
    """One traced transcription: its spans, the profiler's event names and
    the file's seconds."""
    tracing.clear()
    with traced() as prof:
        engine.transcribe(files[0])
    events = {e.name for e in prof.events()}
    spans = tracing.spans()
    tracing.clear()
    return spans, events, engine.last_trace.audio_seconds


def test_nothing_recorded_without_a_profiler(engine, files):
    engine.transcribe(files[0])
    assert tracing.spans() == []
    assert set(engine.last_trace.stages) == STAGE_SPANS
    with traced():
        with tracing.span("x") as on:
            assert on.on
    with tracing.span("x") as off:
        assert not off.on
    assert [s.name for s in tracing.spans()] == ["x"]


def test_one_request_span_is_every_span_s_root(one_request):
    spans, _, audio_s = one_request
    roots = [s for s in spans if s.name == "request"]
    assert len(roots) == 1
    root = roots[0]
    assert root.parent is None and root.request == root.id
    assert root.counts == {"audio_s": pytest.approx(audio_s)}
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s is root:
            continue
        assert s.request == root.id, s
        assert s.parent in by_id, s
        p = by_id[s.parent]
        assert p.start <= s.start <= s.end <= p.end, (s, p)
    names = {s.name for s in spans}
    assert STAGE_SPANS - {"decode"} <= names
    assert {"lock.wait", "lock.held", "decode.translate",
            "decode.summary"} <= names
    # Each extract is a child of the forward; each lock span has its site.
    fwd = {s.id for s in spans if s.name == "forward"}
    assert all(s.parent in fwd for s in spans if s.name == "extract")
    sites = {s.counts["site"] for s in spans if s.name.startswith("lock.")}
    assert sites == {"forward", "translate", "summary"}
    for s in spans:
        if s.name.startswith("decode."):
            assert by_id[s.parent].name == "lock.held"


def test_spans_never_enter_the_profiler_s_events(one_request):
    spans, events, _ = one_request
    assert spans and events
    assert not {s.name for s in spans} & events


def test_lock_wait_covers_the_other_thread_s_hold(engine, files):
    """The lock is held by one request at a time, and a request that waited
    for it waited while another request held it: some hold of the other
    request ends inside the wait."""
    go = threading.Barrier(2)
    errors = []

    def client(path):
        try:
            go.wait(timeout=30)
            engine.transcribe(path)
        except Exception as e:     # surfaced below
            errors.append(e)

    with traced():
        ts = [threading.Thread(target=client, args=(f,)) for f in files]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in ts)
    spans = tracing.spans()
    assert len({s.request for s in spans}) == 2
    assert len({s.thread for s in spans}) == 2
    held = sorted((s for s in spans if s.name == "lock.held"),
                  key=lambda s: s.start)
    for a, b in zip(held, held[1:]):
        assert a.end <= b.start
    waits = [s for s in spans if s.name == "lock.wait"]
    covered = [(w, h) for w in waits for h in held
               if h.request != w.request and w.start < h.end <= w.end]
    assert covered
    for w, h in covered:
        assert w.thread != h.thread


def test_decode_counts_equal_a_hand_count(engine, monkeypatch):
    """The translator's span counts its real rows, the batch it ran and
    the steps to each real row's EOS (a row without one counts every step);
    the summarizer's counts its forced prefix as useful."""
    L = engine.TRANSLATE_MAX_BYTES
    toks = torch.zeros((128, L), dtype=torch.int32)
    toks[0, :2] = 7                 # EOS at step 3
    toks[1] = 9                     # no EOS: every step
    toks[2:, :5] = 3                # padded rows: run, not useful
    monkeypatch.setattr(engine._translator, "translate_text",
                        lambda ids, mask, max_len: toks)
    segs = [TranscriptSegment(start=0.0, end=1.0, speaker="Speaker 1",
                              text=t, language_code="ka")
            for t in ("gamarjoba", "madloba")]
    with traced():
        engine._translate_segments_text(segs)
    (sp,) = tracing.spans()
    assert sp.name == "decode.translate"
    assert sp.counts == {"rows": 2, "rows_run": 128, "steps_run": L,
                         "row_steps_useful": 3 + L}

    cfg = tiny_config()
    params = ptr.translator_init(torch.Generator().manual_seed(1), cfg,
                                 n_layers=1)
    params["fact_cond"] = torch.ones(())
    sm = SummaryDecoder(cfg, params)
    facts = {"n_speakers": 2, "tone": "happy", "language_names": ["Greek"]}
    n_prefix = len(fact_prefix_ids(cfg.vocab, **facts))
    out = torch.full((1, 40), 5, dtype=torch.int32)
    out[0, n_prefix + 4] = 0        # 5 free steps after the prefix
    monkeypatch.setattr(sm.decoder, "decode", lambda *a, **kw: out)
    tracing.clear()
    with traced():
        sm.summarize([np.ones((3, cfg.encoder.d_model), np.float32)],
                     max_len=40, facts=facts)
    (sp,) = tracing.spans()
    assert sp.name == "decode.summary"
    assert sp.counts == {"rows": 1, "rows_run": 1, "steps_run": 40,
                         "row_steps_useful": n_prefix + 5}


@pytest.mark.parametrize("tokens, n_forced, want", [
    ([[5, 3, 0, 0], [0, 0, 0, 0], [1, 2, 3, 4]], 0, 3 + 1 + 4),
    ([[7, 0, 5, 0]], 2, 2 + 2),     # a forced 0 never ends a row
    ([[7, 7, 7]], 3, 3),            # all forced
    (np.zeros((0, 8), np.int32), 0, 0),
])
def test_row_steps_useful(tokens, n_forced, want):
    assert tracing.row_steps_useful(np.asarray(tokens), n_forced) == want


def test_pool_step_spans_its_four_phases_in_order():
    cfg = tiny_config()
    batcher = synth.SynthBatcher(cfg, batch_size=4, window_seconds=2.0,
                                 seed=3, n_threads=1, real_fraction=0.0,
                                 codeswitch_fraction=0.0, bake_mode=True)
    try:
        batches = [next(iter(batcher))]
    finally:
        batcher.close()
    pool = device_pool.pool_to_device(
        device_pool.build_pool(iter(batches), 4, wire="i16"), "cpu")
    init, pool_step, _, _ = device_pool.make_pool_train_step(
        cfg, "cpu", tx=step.make_optimizer(warmup_steps=0, decay_steps=10))
    st = init(1)
    scalars = {"w_spk": 1.0, "w_trans": 1.0, "w_aug": 1.0, "w_fce": 0.5,
               "w_ctc": 1.0}
    pool_step(st.params, st.opt_state, pool, torch.tensor([0, 2]), 0,
              dict(scalars))
    assert tracing.spans() == []
    with traced():
        pool_step(st.params, st.opt_state, pool, torch.tensor([1, 3]), 1,
                  dict(scalars))
    spans = sorted(tracing.spans(), key=lambda s: s.start)
    assert [s.name for s in spans] == ["train.step", "step.gather",
                                       "step.forward", "step.backward",
                                       "step.optimizer"]
    root = spans[0]
    assert root.counts == {"step": 1} and root.parent is None
    for a, b in zip(spans[1:], spans[2:]):
        assert a.end <= b.start
    for s in spans[1:]:
        assert s.parent == root.id
        assert root.start <= s.start <= s.end <= root.end
