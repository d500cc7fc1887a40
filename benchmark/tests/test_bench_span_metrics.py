"""The per-layer readers of the program's spans, on hand-built records:
a device trace with known gaps, and spans with known lock windows, decoder
counts and training phases, each reading worked out by hand."""

import sys

import pytest

from benchmark import harness as H
from omnilingual_asr_torch.utils import tracing

SERVE = ["lock_wait_ms_per_request.serve", "lock_held_ms_per_request.serve",
         "decoder_held_ms_per_request.translate",
         "decoder_useful_step_share.translate",
         "device_idle_in_lock_share.serve"]
TRAIN = ["optimizer_idle_ms_per_step.train", "fwd_bwd_idle_ms_per_step.train"]


def rd(name):
    return H.metric_reader(name)


def span(id, name, start, end, parent=None, request=None, **counts):
    return tracing.Span(name, start, end, 1, id, parent, request, counts)


def serve_spans():
    """Slice [0, 10]. Request 1 ends in it (it began before); request 10
    ends in it; request 20 ends after it and request 30 before it."""
    return [
        span(1, "request", -1.0, 4.0, request=1, audio_s=120.0),
        span(2, "lock.wait", -1.0, 0.5, 1, 1, site="forward"),
        span(3, "lock.held", 0.5, 1.5, 1, 1, site="forward"),
        span(4, "lock.wait", 2.5, 3.0, 1, 1, site="translate"),
        span(5, "lock.held", 3.0, 3.5, 1, 1, site="translate"),
        span(6, "decode.translate", 3.0, 3.5, 5, 1, rows=2, rows_run=128,
             steps_run=128, row_steps_useful=40),
        span(10, "request", 1.0, 8.0, request=10, audio_s=120.0),
        span(11, "lock.wait", 1.0, 1.5, 10, 10, site="forward"),
        span(12, "lock.held", 1.5, 2.5, 10, 10, site="forward"),
        span(13, "lock.wait", 6.0, 6.0, 10, 10, site="summary"),
        span(14, "lock.held", 6.0, 7.0, 10, 10, site="summary"),
        span(15, "decode.summary", 6.0, 7.0, 14, 10, rows=1, rows_run=1,
             steps_run=192, row_steps_useful=50),
        span(20, "request", 9.0, 12.0, request=20, audio_s=120.0),
        span(21, "lock.held", 9.0, 11.0, 20, 20, site="translate"),
        span(22, "decode.translate", 9.0, 11.0, 21, 20, rows=1,
             rows_run=128, steps_run=128, row_steps_useful=10),
        span(30, "request", -5.0, -2.0, request=30, audio_s=120.0),
        span(31, "lock.held", -4.0, -3.0, 30, 30, site="translate"),
    ]


def train_spans():
    """Slice [0, 4]: two steps of four phases; the second optimizer has a
    child span over [3.6, 3.8]."""
    out = []
    for k, t in enumerate((0.0, 2.0)):
        root = 100 * (k + 1)
        out.append(span(root, "train.step", t, t + 2.0, step=k))
        for j, (name, a, b) in enumerate((
                ("step.gather", 0.0, 0.2), ("step.forward", 0.2, 0.8),
                ("step.backward", 0.8, 1.5), ("step.optimizer", 1.5, 2.0))):
            out.append(span(root + j + 1, name, t + a, t + b, root))
    out.append(span(300, "step.clip", 3.6, 3.8, 204))
    return out


@pytest.fixture
def spans(monkeypatch):
    def use(recorded):
        monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    return use


def serve_record():
    # Busy [0, 1], [2, 5], [7, 10]: idle [1, 2] and [5, 7].
    return H.Record(trace=H.DeviceTrace(
        [("k", 0.0, 1.0), ("k", 2.0, 4.0), ("Memcpy DtoH", 3.5, 5.0),
         ("k", 7.0, 10.5)], 0.0, 10.0))


def train_record():
    # Busy [0.1, 1.6], [1.9, 3.55], [3.7, 4]: idle [0, 0.1], [1.6, 1.9],
    # [3.55, 3.7].
    return H.Record(trace=H.DeviceTrace(
        [("k", 0.1, 1.6), ("k", 1.9, 3.55), ("k", 3.7, 4.2)], 0.0, 4.0))


def test_serving_readings_by_hand(spans):
    spans(serve_spans())
    rec = serve_record()
    # Requests 1 and 10: waits 1500 + 500 and 500 + 0 ms.
    assert rd(SERVE[0])(rec) == pytest.approx(1250.0)
    # Held 1000 + 500 and 1000 + 1000 ms.
    assert rd(SERVE[1])(rec) == pytest.approx(1750.0)
    # Translate 500 ms, summary 1000 ms.
    assert rd(SERVE[2])(rec) == pytest.approx(750.0)
    # Decodes that overlap the slice: requests 1, 10 and 20.
    assert rd(SERVE[3])(rec) == pytest.approx(
        100.0 * (40 + 50 + 10) / (128 * 128 + 192 + 128 * 128))
    # Held [0.5, 2.5], [3, 3.5], [6, 7], [9, 10] against idle [1, 2],
    # [5, 7]: 2 s of 10.
    assert rd(SERVE[4])(rec) == pytest.approx(20.0)


def test_training_readings_by_hand(spans):
    spans(train_spans())
    rec = train_record()
    # Optimizer: [1.6, 1.9] in step 0; in step 1 its own time is [3.5,
    # 3.6] and [3.8, 4], idle [3.55, 3.6]: 0.35 s over 2 steps.
    assert rd(TRAIN[0])(rec) == pytest.approx(175.0)
    # Gather [0, 0.2] holds idle [0, 0.1]: 0.1 s over 2 steps.
    assert rd(TRAIN[1])(rec) == pytest.approx(50.0)


def test_a_cell_s_spans_give_the_other_cell_s_readers_nothing(spans):
    spans(train_spans())
    for name in SERVE:
        assert rd(name)(train_record()) is None
    spans(serve_spans())
    for name in TRAIN:
        assert rd(name)(serve_record()) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_without_a_trace_or_spans(spans, monkeypatch, name):
    spans(serve_spans() + train_spans())
    assert rd(name)(H.Record()) is None
    spans([])
    rec = serve_record() if name in SERVE else train_record()
    assert rd(name)(rec) is None
    # A program without the recorder (the parent of the change that added
    # it): nothing, and no error.
    spans(serve_spans() + train_spans())
    monkeypatch.delattr(tracing, "spans")
    assert rd(name)(rec) is None
    monkeypatch.setitem(sys.modules, "omnilingual_asr_torch.utils.tracing",
                        None)
    assert rd(name)(rec) is None
