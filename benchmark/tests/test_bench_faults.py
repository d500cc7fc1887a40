"""The rest of a run, with the timed path broken underneath, comes out
not correct under the committed limits: on the CPU, at small sizes (the
look for a card is the command's, which these tests skip). Each fault a
cell can have: a training step that returns its state unchanged; half of
the batch left out, the mean taken over the rest; a served token altered
where it is produced. Both cells run on one card, so no exchange between
cards can be left out."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness as H

SPEC = H.load_spec()


def train_cell():
    cell = H.resolve(SPEC, "d512_train_b64")
    cell.config["encoder"].update(d_model=64, n_layers=2, n_heads=2,
                                  conv_kernel=8)
    cell.traffic.update(batch=4, row_seconds=2, pool_rows=16,
                        label_bytes=[10, 20])
    return cell


def train_run(**kw):
    return H.generator("train_pool").run(train_cell(), seed=2**31 + 3,
                                      seconds=0.5, trace=False,
                                      t_start=time.time(), device="cpu", **kw)


def test_train_step_that_returns_its_state_unchanged(monkeypatch):
    from omnilingual_asr_torch.train import step

    monkeypatch.setattr(step.Optimizer, "update",
                        lambda self, state, grads, counted=None: None)
    rec = train_run()
    assert not rec.correct
    assert {c.name for c in rec.checks if not c.ok} >= {"change_gap"}


def test_train_half_the_batch_left_out():
    from benchmark.readings import half_batch

    rec = train_run(fault=half_batch)
    assert not rec.correct


def serve_cell():
    cell = H.resolve(SPEC, "release_translate_2min")
    cell.traffic.update(clients=1, file_seconds=8, n_files=1,
                        warmup_requests_per_client=1, check_requests=1)
    return cell


def serve_run():
    return H.generator("serve_closed_loop").run(
        serve_cell(), seed=2**31 + 5, seconds=0.5, trace=False,
        t_start=time.time(), device="cpu")


def test_serve_ctc_token_altered(monkeypatch):
    from omnilingual_asr_torch.engine import TranscriptionEngine

    orig = TranscriptionEngine._process

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        ids = out["ctc_ids"].clone()
        ids[:, 5::40] = (ids[:, 5::40] + 97) % 257
        return {**out, "ctc_ids": ids}

    monkeypatch.setattr(TranscriptionEngine, "_process", altered)
    rec = serve_run()
    assert not rec.correct
    assert [c.name for c in rec.checks if not c.ok] == ["ctc_mean_gap"]


def test_serve_translation_token_altered(monkeypatch):
    from omnilingual_asr_torch.models.translation import GreedyDecoder

    orig = GreedyDecoder.translate_text

    def altered(self, tokens, mask, max_len=128):
        out = orig(self, tokens, mask, max_len=max_len).clone()
        out[:, 1] = (out[:, 1] + 40) % 256 + 1
        return out

    monkeypatch.setattr(GreedyDecoder, "translate_text", altered)
    rec = serve_run()
    assert not rec.correct
    assert [c.name for c in rec.checks if not c.ok] == ["decoder_gap"]
