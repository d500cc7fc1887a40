"""PyTorch port: the evaluation fixture (``golden_evals.json`` with
``golden_evals_ids.npz``: the JAX package's evaluation drivers with the
release weights) regenerated in part on the CPU and held current, its
content, and the long file's criterion under the JAX engine's own noise.
``tests/test_torch_eval.py`` holds the port's drivers to it;
``tests/test_torch_golden.py`` regenerates it
(``python tests/test_torch_golden.py evals``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from test_torch_golden import (EVALS, EVALS_SUBSET, LONG_PERTURB_SEEDS,
                               jax_golden_evals)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def evals_regenerated(tmp_path_factory):
    folder = tmp_path_factory.mktemp("evals")
    return jax_golden_evals(folder, heads_n=None, perturb=False,
                            **EVALS_SUBSET)


def test_golden_evals_is_current(evals_regenerated):
    """golden_evals.json on the subset that tier-1 regenerates (the first
    4 synthetic files, the first conversation, the 420 s file) equals a
    fresh JAX run: texts and ids exactly, the conversation's speaker count,
    DER and segments, the long result by the golden criterion and its
    greedy ids exactly."""
    stored = golden.load_golden_evals()
    fresh, ids = evals_regenerated
    got = fresh["synth"]["files"]
    assert [f["hyp"] for f in got] == \
        [f["hyp"] for f in stored["synth"]["files"][:len(got)]]
    for i, f in enumerate(stored["synth"]["files"][:len(got)]):
        assert f["ctc_ids"] == [ids[f"synth/{i}/{w}"].tolist()
                                for w in range(got[i]["n_windows"])]
    assert stored["long"]["ctc_ids"] == [
        ids[f"long/{w}"].tolist() for w in range(fresh["long"]["n_windows"])]
    want_diar = stored["diar"]
    det = fresh["diar"]["report"]["details"]
    assert det == want_diar["report"]["details"][:len(det)]
    for w, g in zip(want_diar["segments"], fresh["diar"]["segments"]):
        assert [x[2] for x in g] == [x[2] for x in w]
        np.testing.assert_allclose([x[:2] for x in g], [x[:2] for x in w],
                                   atol=golden.TIME_TOL_S)
    assert golden.result_mismatches(
        stored["long"]["result"], fresh["long"]["result"],
        tone_mass=stored["long"]["tone_mass"]) == []


def test_golden_evals_have_content():
    """The fixture is the full battery: 96 synthetic files, 64 heads files
    with translations and 8 conversations, 16 conversations, a 420 s file
    of many segments; and its numbers are the drivers' own."""
    stored = golden.load_golden_evals()
    synth = stored["synth"]
    assert len(synth["files"]) == EVALS["synth_n"]
    assert all(f["n_windows"] == 1 and f["ctc_ids"][0] for f in
               synth["files"])
    heads = stored["heads"]
    assert heads["report"]["n_files"] == len(
        [f for f in heads["files"] if f is not None]) == EVALS["heads_n"]
    assert heads["report"]["summary_n_conversations"] == \
        len(heads["conversations"]) == EVALS["heads_n"] // 8
    assert sum("translation" in f for f in heads["files"]) >= 32
    diar = stored["diar"]
    assert len(diar["report"]["details"]) == len(diar["segments"]) == \
        EVALS["diar_n"]
    assert abs(diar["der_mean"] - diar["report"]["value"]) < 1e-4
    long = stored["long"]
    assert long["n_segments"] >= 50 and long["n_windows"] == 14
    assert golden.ctc_agreement(long["ctc_ids"], long["ctc_ids"]) == 1.0


def test_golden_evals_long_criterion_admits_the_reference_under_noise():
    """The long file's rule (``testing.LONG_*``) admits the JAX engine's
    own results on 1-LSB perturbations of the file, and those results are
    not the reference's: the exact criterion would not be a fair check of
    a second implementation there."""
    perturbed = golden.load_golden_evals()["long"]["perturbed"]
    assert len(perturbed) == len(LONG_PERTURB_SEEDS)
    for a in perturbed:
        assert a["der"] <= golden.LONG_MAX_DER
        assert a["cer"] <= golden.LONG_MAX_CER
        assert a["segment_match"] >= golden.LONG_MIN_SEGMENT_MATCH
        assert abs(a["n_speakers"][0] - a["n_speakers"][1]) <= 1
    assert all(a["cer"] > 0 and a["n_segments"][1] != a["n_segments"][0]
               for a in perturbed)
