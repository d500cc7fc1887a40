"""PyTorch port: the d512 fixture (``golden_d512_crop.json``: the JAX
engine with ``checkpoints/r5_d512x12_seed`` in crop mode, greedy and with
the beam search, on the golden file and its 120 s tiling) held to its
margins, and the port's CPU engine held to it. ``tests/test_torch_golden.py``
regenerates it (``python tests/test_torch_golden.py d512_crop``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from test_torch_golden import (D512, D512_BEAM, REPO, check_d512_margins,
                               d512_paths)

torch.set_num_threads(2)


def test_golden_d512_has_margin():
    """``golden_d512_crop.json`` is the d512 seed's crop-mode result with
    enough stable beam decodes and crop re-embedding in use."""
    stored = golden.load_golden_d512()
    assert stored["checkpoint"] == str(D512.relative_to(REPO))
    assert stored["beam"] == D512_BEAM and stored["speaker_mode"] == "crop"
    check_d512_margins(stored)
    tiled = stored["files"]["tiled"]["greedy"]["result"]
    assert len({s["speaker"] for s in tiled["segments"]}) >= 2


@pytest.fixture(scope="module")
def d512_port(tmp_path_factory):
    """The fixture's files and the port's d512 crop engines on the CPU,
    greedy and with the beam search."""
    from omnilingual_asr_torch.config import config_for_checkpoint
    from omnilingual_asr_torch.engine import TranscriptionEngine

    paths = d512_paths(tmp_path_factory.mktemp("d512"))
    base = config_for_checkpoint(str(D512))
    beam = base.replace(decode=dataclasses.replace(base.decode, **D512_BEAM))
    engines = {mode: TranscriptionEngine(config=cfg, device="cpu",
                                         speaker_mode="crop")
               for mode, cfg in (("greedy", base), ("beam", beam))}
    return paths, engines


def test_port_beam_search_on_jax_feed_equals_d512(d512_port):
    """Given the JAX engine's top-K feed (``golden_d512_crop_topk.npz``),
    the port's beam search with the synth lexicon returns the JAX text of
    every decode, stable or not."""
    _, engines = d512_port
    eng = engines["beam"]
    feed = np.load(golden.GOLDEN_D512_FEED)
    n = 0
    for name, f in golden.load_golden_d512()["files"].items():
        for d in f["beam"]["decodes"]:
            topk = (feed[f"{name}/{d['window']}/lp"],
                    feed[f"{name}/{d['window']}/ids"])
            assert eng._beam_text(topk, d["f0"], d["f1"]) == d["text"]
            n += 1
    assert n >= 10


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_port_cpu_matches_golden_d512(d512_port, mode):
    """The port's d512 crop engine on the CPU, on the golden and the tiled
    file, held to the fixture (``testing.d512_mismatches``); the tiled
    request re-embeds its segments; with the beam search, its top-K feed
    is held to the JAX engine's (``testing.d512_feed_mismatches``) and
    the stable decodes' texts are exact."""
    paths, engines = d512_port
    eng = engines[mode]
    results, ids, feeds, crops = {}, {}, {}, []
    crop, extract = eng._segment_crop_embeds, eng._extract_windows

    def rec_extract(outs, *parts):     # the request's own ids and feed
        ids[name].extend(o["ctc_ids"].astype(int).tolist() for o in outs)
        feeds[name].extend(o["ctc_topk"] for o in outs
                           if o["ctc_topk"] is not None)
        return extract(outs, *parts)

    eng._segment_crop_embeds = lambda *a: crops.append(1) or crop(*a)
    eng._extract_windows = rec_extract
    try:
        for name, path in paths.items():
            ids[name], feeds[name] = [], []
            results[name] = eng.transcribe(path).to_dict()
    finally:
        del eng._segment_crop_embeds, eng._extract_windows
    assert crops == [1]
    assert golden.d512_mismatches(mode, results, ids) == []
    if mode == "beam":
        assert golden.d512_feed_mismatches(feeds) == []
        texts = golden.d512_beam_texts(results)
        n_stable = sum(d["stable"] for f in golden.load_golden_d512()[
            "files"].values() for d in f["beam"]["decodes"])
        assert texts["stable"] == f"{n_stable} of {n_stable}"
