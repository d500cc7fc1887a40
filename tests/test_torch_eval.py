"""PyTorch port: the evaluation layer (``omnilingual_asr_torch/eval/`` and
``train/summary_train.py``'s data half) against the JAX package's
``eval/`` modules and the root ``eval_*.py`` drivers.

- The manifest functions, ``load_manifest`` and ``evaluate`` equal the JAX
  package's on the same inputs; the drivers' scoring equals the JAX
  drivers' with each package's ``FakeEngine``.
- The generated data (the synthetic manifest's WAVs, the conversations, the
  long file, the latency audio) equal the JAX package's bit for bit.
- Each driver on the CPU (``--device cpu --tiny``) prints the JAX driver's
  keys, less its 8-chip projection; without ``--device cpu`` it fails on a
  machine with no card.
- The drivers with the release weights on the CPU hold to the JAX
  package's ``testdata/golden_evals.json`` on the subset that
  ``tests/test_torch_golden.py`` regenerates: the first 4 synthetic files,
  the first conversation and the 420 s file.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import signal
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from omnilingual_asr_torch import testing as golden  # noqa: E402

torch.set_num_threads(2)

RELEASE = REPO / "checkpoints" / "release"
#: The JAX long-file driver's 8-chip projection (TPU data parallelism),
#: which the port leaves out, and the keys the port adds in its place.
PROJECTION_KEYS = {"projected_8chip_s", "projection_model",
                   "batch_imbalance_8", "virtual_mesh_cpu_overhead_8",
                   "host_floor_s"}
PORT_LONG_KEYS = {"peak_rss_gb", "rss_before_gb", "device_peak_gb"}


def _wav(path: Path, seconds: float = 1.0, seed: int = 0) -> None:
    from omnilingual_asr_torch.eval.synth import write_wav

    rng = np.random.default_rng(seed)
    write_wav(path, 0.1 * rng.standard_normal(int(seconds * 16000)))


# ---------------------------------------------------------------------------
# Manifests and the harness
# ---------------------------------------------------------------------------

def _fleurs(root: Path) -> tuple:
    d = root / "en_us"
    (d / "audio" / "test").mkdir(parents=True)
    rows = [["1", "a.wav", "Raw One", "raw one", "x", "16000", "MALE"],
            ["2", "b", "Two  ", "two words ", "x", "16000", "FEMALE"],
            ["3", "short"]]
    with open(d / "test.tsv", "w", newline="", encoding="utf-8") as f:
        csv.writer(f, delimiter="\t").writerows(rows)
    return ("fleurs_manifest", (root, "en_us", "test"),
            ["fleurs", "--root", str(root), "--lang", "en_us"])


def _commonvoice(root: Path) -> tuple:
    root.mkdir(parents=True)
    with open(root / "test.tsv", "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["client_id", "path", "sentence", "locale"])
        w.writerow(["c", "x.mp3", "Hola mundo", "es"])
        w.writerow(["c", "y.mp3", "  ", "es"])
        w.writerow(["c", "z.mp3", "Ünïcödé text", "ka"])
        w.writerow(["c", "w.mp3", "no locale", ""])
    return ("commonvoice_manifest", (root, "test"),
            ["commonvoice", "--root", str(root)])


def _librispeech(root: Path) -> tuple:
    for spk, chap, lines in (("19", "198", ["19-198-0000 HELLO WORLD",
                                            "19-198-0001 SECOND LINE"]),
                             ("84", "121", ["84-121-0000 THIRD ONE",
                                            "bad"])):
        d = root / "test-clean" / spk / chap
        d.mkdir(parents=True)
        (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    return ("librispeech_manifest", (root, "test-clean"),
            ["librispeech", "--root", str(root), "--split", "test-clean"])


@pytest.mark.parametrize("layout", [_fleurs, _commonvoice, _librispeech],
                         ids=["fleurs", "commonvoice", "librispeech"])
def test_manifests_equal_jax(tmp_path, layout):
    """Items, ``write_manifest``'s bytes and the CLI equal the JAX
    package's on a corpus layout written here."""
    from omnilingual_asr_torch.eval import manifests as port
    from omnilingual_asr_tpu.eval import manifests as ref

    fn, args, argv = layout(tmp_path / "corpus")
    items = getattr(port, fn)(*args)
    assert items and items == getattr(ref, fn)(*args)
    assert port.write_manifest(items, tmp_path / "p.jsonl") == \
        ref.write_manifest(items, tmp_path / "j.jsonl") == len(items)
    assert (tmp_path / "p.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    outs = []
    for mod, name in ((port, "pc.jsonl"), (ref, "jc.jsonl")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _jax_main(mod, [*argv, "--out", str(tmp_path / name)])
        outs.append((buf.getvalue().split(" -> ")[0],
                     (tmp_path / name).read_bytes()))
    assert outs[0] == outs[1]
    for code in ("en_us", "cmn_hans_cn", "ka", "sw", "zz", "xx_yy"):
        assert port._lang_name(code) == ref._lang_name(code)


def _jax_main(module, argv):
    """``module.main()`` reading ``argv`` from ``sys.argv``."""
    with mock.patch.object(sys, "argv", [str(module.__name__), *argv]):
        module.main()


def _manifest_with_turns(tmp_path: Path) -> Path:
    (tmp_path / "audio").mkdir()
    for i in range(3):
        _wav(tmp_path / "audio" / f"f{i}.wav", 1.0 + i, seed=i)
    lines = [
        {"audio": "audio/f0.wav", "text": "Good morning hello everyone",
         "language": "Lisu"},
        {"audio": str(tmp_path / "audio" / "f1.wav"),
         "text": "thanks for joining", "turns": [[0.0, 3.0, "A"],
                                                 [3.4, 6.0, "B"]]},
        {"audio": "audio/f2.wav", "text": "", "turns": [[0.0, 6.0, "A"]]},
    ]
    m = tmp_path / "manifest.jsonl"
    m.write_text("\n" + "\n".join(json.dumps(x) for x in lines) + "\n\n")
    return m


def test_load_manifest_and_evaluate_equal_jax(tmp_path):
    """``load_manifest`` resolves relative paths as the JAX harness does,
    and ``evaluate`` over each package's ``FakeEngine`` gives the same
    report and per-file rows (DER included; the wall clock aside)."""
    from omnilingual_asr_torch.eval import harness as port
    from omnilingual_asr_torch.testing import FakeEngine
    from omnilingual_asr_tpu.eval import harness as ref
    from omnilingual_asr_tpu.testing import FakeEngine as JaxFakeEngine

    m = _manifest_with_turns(tmp_path)
    assert port.load_manifest(m) == ref.load_manifest(m)
    for limit in (None, 2):
        got = port.evaluate(FakeEngine(), m, limit=limit)
        want = ref.evaluate(JaxFakeEngine(), m, limit=limit)
        strip = lambda rows: [{k: v for k, v in r.items() if k != "seconds"}
                              for r in rows]
        assert strip(got.per_file) == strip(want.per_file)
        for key in ("wer", "cer", "n_files", "n_ref_words", "der_mean"):
            assert getattr(got, key) == getattr(want, key), key
        assert json.loads(got.to_json()).keys() == \
            json.loads(want.to_json()).keys()
    assert port.evaluate(FakeEngine(), m).der_mean is not None
    assert "der" in port.evaluate(FakeEngine(), m, limit=2).per_file[1]


# ---------------------------------------------------------------------------
# Generated data, bit for bit
# ---------------------------------------------------------------------------

def test_build_manifest_equals_jax(tmp_path):
    import eval_synth

    from omnilingual_asr_torch.eval.synth import build_manifest, write_wav

    got = build_manifest(tmp_path / "port", 3, include_real=True)
    want = eval_synth.build_manifest(tmp_path / "jax", 3, include_real=True)
    assert got.read_bytes() == want.read_bytes()
    names = sorted(p.name for p in got.parent.glob("*.wav"))
    assert len(names) == 3
    for name in names:
        assert (got.parent / name).read_bytes() == \
            (want.parent / name).read_bytes()
    x = np.linspace(-1.5, 1.5, 777).astype(np.float32)
    write_wav(tmp_path / "a.wav", x, sr=8000)
    eval_synth.write_wav(tmp_path / "b.wav", x, sr=8000)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "b.wav").read_bytes()


def test_diar_conversation_equals_jax(tmp_path):
    import eval_diar

    from omnilingual_asr_torch.eval.diar import (make_conversation,
                                                 write_conversation)

    for n_spk, n_turns in ((3, 4), (2, 3)):
        got = make_conversation(np.random.default_rng(n_spk), n_spk, n_turns)
        want = eval_diar.make_conversation(np.random.default_rng(n_spk),
                                           n_spk, n_turns)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
    write_conversation(str(tmp_path / "c.wav"), got[0])
    ref = (want[0] * 32767).astype("<i2").tobytes()
    assert (tmp_path / "c.wav").read_bytes()[44:] == ref


def test_summary_conversations_equal_jax():
    from omnilingual_asr_torch.train import summary_train as port
    from omnilingual_asr_tpu.train import summary_train as ref

    pools = [m.build_utterance_pool(np.random.default_rng(77_000), 10)
             for m in (port, ref)]
    for a, b in zip(*pools):
        assert {k: v for k, v in a.items() if k != "samples"} == \
            {k: v for k, v in b.items() if k != "samples"}
        np.testing.assert_array_equal(a["samples"], b["samples"])
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    for _ in range(3):
        (xa, fa), (xb, fb) = (m.make_conversation(r, p) for m, r, p in
                              zip((port, ref), rngs, pools))
        assert fa == fb
        assert xa.dtype == xb.dtype == np.float32
        np.testing.assert_array_equal(xa, xb)
    before = signal.getsignal(signal.SIGTERM)   # main installs its own
    try:
        with pytest.raises(SystemExit) as refused:  # argparse: --ckpt, --out
            port.main([])
    finally:
        signal.signal(signal.SIGTERM, before)
    assert refused.value.code == 2


def test_long_audio_and_latency_audio_equal_jax(tmp_path):
    import bench
    import eval_long

    from omnilingual_asr_torch.eval.latency import make_audio
    from omnilingual_asr_torch.eval.long import make_long_audio

    # 60 s is one writer chunk; 61.5 s adds a partial second chunk
    for seconds in (60.0, 61.5):
        got = make_long_audio(seconds, tmp_path / "p.wav")
        want = eval_long.make_long_audio(seconds, path=str(tmp_path / "j.wav"))
        assert Path(got).read_bytes() == Path(want).read_bytes()
    make_audio(tmp_path / "pl.wav", 3.3)
    bench.make_audio(tmp_path / "jl.wav", 3.3)
    assert (tmp_path / "pl.wav").read_bytes() == \
        (tmp_path / "jl.wav").read_bytes()


# ---------------------------------------------------------------------------
# The drivers' scoring and keys against the JAX drivers'
# ---------------------------------------------------------------------------

def _jax_fake_class():
    """A JAX-package ``FakeEngine`` taking any engine keywords, with the
    attributes ``eval_long.py`` reads."""
    from types import SimpleNamespace

    from omnilingual_asr_tpu.testing import FakeEngine

    class Fake(FakeEngine):
        window_samples = 480_000
        batch_size = 1
        last_trace = None
        mesh = SimpleNamespace(devices=np.zeros(1))

        def __init__(self, *args, **kwargs):
            super().__init__()

    return Fake


def _jax_driver_json(name: str, argv, tmp_path: Path) -> dict:
    """A root ``eval_<name>.py``'s JSON line with the JAX package's
    ``FakeEngine`` as its engine (its audio writers redirected into
    ``tmp_path``; the fake reads no audio)."""
    import importlib

    import jax
    import omnilingual_asr_tpu.engine as jengine

    module = importlib.import_module(f"eval_{name}")
    patches = [mock.patch.object(jengine, "TranscriptionEngine",
                                 _jax_fake_class()),
               mock.patch.object(jax.config, "update", lambda *a: None)]
    if name == "long":
        real = module.make_long_audio
        patches.append(mock.patch.object(
            module, "make_long_audio",
            lambda s, sr=16000, path="long.wav": real(
                s, sr, str(tmp_path / Path(path).name))))
    if name == "latency":
        patches.append(mock.patch.object(module, "make_audio",
                                         lambda *a, **k: None))
    if name == "diar":
        # its conversations go to fixed /tmp names, which the JAX driver's
        # regeneration in tests/test_torch_golden.py reads in another
        # worker: write (and remove) them under tmp_path instead
        import os
        import wave

        def here(path):
            return str(tmp_path / Path(path).name)

        real_open, real_unlink = wave.open, os.unlink
        patches += [
            mock.patch.object(wave, "open",
                              lambda f, mode=None: real_open(here(f), mode)),
            mock.patch.object(os, "unlink", lambda f: real_unlink(here(f)))]
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(buf))
        _jax_main(module, argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _port_main_json(name: str, argv, capsys) -> dict:
    import importlib

    module = importlib.import_module(f"omnilingual_asr_torch.eval.{name}")
    capsys.readouterr()
    module.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_synth_scoring_equals_jax_driver(tmp_path):
    """``evaluate_sets`` over the port's ``FakeEngine`` gives eval_synth's
    numbers over the JAX package's (the wall-clock RTF aside)."""
    from omnilingual_asr_torch.eval.synth import (build_manifest,
                                                  evaluate_sets)
    from omnilingual_asr_torch.testing import FakeEngine

    want = _jax_driver_json("synth", ["--n", "3", "--out",
                                      str(tmp_path / "j")], tmp_path)
    out = tmp_path / "p"
    got, reports = evaluate_sets(FakeEngine(),
                                 build_manifest(out, 3, include_real=True),
                                 out)
    for d in (got, want):
        for v in d.values():
            v.pop("rtf")
    assert got == want and set(reports) == set(got)


@pytest.mark.parametrize("argv", [[], ["--translator", "t.npz",
                                       "--summarizer", "s.npz"]],
                         ids=["heads", "decoders"])
def test_heads_scoring_equals_jax_driver(tmp_path, argv):
    """``evaluate_heads`` over the port's ``FakeEngine`` gives eval_heads'
    report over the JAX package's: LID and emotion by duration-weighted
    majority, the confusions, translation word accuracy and the summary
    accuracies on the composed conversations."""
    from omnilingual_asr_torch.eval.heads import evaluate_heads
    from omnilingual_asr_torch.testing import FakeEngine

    want = _jax_driver_json("heads", ["--n", "3", "--out",
                                      str(tmp_path / "j"), *argv], tmp_path)
    got, rows = evaluate_heads(FakeEngine(), 3, tmp_path / "p",
                               translate=bool(argv), summarize=bool(argv))
    assert got == want
    assert len(rows["files"]) == 3
    assert len(rows["conversations"]) == (4 if argv else 0)


@pytest.mark.parametrize("argv", [[], ["--th", "0.3,0.5", "--count-mode",
                                       "eigengap", "--resegment",
                                       "--spk-wire", "i8",
                                       "--spk-stride", "2"]],
                         ids=["default", "sweep"])
def test_diar_scoring_equals_jax_driver(tmp_path, argv):
    """``diar_report`` over the port's ``FakeEngine`` gives eval_diar's
    report, the sweep's keys included; each flag reaches its
    ``DecodeConfig`` field."""
    import dataclasses

    from omnilingual_asr_torch.config import tiny_config
    from omnilingual_asr_torch.eval.diar import diar_report
    from omnilingual_asr_torch.testing import FakeEngine

    want = _jax_driver_json("diar", ["--n", "2", *argv], tmp_path)
    configs = []

    def make_engine(cfg):
        configs.append(cfg)
        return FakeEngine()

    ths = [0.3, 0.5] if argv else None
    got, segments = diar_report(
        make_engine, tiny_config(), 2, 123, ths,
        "eigengap" if argv else None, bool(argv), "i8" if argv else None,
        2 if argv else None)
    assert got == want
    assert len(segments) == 2
    if argv:
        assert [c.decode.ahc_threshold for c in configs] == ths
        dec = dataclasses.asdict(configs[0].decode)
        assert (dec["count_mode"], dec["resegment"], dec["spk_wire"],
                dec["spk_frame_stride"]) == ("eigengap", True, "i8", 2)
    else:
        assert configs == [tiny_config()]


DRIVERS = {
    "synth": ["--n", "2"],
    "heads": ["--n", "2"],
    "diar": ["--n", "2"],
    "long": ["--hours", "0.02"],
    "latency": ["--reps", "2"],
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_cpu_run_prints_the_jax_keys(tmp_path, capsys, name):
    """``python -m omnilingual_asr_torch.eval.<name> --device cpu --tiny``
    prints one JSON line with the JAX driver's keys (the long-file
    driver's projection out, its memory peaks in)."""
    argv = list(DRIVERS[name])
    if name in ("synth", "heads"):
        argv += ["--out", str(tmp_path / "p")]
    got = _port_main_json(name, [*argv, "--device", "cpu", "--tiny"], capsys)
    jargv = [a if a != str(tmp_path / "p") else str(tmp_path / "j")
             for a in argv]
    want = _jax_driver_json(name, jargv + ["--tiny"], tmp_path)
    keys = set(want) - PROJECTION_KEYS
    if name == "long":
        keys |= PORT_LONG_KEYS
        assert got["backend"] == "cpu" and got["n_chips"] == 1
        assert got["device_peak_gb"] is None
        assert got["peak_rss_gb"] > 0 and got["rss_before_gb"] > 0
    assert set(got) == keys
    if name == "synth":
        assert {k: set(v) for k, v in got.items()} == \
            {k: set(v) for k, v in want.items()}
    if name == "latency":
        assert got["model"] == {"d_model": 128, "n_layers": 2}
        assert got["weights"] == "random" and got["reps"] == 2


def test_harness_cpu_run_prints_the_jax_keys(tmp_path, capsys):
    from omnilingual_asr_torch.eval.synth import build_manifest
    from omnilingual_asr_tpu.eval import harness as ref

    m = build_manifest(tmp_path, 2, include_real=False)
    got = _port_main_json("harness", [str(m), "--limit", "1", "--device",
                                      "cpu", "--tiny"], capsys)
    buf = io.StringIO()
    with mock.patch("omnilingual_asr_tpu.engine.TranscriptionEngine",
                    _jax_fake_class()), contextlib.redirect_stdout(buf):
        _jax_main(ref, [str(m), "--limit", "1"])
    want = json.loads(buf.getvalue())
    assert set(got) == set(want) and got["n_files"] == want["n_files"] == 1


@pytest.mark.parametrize("name", ["harness", *sorted(DRIVERS)])
def test_driver_without_device_needs_the_card(tmp_path, name):
    """Without ``--device cpu`` a driver runs on the card, and on a machine
    without one it fails before any work: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import importlib

    module = importlib.import_module(f"omnilingual_asr_torch.eval.{name}")
    argv = ([str(tmp_path / "absent.jsonl")] if name == "harness"
            else [*DRIVERS[name], "--tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv)
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# The release weights on the CPU against the JAX fixture's subset
# ---------------------------------------------------------------------------

def _release_engine(**kwargs):
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine

    cfg = PipelineConfig.from_json(
        (RELEASE / "config.json").read_text(),
        checkpoint_path=str(RELEASE / "asr.npz"))
    return TranscriptionEngine(config=cfg, device="cpu",
                               xvector_path=str(RELEASE / "xvector.npz"),
                               **kwargs)


def test_port_cpu_synth_matches_golden_evals(tmp_path):
    """The first 4 files of eval_synth's corpus at 10 s windows: texts and
    greedy ids by the fixture's criterion (``testing.synth_mismatches``);
    the 10 s window takes the flash path at T' 256, as the JAX engine."""
    from omnilingual_asr_torch.eval.synth import build_manifest, \
        evaluate_sets

    stored = golden.load_golden_evals()["synth"]
    eng = _release_engine(window_seconds=stored["window_seconds"])
    assert eng.window_frames == 1024
    assert eng.infer_config.encoder.use_flash_attention
    manifest = build_manifest(tmp_path, 4, include_real=True)
    with golden.recorded_ctc_ids(eng) as ids:
        _, reports = evaluate_sets(eng, manifest, tmp_path)
    hyps = [r["hyp"] for r in reports["synth"].per_file]
    assert [Path(r["audio"]).name for r in reports["synth"].per_file] == \
        [f["audio"] for f in stored["files"][:4]]
    assert golden.synth_mismatches(stored, hyps, ids) == []


def test_port_cpu_diar_matches_golden_evals():
    """eval_diar's first conversation: speaker count, DER within the
    fixture's tolerance, and the segments' speakers and times."""
    from omnilingual_asr_torch.eval.diar import diar_report

    stored = golden.load_golden_evals()["diar"]
    cfg = _release_engine().config
    report, segments = diar_report(
        lambda c: _release_engine(batch_windows_per_device=4), cfg, 1,
        stored["seed"])
    assert golden.diar_mismatches(stored, report["details"]) == []
    want = stored["segments"][0]
    assert [s[2] for s in segments[0]] == [s[2] for s in want]
    np.testing.assert_allclose([s[:2] for s in segments[0]],
                               [s[:2] for s in want], atol=golden.TIME_TOL_S)


def test_port_cpu_long_matches_golden_evals(tmp_path):
    """The 420 s file through eval_long's batch of 8 windows takes the
    streamed-WAV path; its windows' greedy ids and its result's structure
    hold to the JAX engine's (``testing.long_mismatches``)."""
    from omnilingual_asr_torch.eval.long import long_report, make_long_audio

    stored = golden.load_golden_evals()["long"]
    eng = _release_engine(batch_windows_per_device=stored["batch_windows"])
    path = make_long_audio(stored["seconds"], tmp_path / "long.wav")
    with golden.recorded_ctc_ids(eng) as ids:
        report, result = long_report(eng, path, stored["seconds"],
                                     stored["seconds"] / 3600)
    assert golden.long_mismatches(stored, result.to_dict(),
                                  report["stages_s"], ids[0]) == []
