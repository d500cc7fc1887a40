"""BENCHMARK.json against its format rules, and every name in it resolved to
its files; what the benchmark's modules import."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import harness as H

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(SPEC["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines():
    named = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    for x in named:
        assert NAME.match(x["name"]), x["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[kind]]
        assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["why"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_by_name(cell):
    """The cell's configuration, traffic mix, generator, limits and every
    metric reader are files found by name; each per-layer metric's cell
    reports the end-to-end metric it moves."""
    c = H.resolve(SPEC, cell)
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    assert w["chips"] == 1
    assert (BENCH / "generators" / f"{c.traffic['generator']}.py").is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(H.metric_reader(m["name"]))
    assert set(c.limits) and all(isinstance(v, (int, float))
                                 for v in c.limits.values())


def test_configs():
    for c in SPEC["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        assert c["reduced"] == data["reduced"]
        assert all(not (k.endswith("_dim") or k.endswith("_rank")
                        or k in ("d_model", "n_heads", "ffn_mult"))
                   for k in c["reduced"])
        for k in ("d_model", "n_layers", "n_heads", "ffn_mult",
                  "conv_kernel"):
            assert data[k] == data["encoder"][k]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py")
            if "tests" not in p.relative_to(BENCH).parts]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    """Top-level names compare whole: the port, whose name begins with the
    JAX package's, is allowed."""
    assert not set(_imports(path)) & set(H.FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert "omnilingual_asr_torch" not in set(_imports(path))
    assert "benchmark" not in set(_imports(path)) or all(
        m.startswith("benchmark.reference") for m in _module_names(path)
        if m.startswith("benchmark"))


def _module_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Import):
            yield from (a.name for a in node.names)


def test_forbidden_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "omnilingual_asr_torch_fake",
                        types.ModuleType("x"))
    assert "omnilingual_asr" not in H.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "omnilingual_asr.engine",
                        types.ModuleType("x"))
    assert "omnilingual_asr" in H.forbidden_loaded()


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    """The printed line: the contract's keys, each of the cell's metrics
    for the run's kind, and the numbers compared under the last key."""
    from benchmark import run

    cell = H.resolve(SPEC, "d512_train_b64")
    rec = H.Record(end_to_end={m["name"]: 1.0 for m in cell.end_to_end},
                   attempted=3, checks=[H.Check("loss_gap", 1e-5, 1e-3)],
                   facts={"useful_flops": 1e12, "window_s": 2.0},
                   trace=H.DeviceTrace([("k", 0.0, 0.5)], 0.0, 1.0)
                   if trace else None,
                   device={"memory_peak_bytes": 1})
    line = run.result_line(cell, rec, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) \
        + ["compared"]
    assert line["correct"] is True
    assert line["compared"] == {"loss_gap": {"value": 1e-5, "limit": 1e-3}}
    if trace:
        assert line["device"]["busy_s"] == pytest.approx(0.5)
        assert line["device"]["window_s"] == pytest.approx(1.0)
        assert set(line["metrics"]) == {"device_idle_share.train",
                                        "mfu.train"}
    else:
        assert set(line["metrics"]) == {"train_audio_s_per_s", "setup_s"}


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_pipeline_config(config):
    """Each configuration file builds the port's PipelineConfig with its
    widths; the release names its ASR weights by path."""
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    pc = H.pipeline_config(data)
    assert pc.encoder.d_model == data["d_model"]
    assert pc.encoder.n_layers == data["n_layers"]
    assert pc.frontend.n_mels == data["frontend"]["n_mels"]
    if isinstance(data.get("weights"), dict):
        assert (ROOT / data["weights"]["asr"]).is_file()
        assert pc.checkpoint_path == str(ROOT / data["weights"]["asr"])


def test_setup_phases_are_seconds_since_start():
    import time

    ph = H.Phases(t_start=time.time() - 2.0)
    ph.mark("b")
    assert 2.0 <= ph.marks["b"] < 7.0
