"""PyTorch port: import hygiene. The port and ``chip_smoke.py`` run on a
machine without JAX, so neither may import JAX or the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "omnilingual_asr_torch"
FORBIDDEN = ("jax", "jaxlib", "omnilingual_asr_tpu", "omnilingual_asr",
             "optax", "orbax", "flax", "tensorstore", "zstandard")
#: The repository's root scripts (the JAX package's drivers and bench):
#: the port keeps its own copy of what it needs from them.
ROOT_SCRIPTS = tuple(sorted(p.stem for p in REPO.glob("*.py")
                            if p.name != "chip_smoke.py"))

_HOOK = """
import sys
FORBIDDEN = {forbidden!r}

def _bad(name):
    return name.split('.')[0] in FORBIDDEN

for m in [m for m in sys.modules if _bad(m)]:
    del sys.modules[m]

class Block:
    def find_spec(self, name, path=None, target=None):
        if _bad(name):
            raise ImportError('forbidden import: ' + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
import importlib, pkgutil
import omnilingual_asr_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               'omnilingual_asr_torch.')]
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = sorted(m for m in sys.modules if _bad(m))
assert not leaked, leaked
print(len(names))
"""


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_with_jax_blocked():
    code = _HOOK.format(forbidden=FORBIDDEN, repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statements(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative: stays inside the package
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN + ROOT_SCRIPTS, (
                f"{path.name}:{node.lineno} imports {n}")


def test_walk_reaches_the_server_exporters_and_native_loader():
    """The import walk above covers the server, the exporters and the
    native decoder's loader (and so holds them to the rule)."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("serving", "serving.app", "serving.auth", "serving.history",
                 "serving.http_kit", "serving.schema", "exporters",
                 "exporters.formats", "audio.native_lib"):
        assert f"omnilingual_asr_torch.{name}" in names


def test_walk_reaches_the_beam_search_and_the_codec():
    """The import walk covers the beam search, the lexicon LM, the English
    sentence bank and the μ-law codec (and so holds them to the rule)."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("ops.beam", "ops.lexicon", "train.english_text",
                 "audio.codec"):
        assert f"omnilingual_asr_torch.{name}" in names


def test_walk_reaches_the_eval_layer():
    """The import walk covers the evaluation layer and the summary
    trainer's data half (and so holds them to the rule); the root scripts
    they were ported from are among the names no port module imports."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("eval.harness", "eval.manifests", "eval.synth",
                 "eval.heads", "eval.diar", "eval.long", "eval.latency",
                 "train.summary_train"):
        assert f"omnilingual_asr_torch.{name}" in names
    assert {"bench", "eval_synth", "eval_heads", "eval_diar", "eval_long",
            "eval_latency"} <= set(ROOT_SCRIPTS)


def test_walk_reaches_the_trainers():
    """The import walk covers the release's trainers, the real-pair corpus,
    the SIGTERM exit and the watchdog (and so holds them to the rule)."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("train.xvector_train", "train.text_translator_train",
                 "train.translator_train", "train.summary_train",
                 "train.real_pairs", "utils.term", "utils.watchdog"):
        assert f"omnilingual_asr_torch.{name}" in names


def test_walk_reaches_the_rest_of_training():
    """The import walk covers BEST-RQ pretraining and its CLI, the manifest
    loader and CLI, the device pool and the AED family (and so holds them
    to the rule)."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("train.pretrain", "train.pretrain_cli", "train.cli",
                 "train.data", "train.device_pool", "models.aed"):
        assert f"omnilingual_asr_torch.{name}" in names


def test_walk_reaches_the_mesh_layer():
    """The import walk covers the mesh and its strategies (sequence
    parallelism, expert dispatch, pipeline stages), ring attention, the
    packed wire and the mixture of experts (and so holds them to the
    rule)."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("parallel", "parallel.mesh", "parallel.sequence",
                 "parallel.expert_dispatch", "parallel.pipeline",
                 "ops.ring_attention", "ops.pack", "models.moe"):
        assert f"omnilingual_asr_torch.{name}" in names


def test_walk_reaches_the_tensor_parallel_layer():
    """The import walk covers tensor parallelism's layers (and so holds
    them to the rule); the conformer and the conv module that call them
    are reached too."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("parallel.tensor", "models.conformer", "ops.conv_module"):
        assert f"omnilingual_asr_torch.{name}" in names


_HELP = """
import runpy, sys
FORBIDDEN = {forbidden!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            raise ImportError('forbidden import: ' + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {repo!r})
sys.argv = [{module!r}, '--help']
try:
    runpy.run_module({module!r}, run_name='__main__')
except SystemExit as e:
    assert e.code in (0, None), e.code
leaked = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)
assert not leaked, leaked
"""


@pytest.mark.parametrize("module", [
    "omnilingual_asr_torch.train.pretrain_cli",
    "omnilingual_asr_torch.train.cli",
    "omnilingual_asr_torch.train.synth_train"])
def test_training_cli_help_with_jax_blocked(module):
    """Each training CLI of the rest of training prints its ``--help`` (the
    JAX CLI's flags) in a process where JAX and the JAX package cannot be
    imported."""
    code = _HELP.format(forbidden=FORBIDDEN, repo=str(REPO), module=module)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert "usage:" in out.stdout and "--steps" in out.stdout


def test_walk_reaches_the_checkpoint_layer():
    """The import walk covers the Orbax reader and writer (the native zstd
    decoder's loader, OCDBT, zarr), which therefore import none of orbax,
    tensorstore or zstandard."""
    import pkgutil

    import omnilingual_asr_torch as pkg

    names = {m.name for m in pkgutil.walk_packages(
        pkg.__path__, "omnilingual_asr_torch.")}
    for name in ("checkpoint.zstd", "checkpoint.ocdbt", "checkpoint.zarr",
                 "checkpoint.orbax"):
        assert f"omnilingual_asr_torch.{name}" in names
    assert {"orbax", "tensorstore", "zstandard"} <= set(FORBIDDEN)
