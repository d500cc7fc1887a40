"""PyTorch port: release weights load without JAX, into the JAX tree's
structure and shapes."""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
from omnilingual_asr_tpu.models.conformer import asr_init
from omnilingual_asr_tpu.models.xvector import xvector_init
from omnilingual_asr_tpu.models.zoo import load_release as jax_load_release
from omnilingual_asr_torch.config import PipelineConfig
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.models.conformer import asr_param_shapes
from omnilingual_asr_torch.models.xvector import xvector_param_shapes

torch.set_num_threads(2)

RELEASE = Path(__file__).resolve().parents[1] / "checkpoints" / "release"


def _configs():
    text = (RELEASE / "config.json").read_text()
    return JaxConfig.from_json(text), PipelineConfig.from_json(text)


def _flat(tree, path=()):
    """{path tuple: leaf} of a nested dict/list tree (a shape tuple is a
    leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("name", ["asr", "xvector"])
def test_release_leaves_match_jax_shapes(name):
    """Every leaf of the npz loads, with the shape jax.eval_shape gives."""
    jcfg, tcfg = _configs()
    if name == "asr":
        template = jax.eval_shape(lambda: asr_init(jax.random.PRNGKey(0),
                                                   jcfg))
        params = zoo.load_checkpoint(RELEASE / "asr.npz", tcfg)
        shapes = asr_param_shapes(tcfg)
    else:
        template = jax.eval_shape(lambda: xvector_init(jax.random.PRNGKey(0),
                                                       jcfg))
        params = zoo.load_xvector(RELEASE / "xvector.npz", tcfg)
        shapes = xvector_param_shapes(tcfg)
    want = {p: tuple(l.shape) for p, l in _flat(template).items()}
    got = {p: tuple(t.shape) for p, t in _flat(params).items()}
    assert got == want
    assert {p: tuple(s) for p, s in _flat(shapes).items()} == want
    with np.load(RELEASE / f"{name}.npz") as z:
        keys = set(z.files)
        assert {zoo.keystr(p) for p in got} == keys
        for p, t in _flat(params).items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(
                t.numpy(), z[zoo.keystr(p)].astype(np.float32))


def test_params_from_jax_equals_npz_load():
    jcfg, tcfg = _configs()
    template = jax.eval_shape(lambda: asr_init(jax.random.PRNGKey(0), jcfg))
    jax_tree = jax_load_release(RELEASE / "asr.npz", template)
    carried = _flat(zoo.params_from_jax(jax_tree))
    loaded = _flat(zoo.load_checkpoint(RELEASE / "asr.npz", tcfg))
    assert carried.keys() == loaded.keys()
    for p in loaded:
        assert torch.equal(carried[p], loaded[p]), p


@pytest.mark.parametrize("key,parts", [
    ("['blocks'][0]['mhsa']['wq']['w']", ("blocks", 0, "mhsa", "wq", "w")),
    ("['spk_aam']", ("spk_aam",)),
    ("['convs'][12]['b']", ("convs", 12, "b")),
])
def test_keystr_roundtrip(key, parts):
    assert zoo.parse_keystr(key) == parts
    assert zoo.keystr(parts) == key


@pytest.mark.parametrize("bad", ["", "blocks", "['a']x", "[a]"])
def test_keystr_rejects_malformed(bad):
    with pytest.raises(ValueError):
        zoo.parse_keystr(bad)


def test_load_rejects_wrong_shape(tmp_path):
    _, tcfg = _configs()
    with np.load(RELEASE / "xvector.npz") as z:
        arrays = {k: z[k] for k in z.files}
    arrays["['out']['w']"] = np.zeros((3, 3), np.float16)
    np.savez(tmp_path / "bad.npz", **arrays)
    with pytest.raises(ValueError, match="shape"):
        zoo.load_xvector(tmp_path / "bad.npz", tcfg)
    del arrays["['out']['w']"]
    np.savez(tmp_path / "missing.npz", **arrays)
    with pytest.raises(KeyError):
        zoo.load_xvector(tmp_path / "missing.npz", tcfg)


def test_default_release_dir_rules(tmp_path, monkeypatch):
    monkeypatch.setenv("OMNIASR_RELEASE_DIR", "")
    assert zoo.default_release_dir() is None
    monkeypatch.setenv("OMNIASR_RELEASE_DIR", str(tmp_path))
    assert zoo.default_release_dir() == tmp_path
    monkeypatch.setenv("OMNIASR_RELEASE_DIR", str(tmp_path / "nope"))
    assert zoo.default_release_dir() is None
    monkeypatch.delenv("OMNIASR_RELEASE_DIR")
    assert zoo.default_release_dir() == RELEASE


def test_orbax_checkpoint_not_ported(tmp_path):
    _, tcfg = _configs()
    with pytest.raises(NotImplementedError):
        zoo.load_checkpoint(tmp_path / "ckpt_dir", tcfg)
