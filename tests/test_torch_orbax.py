"""PyTorch port: Orbax checkpoints without JAX (``checkpoint/``), held to
Orbax, tensorstore and the JAX package's own loaders, exactly.

- the OCDBT reader against tensorstore's ``ocdbt`` kvstore over a
  multi-level B-tree and a version tree (every generation), and a flipped
  byte failing the CRC;
- zarr v2 arrays with edge and missing chunks written by tensorstore;
- the JAX package's ``save_checkpoint`` of the release ASR and of a tree
  of every dtype, read by the port equal to what Orbax restores;
- the port's writer read by the JAX package's ``load_checkpoint`` and
  ``load_translator`` and listed identically by tensorstore;
- the committed fixture ``testdata/orbax_jax/`` (a JAX ``synth_train``
  layout) against its ``.npz`` twin and the JAX init;
- the trainers' ``--ckpt`` over a JAX run directory.

Regenerate the fixture: ``JAX_PLATFORMS=cpu python tests/test_torch_orbax.py``.
The decoder's throughput: ``tests/bench_torch_orbax.py``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config  # noqa: E402
from omnilingual_asr_tpu.models import conformer as jax_conformer  # noqa: E402
from omnilingual_asr_tpu.models import translation as jax_translation  # noqa: E402
from omnilingual_asr_tpu.models import zoo as jax_zoo  # noqa: E402
from omnilingual_asr_torch.checkpoint import ocdbt, orbax, zarr  # noqa: E402
from omnilingual_asr_torch.config import (PipelineConfig,  # noqa: E402
                                          config_for_checkpoint,
                                          tiny_config)
from omnilingual_asr_torch.models import conformer, translation, zoo  # noqa: E402

torch.set_num_threads(2)

RELEASE = REPO / "checkpoints" / "release"
TESTDATA = REPO / "omnilingual_asr_torch" / "testdata"
FIXTURE = TESTDATA / "orbax_jax"
TWIN = TESTDATA / "orbax_jax_twin.npz"
#: the fixture's seed, its train state's step and selection score
FIXTURE_SEED, FIXTURE_STEP, FIXTURE_BEST = 0, 3, 0.5


def _flat_jax(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {k: v.detach().numpy() for k, v in zoo.flatten(tree).items()}


def _assert_same(got: dict, want: dict):
    """Equal keys, and every leaf equal bit for bit with the same dtype."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype,
                                                           w.dtype)
        assert g.tobytes() == w.tobytes(), k


def _kv_list(path) -> list:
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    return sorted(k.decode() for k in kv.list().result())


# ---------------------------------------------------------------------------
# OCDBT against tensorstore
# ---------------------------------------------------------------------------

#: commits to the multilevel store: enough for B-tree interior nodes and a
#: version tree two levels deep (tensorstore keeps at most two versions
#: inline in the manifest at arity 2)
COMMITS = 8


@pytest.fixture(scope="module")
def multilevel(tmp_path_factory):
    """An OCDBT database written by tensorstore over COMMITS commits, with
    nodes of at most 64 decoded bytes and a version-tree arity of 2, so
    that both trees have interior nodes; values from 0 to 60 bytes,
    inline up to 16. Returns (root, [{key: value} after each commit],
    [the manifest's bytes after each commit])."""
    root = tmp_path_factory.mktemp("ocdbt")
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{root}/",
        "config": {"max_decoded_node_bytes": 64,
                   "version_tree_arity_log2": 1,
                   "max_inline_value_bytes": 16}}).result()
    rng = np.random.default_rng(0)
    state, history, manifests = {}, [], []
    for _ in range(COMMITS):
        txn = ts.Transaction()
        for _ in range(3):
            key = f"p{int(rng.integers(0, 9))}/{int(rng.integers(0, 30)):03d}"
            value = rng.bytes(int(rng.integers(0, 61)))
            kv.with_transaction(txn).write(key.encode(), value).result()
            state[key] = value
        txn.commit_async().result()
        history.append(dict(state))
        manifests.append((root / "manifest.ocdbt").read_bytes())
    return root, history, manifests


def test_ocdbt_matches_tensorstore_latest(multilevel):
    root, history, _ = multilevel
    store = ocdbt.Store(root)
    latest = history[-1]
    assert store.list() == sorted(latest) == _kv_list(root)
    for k, v in latest.items():
        assert store.read(k) == v
    assert store.version.root_height >= 2          # interior B-tree nodes
    assert store.get("absent/key") is None
    with pytest.raises(KeyError):
        store.read("absent/key")


def _tree_versions(store) -> list:
    """Every version the manifest's version tree holds, oldest first,
    through its interior nodes (the reader takes the latest, which the
    manifest holds inline)."""
    out = []

    def walk(ref, height):
        for e in store._version_node(ref, height):
            if height == 0:
                out.append(e)
            else:
                walk(e[2], e[1])

    for _, height, ref in store._version_refs:
        walk(ref, height)
    return out


def test_ocdbt_every_generation_matches_tensorstore(multilevel, tmp_path):
    """The database as it stood after each commit (its manifest then, over
    the data files, which commits only add to) reads as written and as
    tensorstore reads that generation; the version tree of the last
    manifest (two levels of nodes) holds every earlier version, each equal
    to the one its own manifest named."""
    root, history, manifests = multilevel
    latest = {}
    for state, manifest in zip(history, manifests):
        snap = tmp_path / "snap"
        shutil.rmtree(snap, ignore_errors=True)
        shutil.copytree(root, snap)
        (snap / "manifest.ocdbt").write_bytes(manifest)
        store = ocdbt.Store(snap)
        assert {k: store.read(k) for k in store.list()} == state
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                              "version": store.version.generation}).result()
        assert {k.decode(): kv.read(k).result().value
                for k in kv.list().result()} == state
        latest[store.version.generation] = store.version
    store = ocdbt.Store(root)
    assert max(h for _, h, _ in store._version_refs) >= 2
    tree = _tree_versions(store)
    gens = [v.generation for v in tree + store._inline]
    assert gens == list(range(gens[0], gens[0] + len(gens)))
    assert set(latest) <= set(gens) and max(latest) == gens[-1]
    assert sum(v.generation in latest for v in tree) >= len(latest) - 2
    for v in tree:
        if v.generation in latest:
            assert v == latest[v.generation]


def test_ocdbt_flipped_byte_fails_the_crc(multilevel, tmp_path):
    root, _, _ = multilevel
    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    manifest = copy / "manifest.ocdbt"
    data = bytearray(manifest.read_bytes())
    data[20] ^= 0x01
    manifest.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        ocdbt.Store(copy)
    shutil.copy(root / "manifest.ocdbt", manifest)
    store = ocdbt.Store(copy)
    node = copy / store.version.root.file
    data = bytearray(node.read_bytes())
    data[store.version.root.offset + 15] ^= 0x80
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        ocdbt.Store(copy).list()


def test_ocdbt_writer_read_by_tensorstore(multilevel, tmp_path):
    """``write_store`` (one uncompressed leaf and data file) reads back in
    tensorstore and in the port, values inline and indirect."""
    _, history, _ = multilevel
    latest = dict(history[-1])
    latest["big/value"] = bytes(range(256)) * 5     # past the inline limit
    assert len(latest["big/value"]) > ocdbt.MAX_INLINE_VALUE_BYTES
    ocdbt.write_store(tmp_path / "w", latest)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path / 'w'}/"}).result()
    assert {k.decode(): kv.read(k).result().value
            for k in kv.list().result()} == latest
    store = ocdbt.Store(tmp_path / "w")
    assert {k: store.read(k) for k in store.list()} == latest


# ---------------------------------------------------------------------------
# zarr v2 through tensorstore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,compressor,sep", [
    ("<f4", {"id": "zstd", "level": 3}, "."),
    ("bfloat16", {"id": "zstd", "level": 1}, "/"),
    ("<f2", None, "."),
    ("<i4", {"id": "zstd", "level": 1}, "/"),
    ("|i1", None, "/"),
    ("|b1", {"id": "zstd", "level": 1}, "."),
])
def test_zarr_chunk_grid_matches_tensorstore(dtype, compressor, sep,
                                             tmp_path):
    """A (37, 23) array in (8, 5) chunks (edge chunks on both axes) on an
    OCDBT kvstore; one region is never written, so its chunks are missing
    and read as the fill value."""
    kvstore = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    fill = False if dtype == "|b1" else 3
    spec = {"driver": "zarr", "kvstore": kvstore, "path": "w.x",
            "metadata": {"shape": [37, 23], "chunks": [8, 5],
                         "dtype": dtype, "compressor": compressor,
                         "dimension_separator": sep, "fill_value": fill}}
    arr = ts.open(spec, create=True).result()
    rng = np.random.default_rng(1)
    np_dt = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    full = (rng.standard_normal((37, 23)) * 50).astype(np_dt)
    arr[:, :16].write(full[:, :16]).result()
    want = np.asarray(arr.read().result())
    store = ocdbt.Store(tmp_path)
    assert any(k.startswith("w.x/") and sep in k[4:] for k in store.list())
    got = zarr.read_array(store.get, "w.x")
    if dtype == "bfloat16":
        want = want.astype(np.float32)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_zarr_refuses_other_formats(tmp_path):
    """zarr v3 or a non-OCDBT checkpoint raise, naming the field."""
    orbax.write_flat(tmp_path / "c", {("a",): np.zeros(3, np.float32)})
    meta = json.loads((tmp_path / "c" / "_METADATA").read_text())
    for field, value in (("use_zarr3", True), ("use_ocdbt", False)):
        bad = dict(meta, **{field: value})
        (tmp_path / "c" / "_METADATA").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=field):
            orbax.read_flat(tmp_path / "c")


# ---------------------------------------------------------------------------
# The JAX package's checkpoints, read by the port
# ---------------------------------------------------------------------------

def _release_configs():
    text = (RELEASE / "config.json").read_text()
    return JaxConfig.from_json(text), PipelineConfig.from_json(text)


@pytest.fixture(scope="module")
def release_orbax(tmp_path_factory):
    """The release ASR at full width, saved by the JAX package's
    ``save_checkpoint`` (Orbax, zstd chunks)."""
    _, cfg = _release_configs()
    path = tmp_path_factory.mktemp("release") / "asr"
    jax_zoo.save_checkpoint(path, _nested_numpy(zoo.load_checkpoint(
        RELEASE / "asr.npz", cfg)))
    return path


def test_release_orbax_equals_npz(release_orbax):
    """The port loads the JAX package's Orbax save of the release ASR equal
    bit for bit to its own load of ``asr.npz``."""
    _, cfg = _release_configs()
    _assert_same(_flat_port(zoo.load_checkpoint(release_orbax, cfg)),
                 _flat_port(zoo.load_checkpoint(RELEASE / "asr.npz", cfg)))
    with np.load(RELEASE / "asr.npz") as z:
        top = {zoo.parse_keystr(k)[0] for k in z.files}
    assert {p[0] for p in orbax.read_flat(release_orbax)} == top


def _dtype_tree():
    rng = np.random.default_rng(2)
    return {
        "bf16": jnp.asarray(rng.standard_normal((33, 7)), jnp.bfloat16),
        "f16": rng.standard_normal((4, 5, 6)).astype(np.float16),
        "f32": [rng.standard_normal(300).astype(np.float32),
                np.asarray(2.5, np.float32)],
        "i8": rng.integers(-128, 128, (17,), dtype=np.int8),
        "i32": {"x": rng.integers(-2**31, 2**31, (3, 3), dtype=np.int32)},
        "mask": rng.random((2, 9)) > 0.5,
        "scalar_i32": np.asarray(-7, np.int32),
    }


def test_every_dtype_equals_orbax_restore(tmp_path):
    """bf16, f16, f32, int8, int32, bool and 0-d leaves: ``read_flat``
    equals Orbax's restore (bf16 widened to f32, exactly)."""
    import orbax.checkpoint as ocp

    tree = _dtype_tree()
    jax_zoo.save_checkpoint(tmp_path / "c", tree)
    restored = ocp.StandardCheckpointer().restore(
        tmp_path / "c", jax.tree.map(np.asarray, tree))
    want = {k: (v.astype(np.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in _flat_jax(restored).items()}
    _assert_same({zoo.keystr(p): v
                  for p, v in orbax.read_flat(tmp_path / "c").items()}, want)


# ---------------------------------------------------------------------------
# The port's writer, read by the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX ``synth_train`` run directory at the tiny config, written by
    the JAX package's save functions once for the module: Orbax ``asr/``
    and ``translator/`` (init trees; the translator is
    ``_translator_tree("audio")``), and ``config.json``."""
    cfg = jax_tiny_config()
    d = tmp_path_factory.mktemp("jax_run")
    jax_zoo.save_checkpoint(d / "asr", _nested_numpy(
        conformer.asr_init(torch.Generator().manual_seed(7), tiny_config())))
    jax_translation.save_translator(d / "translator", _nested_numpy(
        _translator_tree("audio")))
    (d / "config.json").write_text(cfg.to_json())
    return d


def test_port_checkpoint_loads_in_jax(jax_run, tmp_path):
    """``zoo.save_checkpoint`` to a directory: the JAX package's
    ``load_checkpoint`` (Orbax) reads it bit-exact, tensorstore lists the
    keys the JAX package's own save of a tree of that structure lists, and
    the port reads it back; a second save replaces the first, leaving
    nothing else behind."""
    cfg, jcfg = tiny_config(), jax_tiny_config()
    params = conformer.asr_init(torch.Generator().manual_seed(4), cfg)
    zoo.save_checkpoint(tmp_path / "asr", params)
    _assert_same(_flat_jax(jax_zoo.load_checkpoint(tmp_path / "asr", jcfg)),
                 _flat_port(params))
    _assert_same(_flat_port(zoo.load_checkpoint(tmp_path / "asr", cfg)),
                 _flat_port(params))
    assert _kv_list(tmp_path / "asr") == _kv_list(jax_run / "asr")
    again = conformer.asr_init(torch.Generator().manual_seed(5), cfg)
    zoo.save_checkpoint(tmp_path / "asr", again)
    _assert_same(_flat_port(zoo.load_checkpoint(tmp_path / "asr", cfg)),
                 _flat_port(again))
    assert [p.name for p in tmp_path.iterdir()] == ["asr"]


def _translator_tree(kind: str):
    """A decoder tree of each kind ``load_translator`` tells apart by its
    keys: audio mode, text mode (``src``), a fact-conditioned summarizer
    (``fact_cond``), and one from before the position table."""
    cfg = tiny_config()
    gen = torch.Generator().manual_seed(6)
    if kind == "text":
        return translation.text_translator_init(gen, cfg)
    tree = translation.translator_init(gen, cfg)
    if kind == "fact":
        tree["fact_cond"] = torch.ones(())
    if kind == "no_pos":
        tree.pop("pos")
    return tree


@pytest.mark.parametrize("kind", ["audio", "text", "fact", "no_pos"])
def test_translator_both_ways(kind, jax_run, tmp_path):
    """The port's ``save_translator`` to a directory loads in the JAX
    package's ``load_translator`` bit-exact; the JAX package's save of the
    same tree loads in the port equal to the JAX package's own load (a
    checkpoint without ``pos`` gets the zero table in both)."""
    cfg, jcfg = tiny_config(), jax_tiny_config()
    tree = _translator_tree(kind)
    translation.save_translator(tmp_path / "port", tree)
    theirs = _flat_jax(jax_translation.load_translator(tmp_path / "port",
                                                       jcfg))
    jax_dir = jax_run / "translator"             # the module's audio save
    if kind != "audio":
        jax_dir = tmp_path / "jax"
        jax_translation.save_translator(jax_dir, _nested_numpy(tree))
    jax_load = _flat_jax(jax_translation.load_translator(jax_dir, jcfg))
    mine = _flat_port(translation.load_translator(jax_dir, cfg))
    _assert_same(mine, jax_load)
    _assert_same(theirs, jax_load)
    if kind == "no_pos":
        assert not mine["['pos']"].any()


def _nested_numpy(tree):
    if isinstance(tree, dict):
        return {k: _nested_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_nested_numpy(v) for v in tree]
    return tree.detach().numpy()


# ---------------------------------------------------------------------------
# The committed fixture: a JAX synth_train run directory
# ---------------------------------------------------------------------------

def _jax_fixture_config() -> JaxConfig:
    """The tests' tiny config cut to d_model 16 and one layer, so that the
    whole run directory stays near 1 MB (the speaker heads' fixed widths
    are most of it)."""
    cfg = jax_tiny_config()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, d_model=16, n_layers=1))


def _fixture_init():
    """The JAX init of the fixture's trees at its seed (``make_train_step``'s
    ``init_state``: the ASR at ``seed``, the translator at ``seed + 1``),
    rounded to bfloat16 as the fixture stores it."""
    cfg = _jax_fixture_config()

    @jax.jit                      # one compile, not one an op
    def init():
        tree = {"asr": jax_conformer.asr_init(
                    jax.random.PRNGKey(FIXTURE_SEED), cfg),
                "translator": jax_translation.translator_init(
                    jax.random.PRNGKey(FIXTURE_SEED + 1), cfg)}
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree)

    return jax.tree.map(np.asarray, init())


def make_fixture(out: Path = FIXTURE, twin: Path = TWIN) -> None:
    """Write the fixture with the JAX package's own save functions: ``asr/``
    and ``translator/`` (Orbax, bfloat16 leaves), ``config.json`` and the
    optimizer's ``train_state.npz`` at its init (stored compressed: the
    same arrays), and the f32 ``.npz`` twin of every leaf."""
    from omnilingual_asr_tpu.train.step import make_optimizer
    from omnilingual_asr_tpu.train.synth_train import save_train_state

    cfg = _jax_fixture_config()
    tree = _fixture_init()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jax_zoo.save_checkpoint(out / "asr", tree["asr"])
    jax_translation.save_translator(out / "translator", tree["translator"])
    (out / "config.json").write_text(cfg.to_json())
    f32 = jax.tree.map(lambda x: x.astype(np.float32), tree)
    save_train_state(out / "train_state.npz", make_optimizer().init(f32),
                     FIXTURE_STEP, FIXTURE_BEST)
    with np.load(out / "train_state.npz") as z:
        state = {k: z[k] for k in z.files}
    np.savez_compressed(out / "train_state.npz", **state)
    np.savez_compressed(twin, **{k: np.asarray(v, np.float32)
                                 for k, v in _flat_jax(tree).items()})


def test_fixture_is_current():
    """The committed fixture opens with the JAX package's own loaders; its
    leaves equal the twin, and the twin equals the JAX init at the
    fixture's seed (values, not bytes: Orbax writes timestamps and random
    file names)."""
    from omnilingual_asr_tpu.train.step import make_optimizer
    from omnilingual_asr_tpu.train.synth_train import load_train_state

    jcfg = JaxConfig.from_json((FIXTURE / "config.json").read_text())
    assert jcfg.encoder == _jax_fixture_config().encoder
    loaded = {"asr": jax_zoo.load_checkpoint(FIXTURE / "asr", jcfg),
              "translator": jax_translation.load_translator(
                  FIXTURE / "translator", jcfg)}
    with np.load(TWIN) as z:
        twin = {k: z[k] for k in z.files}
    _assert_same({k: np.asarray(v, np.float32)
                  for k, v in _flat_jax(loaded).items()}, twin)
    _assert_same({k: v.astype(np.float32)
                  for k, v in _flat_jax(_fixture_init()).items()}, twin)
    opt, step, best = load_train_state(
        FIXTURE / "train_state.npz", make_optimizer().init(loaded))
    assert (step, best) == (FIXTURE_STEP, FIXTURE_BEST)


def test_fixture_reads_in_the_port():
    """Without JAX: every leaf of the fixture's ``asr/`` and
    ``translator/`` equals the twin bit for bit (bfloat16 widened), and the
    config beside them is found from ``<run>/asr``."""
    with np.load(TWIN) as z:
        twin = {k: z[k] for k in z.files}
    got = {}
    for part in ("asr", "translator"):
        for p, v in orbax.read_flat(FIXTURE / part).items():
            got[zoo.keystr((part,) + p)] = v
    _assert_same(got, twin)
    cfg = config_for_checkpoint(str(FIXTURE / "asr"))
    assert cfg.encoder.d_model == 16 and cfg.encoder.n_layers == 1
    params = zoo.load_checkpoint(zoo.resolve_checkpoint(FIXTURE, "asr"), cfg)
    trans = translation.load_translator(
        zoo.resolve_checkpoint(FIXTURE, "translator"), cfg)
    _assert_same({f"['asr']{k}": v for k, v in _flat_port(params).items()}
                 | {f"['translator']{k}": v
                    for k, v in _flat_port(trans).items()}, twin)


def test_resolve_checkpoint(tmp_path):
    """``--ckpt`` / ``--init-from`` / ``--resume-from``: an ``.npz`` or an
    Orbax directory as given; a run directory's ``<name>.npz`` first, then
    its Orbax ``<name>/``."""
    orbax.write_flat(tmp_path / "jaxrun" / "asr",
                     {("a",): np.zeros(2, np.float32)})
    (tmp_path / "portrun").mkdir()
    np.savez(tmp_path / "portrun" / "asr.npz", a=np.zeros(2))
    r = zoo.resolve_checkpoint
    assert r(tmp_path / "x.npz", "asr") == tmp_path / "x.npz"
    assert r(tmp_path / "jaxrun" / "asr", "asr") == tmp_path / "jaxrun/asr"
    assert r(tmp_path / "jaxrun", "asr") == tmp_path / "jaxrun" / "asr"
    assert r(tmp_path / "portrun", "asr") == tmp_path / "portrun/asr.npz"
    assert r(tmp_path / "jaxrun", "translator") == \
        tmp_path / "jaxrun" / "translator.npz"


# ---------------------------------------------------------------------------
# The trainers' --ckpt over a JAX run directory
# ---------------------------------------------------------------------------

def _recording(module, monkeypatch):
    """Wrap ``module.load_checkpoint`` to record what it loads."""
    seen = []
    real = module.load_checkpoint

    def load(path, cfg, *a, **kw):
        seen.append((Path(path), real(path, cfg, *a, **kw)))
        return seen[-1][1]

    monkeypatch.setattr(module, "load_checkpoint", load)
    return seen


def test_translator_train_main_over_a_jax_run(jax_run, tmp_path,
                                              monkeypatch, capsys):
    """``translator_train --ckpt <JAX run> --init-from <JAX run>``: the
    encoder is the run's ``asr/`` equal to the JAX package's load, and the
    decoder warm-starts from its ``translator/`` (the first update has
    learning rate 0, so the saved decoder is the JAX package's load)."""
    from omnilingual_asr_torch.train import translator_train

    seen = _recording(translator_train, monkeypatch)
    translator_train.main([
        "--ckpt", str(jax_run), "--out", str(tmp_path / "out"),
        "--init-from", str(jax_run), "--steps", "1", "--n-train", "2",
        "--n-eval", "1", "--batch-size", "2", "--device", "cpu"])
    assert "warm-started decoder from" in capsys.readouterr().out
    jcfg = jax_tiny_config()
    assert seen[0][0] == jax_run / "asr"
    _assert_same(_flat_port(seen[0][1]),
                 _flat_jax(jax_zoo.load_checkpoint(jax_run / "asr", jcfg)))
    got = _flat_port(translation.load_translator(
        tmp_path / "out" / "translator.npz", tiny_config()))
    _assert_same(got, _flat_jax(jax_translation.load_translator(
        jax_run / "translator", jcfg)))


def test_summary_train_main_over_a_jax_run(jax_run, tmp_path, monkeypatch):
    """``summary_train --ckpt <JAX run>`` trains over the run's ``asr/``,
    equal to the JAX package's load, with the run's own config."""
    from omnilingual_asr_torch.train import summary_train

    seen = _recording(summary_train, monkeypatch)
    summary_train.main([
        "--ckpt", str(jax_run), "--out", str(tmp_path), "--steps", "1",
        "--pool-size", "12", "--n-train", "2", "--n-eval", "1",
        "--batch-size", "2", "--device", "cpu"])
    assert seen[0][0] == jax_run / "asr"
    _assert_same(_flat_port(seen[0][1]), _flat_jax(jax_zoo.load_checkpoint(
        jax_run / "asr", jax_tiny_config())))
    assert (tmp_path / "summarizer.npz").is_file()


if __name__ == "__main__":
    make_fixture()
    print(f"wrote {FIXTURE} and {TWIN}")
