"""PyTorch port: the manifest data loader (``train/data.py``) and the
manifest training CLI (``train/cli.py``) against the JAX package.

Small sizes only (``tiny_config``); the manifests point at WAVs written
here from a seed (one of them at 8 kHz, resampled on load). The JAX
trainer's initial parameters are captured by wrapping its
``make_train_step`` and carried into the port's run.
"""

from __future__ import annotations

import json
import signal
import wave

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from omnilingual_asr_tpu.config import MeshConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import zoo as jax_zoo
from omnilingual_asr_tpu.train import cli as jax_cli
from omnilingual_asr_tpu.train import data as jax_data
from omnilingual_asr_torch import testing
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.models import zoo
from omnilingual_asr_torch.train import cli, data, step
from omnilingual_asr_torch.train.synth import eval_set

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Six synthetic utterances (``eval_set``, cut to 3 s) as WAVs, the
    last at 8 kHz, and a manifest with relative and absolute paths, a
    missing language and an unknown emotion."""
    root = tmp_path_factory.mktemp("manifest")
    lines = []
    for i, ex in enumerate(eval_set(6, seed=77)):
        rate = 8000 if i == 5 else 16000
        x = ex.samples[:48_000]
        if rate == 8000:
            x = x[::2]
        path = root / f"u{i}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype(
                np.int16).tobytes())
        item = {"audio": str(path) if i == 0 else path.name,
                "text": ex.text}
        if i != 2:
            item["language"] = ex.language
        item["emotion"] = "bored" if i == 3 else ex.emotion
        lines.append(json.dumps(item))
    out = root / "train.jsonl"
    out.write_text("\n".join(lines[:3]) + "\n\n" + "\n".join(lines[3:]))
    return out


def test_load_manifest_equals_jax(manifest):
    got = data.load_manifest(manifest)
    assert got == jax_data.load_manifest(manifest)
    assert len(got) == 6 and all(it["audio"].startswith("/") for it in got)


def test_batch_loader_batches_and_second_epoch_equal_jax(manifest):
    """``BatchLoader`` (batch 2 of 1 s windows, seed 5) yields the JAX
    loader's batches element for element: the three of the first epoch and
    the first of the second (its own shuffle); with ``loop=False`` it stops
    after one epoch."""
    kw = dict(batch_size=2, window_seconds=1.0, seed=5)
    got = data.BatchLoader(manifest, tiny_config(), **kw)
    want = jax_data.BatchLoader(manifest, jax_tiny_config(), **kw)
    try:
        for _ in range(4):
            g, w = next(got), next(want)
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    finally:
        got.close()
        want.close()
    assert g["samples"].dtype == np.float32 and g["mask"].shape == (2, 100)
    once = data.BatchLoader(manifest, tiny_config(), loop=False, **kw)
    assert len(list(once)) == 3
    with pytest.raises(ValueError, match="empty"):
        empty = manifest.parent / "empty.jsonl"
        empty.write_text("\n")
        data.BatchLoader(empty, tiny_config(), **kw)


def test_cli_train_two_steps_match_jax(manifest, tmp_path, monkeypatch):
    """``cli.train`` for 2 steps (batch 2, 3 s windows, f32 samples through
    the log-mel) from the JAX trainer's initial parameters, against
    ``omnilingual_asr_tpu.train.cli.train`` on a one-device CPU mesh: each
    step's loss within ``testing.TRAINER_LOSS_REL`` relative, and its CTC,
    LID and emotion parts within 1e-3, the joint loss's parts' tolerance in
    tests/test_torch_train.py (a pooled emotion CE of 1.44 moved by 1.3e-4
    relative). The first update has learning rate 0 under the default
    warmup, so both steps compare forwards from the same parameters, each
    package with its own log-mel of the same samples. The saved ``.npz``
    loads back with both packages' ``load_checkpoint``."""
    kw = dict(steps=2, batch_size=2, lr=1e-3, window_seconds=3.0,
              log_every=1, seed=4)
    jcfg = jax_tiny_config().replace(mesh=MeshConfig(data=1, model=1))
    seen = {"jax": [], "port": []}
    jmake = jax_cli.make_train_step

    def jax_watch(*args, **kwargs):
        init, jstep = jmake(*args, **kwargs)

        def init_state(seed=0):
            seen["init"] = init(seed)
            seen["params"] = jax.device_get(seen["init"].params)
            return seen["init"]

        def watched(params, opt_state, batch, s):
            if not seen["jax"]:
                # The jitted step hands its optimizer state and step back
                # committed to its mesh: commit them so for the first call
                # too, or the second compiles the step again.
                opt_state, s = jax.device_put(
                    (opt_state, s), NamedSharding(args[1], PartitionSpec()))
            out = jstep(params, opt_state, batch, s)
            seen["jax"].append({k: float(v) for k, v in out[3].items()})
            return out
        return init_state, watched

    monkeypatch.setattr(jax_cli, "make_train_step", jax_watch)
    jax_cli.train(str(manifest), cfg=jcfg, **kw)

    pmake = cli.make_train_step

    def port_watch(*args, **kwargs):
        init, tstep, lg = pmake(*args, **kwargs)

        def init_state(seed=0):
            st = init(seed)
            st.params = step.tree_map(lambda t: t.requires_grad_(True),
                                      zoo.params_from_jax(seen["params"]))
            st.opt_state = kwargs["tx"].init(st.params)
            return st

        def watched(params, opt_state, batch, s):
            out = tstep(params, opt_state, batch, s)
            seen["port"].append({k: float(v) for k, v in out[3].items()})
            return out
        return init_state, watched, lg

    monkeypatch.setattr(cli, "make_train_step", port_watch)
    ck = tmp_path / "asr.npz"
    params = cli.train(str(manifest), cfg=tiny_config(), ckpt=str(ck),
                       device="cpu", **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for g, w in zip(seen["port"], seen["jax"]):
        for k, tol in (("loss", testing.TRAINER_LOSS_REL), ("ctc", 1e-3),
                       ("lid", 1e-3), ("emotion", 1e-3)):
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), (k, g[k], w[k])
    mine = zoo.flatten(zoo.load_checkpoint(ck, tiny_config()))
    theirs = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
              jax.tree_util.tree_flatten_with_path(
                  jax_zoo.load_checkpoint(ck, jax_tiny_config()))[0]}
    live = zoo.flatten(params)
    for k in mine:
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k])
        np.testing.assert_array_equal(mine[k].numpy(),
                                      live[k].detach().numpy())


def test_cli_main_pretrain_and_refusals(manifest, tmp_path):
    """``python -m omnilingual_asr_torch.train.cli manifest --pretrain``
    (``--tiny``, one step on the CPU, over 2 data rows of CPU shards)
    writes the pretrained encoder as one ``.npz`` that both packages'
    ``load_checkpoint`` read; ``--ckpt DIR`` without ``.npz`` writes
    ``DIR/asr.npz``; ``--mesh-model 2`` trains over two model shards and
    saves the whole tree; without a card the default device raises."""
    old = signal.getsignal(signal.SIGTERM)
    try:
        ck = tmp_path / "pre.npz"
        cli.main([str(manifest), "--tiny", "--steps", "1", "--batch-size",
                  "2", "--window-seconds", "1", "--pretrain", "--ckpt",
                  str(ck), "--device", "cpu", "--mesh-data", "2"])
        enc = zoo.flatten(zoo.load_checkpoint(ck, tiny_config()))
        jenc = jax_zoo.load_checkpoint(ck, jax_tiny_config())
        assert len(enc) == len(jax.tree_util.tree_leaves(jenc))
        cli.main([str(manifest), "--tiny", "--steps", "1", "--batch-size",
                  "2", "--window-seconds", "1", "--ckpt",
                  str(tmp_path / "out"), "--device", "cpu"])
        assert (tmp_path / "out" / "asr.npz").is_file()
        tp = tmp_path / "tp.npz"
        cli.main([str(manifest), "--tiny", "--steps", "1", "--batch-size",
                  "2", "--window-seconds", "1", "--ckpt", str(tp),
                  "--device", "cpu", "--mesh-model", "2"])
        got = zoo.flatten(zoo.load_checkpoint(tp, tiny_config()))
        want = zoo.flatten(zoo.load_checkpoint(tmp_path / "out" / "asr.npz",
                                               tiny_config()))
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main([str(manifest), "--tiny", "--steps", "1"])
    finally:
        signal.signal(signal.SIGTERM, old)


def test_cli_flags_and_defaults_equal_jax(monkeypatch):
    """``cli.main`` has the JAX CLI's flags with the same defaults, plus
    ``--device``."""
    from test_torch_pretrain import _cli_options

    old = signal.getsignal(signal.SIGTERM)
    try:
        got = _cli_options(cli.main, monkeypatch)
        want = _cli_options(jax_cli.main, monkeypatch)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert got.pop("--device") is None
    assert got == want


def test_cli_train_takes_experts_over_the_model_axis(manifest, tmp_path):
    """``cli.train`` (the manifest trainer behind ``--mesh-model``) with a
    mixture of experts (tiny_config with 2 experts) over two model shards
    of the CPU: the experts split by expert, one step, and the saved tree
    has every expert whole."""
    import dataclasses

    from omnilingual_asr_torch.config import MeshConfig as PortMeshConfig

    cfg = tiny_config()
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder, n_experts=2),
                      mesh=PortMeshConfig(data=1, model=2))
    ck = tmp_path / "moe.npz"
    cli.train(str(manifest), steps=1, batch_size=2, cfg=cfg,
              window_seconds=1.0, ckpt=str(ck), device="cpu")
    got = zoo.flatten(zoo.load_checkpoint(ck, cfg))
    w1 = got["['blocks'][0]['ffn2']['w1']"]
    assert tuple(w1.shape) == (2, 128, 512)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
