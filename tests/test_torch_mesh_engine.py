"""PyTorch port: the single-controller mesh (``parallel/mesh.py``), the
engine's data-parallel windows and the packed wire (``ops/pack.py``), held
to the JAX package on the CPU.

The port's meshes here are shards on the CPU (``[cpu] * n``); the JAX side
runs on the 8 host devices that ``tests/conftest.py`` forces.
"""

from __future__ import annotations

import dataclasses
import io
import wave
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.config import (DecodeConfig, MeshConfig,
                                          PipelineConfig, tiny_config)
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_torch.models.conformer import asr_init
from omnilingual_asr_torch.ops.pack import layout_of, pack_tree, unpack_buffer
from omnilingual_asr_torch.parallel import mesh as pm

torch.set_num_threads(2)

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
RELEASE = REPO / "checkpoints" / "release"
DP_WINDOW_SECONDS = 10.0   # two windows of the tiled golden audio
DP_SECONDS = 20.0


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

def test_build_mesh_shapes_defaults_and_refusals(monkeypatch):
    mesh = pm.build_mesh(MeshConfig(data=4, model=2), [CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.size == 8 and mesh.distinct_devices() == [CPU]
    assert pm.build_mesh(MeshConfig(), [CPU] * 3).shape == {"data": 3,
                                                           "model": 1}
    assert pm.build_mesh(MeshConfig(model=2), [CPU] * 4).shape == {
        "data": 2, "model": 2}
    with pytest.raises(ValueError, match="needs 8 devices"):
        pm.build_mesh(MeshConfig(data=4, model=2), [CPU] * 4)
    if not torch.cuda.is_available():   # the default spans CUDA devices
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.build_mesh(MeshConfig())
    for name in ("COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES",
                 "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert pm.init_distributed() is False
    assert (pm.process_index(), pm.process_count()) == (0, 1)
    assert pm.distributed_backend() is None
    # A coordinator without a process count or id is refused before any
    # connection is tried.
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        pm.init_distributed()
    with pytest.raises(ValueError, match="PROCESS_ID"):
        pm.init_distributed(num_processes=2)
    monkeypatch.delenv("COORDINATOR_ADDRESS")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "h0,h1")
    with pytest.raises(ValueError, match="PROCESS_ID"):
        pm.init_distributed()       # the count from the host names
    # What crosses processes: gloo on host devices or a shared card, NCCL
    # where every process has cards of its own.
    host = {"host": True, "cards": []}
    card = [{"host": False, "cards": [u]} for u in ("GPU-a", "GPU-b")]
    assert pm.choose_backend([host, host], True) == "gloo"
    assert pm.choose_backend([card[0], card[0]], True) == "gloo"
    assert pm.choose_backend(card, True) == "nccl"
    assert pm.choose_backend(card, False) == "gloo"
    # Over two processes (one device each, faked): a model group that
    # spans them, and serving over the mesh, raise naming A10.
    monkeypatch.setattr(pm, "_PROCESSES", pm._Processes(
        0, 2, [CPU], "gloo", None, CPU))
    monkeypatch.setattr(pm, "_gathered_objects", lambda obj: [obj, obj])
    with pytest.raises(NotImplementedError, match="A10"):
        pm.build_mesh(MeshConfig(data=1, model=2), [CPU])
    spans = pm.build_mesh(MeshConfig(data=2), [CPU])
    assert spans.spans_processes and spans.processes.tolist() == [[0], [1]]
    assert spans.local().shape == {"data": 1, "model": 1}
    with pytest.raises(NotImplementedError, match="A10"):
        TranscriptionEngine(mesh=spans)


def test_build_mesh_matches_jax_resolve():
    """The same (data, model) for every config the JAX tests build."""
    from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
    from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build

    for data, model in ((-1, 1), (4, 2), (2, 4), (1, 1), (-1, 2)):
        want = dict(jax_build(JaxMeshConfig(data=data, model=model)).shape)
        got = pm.build_mesh(MeshConfig(data=data, model=model), [CPU] * 8)
        assert got.shape == want


def test_shard_params_splits_experts_and_replicates_the_rest():
    mesh = pm.build_mesh(MeshConfig(data=2, model=4), [CPU] * 8)
    w1 = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    tree = {"w1": w1, "router": {"w": torch.ones(3, 8)}}
    out = pm.shard_params(tree, {"w1": "model", "router": None}, mesh)
    assert [t.tolist() for t in out["w1"]] == [w1[2 * i:2 * i + 2].tolist()
                                               for i in range(4)]
    assert len(out["router"]["w"]) == 1           # one distinct device
    assert out["router"]["w"][0] is tree["router"]["w"]


def test_collectives_follow_jax_semantics():
    """ppermute, all_to_all and psum against their numpy definitions; no
    input is written."""
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
          for _ in range(4)]
    before = [x.clone() for x in xs]
    got = pm.ppermute(xs, [(0, 1), (1, 2), (2, 3)])
    assert torch.equal(got[0], torch.zeros(4, 3))   # receives nothing
    for i in (1, 2, 3):
        assert torch.equal(got[i], xs[i - 1])
    got = pm.all_to_all(xs)
    for j in range(4):
        for i in range(4):
            assert torch.equal(got[j][i], xs[i][j])
    got = pm.psum(xs)
    want = xs[0] + xs[1] + xs[2] + xs[3]
    assert all(torch.equal(g, want) for g in got)
    full = torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32))
    assert torch.equal(pm.gather(pm.scatter(full, [CPU] * 4)), full)
    for x, b in zip(xs, before):
        assert torch.equal(x, b)
    with pytest.raises(ValueError, match="split"):
        pm.scatter(full, [CPU] * 3)


def test_engine_serves_tensor_parallel_mesh(tmp_path):
    """The (1, 2) mesh the engine once refused serves: one replica holding
    the row's two model shards, every window through the tensor-parallel
    forward, the same segments as one device."""
    params = asr_init(torch.Generator().manual_seed(0), tiny_config())
    mesh = pm.build_mesh(MeshConfig(data=1, model=2), [CPU] * 2)
    eng = TranscriptionEngine(config=tiny_config(), mesh=mesh,
                              params=params, speaker_mode="inline")
    assert eng.n_model == 2 and len(eng._replicas[0].shards) == 2
    one = TranscriptionEngine(config=tiny_config(), device="cpu",
                              params=params, speaker_mode="inline")
    path = _tiled_golden(tmp_path / "g.wav", 8.0)
    got, want = eng.transcribe(path).to_dict(), one.transcribe(path)
    assert golden.result_mismatches(want.to_dict(), got) == []


@pytest.mark.parametrize("quantize", ["a8", "w8"])
def test_engine_a8_rejects_tensor_parallel(quantize):
    """The int8 kernel modes need a model axis of 1, as in the JAX engine
    (``tests/test_quant.py::test_engine_a8_rejects_tensor_parallel``);
    ``quantize=True`` serves there."""
    mesh = pm.build_mesh(MeshConfig(data=1, model=2), [CPU] * 2)
    with pytest.raises(ValueError, match="model-parallel axis 1"):
        TranscriptionEngine(config=tiny_config(), mesh=mesh,
                            quantize=quantize, speaker_mode="inline")


def test_engine_device_builds_a_one_device_mesh():
    eng = TranscriptionEngine(config=tiny_config(), device="cpu",
                              speaker_mode="inline")
    assert eng.mesh.shape == {"data": 1, "model": 1}
    assert eng.health_check() == {"devices": [{"id": "cpu", "ok": True}],
                                  "ok": True}
    mesh = pm.build_mesh(MeshConfig(data=3), [CPU] * 3)
    eng = TranscriptionEngine(config=tiny_config(), mesh=mesh,
                              speaker_mode="inline",
                              batch_windows_per_device=2)
    assert eng.batch_size == 6 and eng.shard_batch == 2
    assert len(eng.health_check()["devices"]) == 1   # distinct devices


# ---------------------------------------------------------------------------
# Data-parallel windows with the release weights
# ---------------------------------------------------------------------------

def _tiled_golden(path: Path, seconds: float) -> Path:
    with wave.open(str(golden.GOLDEN_WAV), "rb") as w:
        params = w.getparams()
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setparams(params)
        w.writeframes(np.resize(pcm, int(seconds * 16_000)).tobytes())
    path.write_bytes(buf.getvalue())
    return path


def _release_config(cls):
    return cls.from_json((RELEASE / "config.json").read_text(),
                         checkpoint_path=str(RELEASE / "asr.npz"))


@pytest.fixture(scope="module")
def dp_wav(tmp_path_factory):
    return _tiled_golden(tmp_path_factory.mktemp("dp") / "dp.wav",
                         DP_SECONDS)


def _port_engine(quantize, mesh=None, **kw):
    if mesh is None:
        kw["device"] = "cpu"
    return TranscriptionEngine(
        config=_release_config(PipelineConfig),
        xvector_path=str(RELEASE / "xvector.npz"), quantize=quantize,
        window_seconds=DP_WINDOW_SECONDS, mesh=mesh, **kw)


@pytest.mark.parametrize("quantize", [False, "a8"])
def test_data_parallel_engine_equals_one_shard_and_jax(dp_wav, quantize):
    """Two data shards of one window each equal one shard of two windows,
    result for result (the CPU twins of K1-K3, and K5 under "a8"), and
    the JAX engine on two host devices by the golden criteria."""
    from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
    from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build

    one = _port_engine(quantize, batch_windows_per_device=2)
    two = _port_engine(quantize, batch_windows_per_device=1,
                       mesh=pm.build_mesh(MeshConfig(data=2), [CPU] * 2))
    assert one.batch_size == two.batch_size == 2
    want_one = one.transcribe(dp_wav).to_dict()
    got = two.transcribe(dp_wav).to_dict()
    assert got == want_one
    assert two.last_trace.n_chips == 2
    jeng = JaxEngine(config=_release_config(JaxConfig),
                     xvector_path=str(RELEASE / "xvector.npz"),
                     quantize=quantize, window_seconds=DP_WINDOW_SECONDS,
                     batch_windows_per_device=1,
                     mesh=jax_build(JaxMeshConfig(data=2),
                                    devices=jax.devices()[:2]))
    want = dataclasses.asdict(jeng.transcribe(dp_wav))
    assert len(want["segments"]) >= 3
    assert golden.result_mismatches(want, got) == []


# ---------------------------------------------------------------------------
# The packed wire
# ---------------------------------------------------------------------------

WIRE_MODES = {
    "default": {},
    "beam-i8-stride": {"beam_size": 4, "spk_wire": "i8",
                       "spk_frame_stride": 2},
}


@pytest.mark.parametrize("mode", sorted(WIRE_MODES))
def test_layout_equals_jax_for_the_engine_spec(mode):
    """The port engine's fixed wire layout equals the JAX engine's (names,
    dtypes, shapes, offsets, sizes) for the same config and batch."""
    from omnilingual_asr_tpu.config import DecodeConfig as JaxDecode
    from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
    from omnilingual_asr_tpu.config import tiny_config as jax_tiny
    from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
    from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build

    dec = WIRE_MODES[mode]
    jeng = JaxEngine(config=jax_tiny().replace(decode=JaxDecode(**dec)),
                     speaker_mode="inline", batch_windows_per_device=3,
                     mesh=jax_build(JaxMeshConfig(data=1),
                                    devices=jax.devices()[:1]))
    teng = TranscriptionEngine(
        config=tiny_config().replace(decode=DecodeConfig(**dec)),
        speaker_mode="inline", batch_windows_per_device=3, device="cpu")
    assert teng._out_layout == jeng._out_layout


def test_pack_unpack_round_trip_bit_for_bit():
    rng = np.random.default_rng(0)
    tree = {
        "ctc_ids": torch.from_numpy(rng.integers(0, 512, (2, 8)).astype(
            np.int16)),
        "lid_conf": torch.from_numpy(rng.random((2, 8)).astype(np.float16)),
        "speaker_frames_q": torch.from_numpy(
            rng.integers(-127, 128, (2, 8, 4)).astype(np.int8)),
        "mask": torch.from_numpy(rng.random((2, 8)) > 0.5),
        "logp": torch.from_numpy(
            rng.standard_normal((2, 8, 3)).astype(np.float32)),
        "ids": torch.from_numpy(rng.integers(0, 9, (5,)).astype(np.int32)),
        "states": torch.from_numpy(rng.standard_normal(
            (3, 5)).astype(np.float32)).to(torch.bfloat16),
    }
    buf = pack_tree(tree)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    layout = layout_of(tree)
    assert [name for name, *_ in layout] == sorted(tree)
    assert sum(nb for *_, nb in layout) == buf.numel()
    out = unpack_buffer(buf.numpy(), layout)
    for k, v in tree.items():
        if v.dtype == torch.bfloat16:
            assert out[k].dtype == np.float32
            np.testing.assert_array_equal(out[k], v.to(torch.float32).numpy())
        else:
            assert out[k].dtype == v.numpy().dtype
            np.testing.assert_array_equal(out[k], v.numpy())
    spec = {k: (v.dtype, tuple(v.shape)) for k, v in tree.items()}
    assert layout_of(spec) == layout


@pytest.mark.parametrize("mode", sorted(WIRE_MODES))
def test_wire_pack_on_equals_off_bit_for_bit(mode, tmp_path):
    """Every window array, on and off, over a two-shard data mesh and two
    batches; with it on, one device-to-host copy a shard batch."""
    cfg = tiny_config()
    params = asr_init(torch.Generator().manual_seed(0), cfg)
    path = _tiled_golden(tmp_path / "w.wav", 25.0)
    outs = {}
    for pack in (True, False):
        c = cfg.replace(decode=DecodeConfig(wire_pack=pack,
                                            **WIRE_MODES[mode]))
        eng = TranscriptionEngine(
            config=c, params=params, speaker_mode="inline",
            window_seconds=5.0, batch_windows_per_device=2,
            mesh=pm.build_mesh(MeshConfig(data=2), [CPU] * 2))
        samples = eng._load_audio(path)
        windows = eng._windows(samples)
        n_last = len(samples) - (len(windows) - 1) * eng.window_samples
        outs[pack] = [o for b in eng._forward_batches(windows, n_last)
                      for o in b]
        n_batches = -(-len(windows) // eng.batch_size)
        n_leaves = len(eng._wire_spec(1))
        assert eng.d2h_copies == n_batches * 2 * (1 if pack else n_leaves)
    assert len(outs[True]) == len(outs[False]) == 5
    for a, b in zip(outs[True], outs[False]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
            elif isinstance(a[k], tuple):
                for x, y in zip(a[k], b[k]):
                    np.testing.assert_array_equal(x, y)
            else:
                assert a[k] == b[k], k
