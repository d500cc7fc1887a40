"""PyTorch port: the mixture-of-experts FFN, its all-to-all expert dispatch,
the MoE conformer and its loss, and the MoE engine, held to the JAX package
on the CPU.

The JAX side runs on the 8 host devices that ``tests/conftest.py`` forces;
the port's meshes are shards on the CPU. Parameters cross with
``zoo.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_torch import testing as golden
from omnilingual_asr_torch.config import MeshConfig, tiny_config
from omnilingual_asr_torch.engine import TranscriptionEngine
from omnilingual_asr_torch.models import conformer, moe, zoo
from omnilingual_asr_torch.parallel.expert_dispatch import ep_moe_apply
from omnilingual_asr_torch.parallel.mesh import Mesh, build_mesh
from omnilingual_asr_torch.train import step as port_step
from omnilingual_asr_tpu.config import MeshConfig as JaxMeshConfig
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.engine import TranscriptionEngine as JaxEngine
from omnilingual_asr_tpu.models import conformer as jax_conformer
from omnilingual_asr_tpu.models import moe as jax_moe
from omnilingual_asr_tpu.parallel.expert_dispatch import (
    ep_moe_apply as jax_ep_moe_apply)
from omnilingual_asr_tpu.parallel.mesh import build_mesh as jax_build_mesh
from omnilingual_asr_tpu.parallel.mesh import shard_params as jax_shard
from omnilingual_asr_tpu.train import step as jax_step

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: f32 MoE FFN (router, experts, combine) against the JAX one: max abs
#: difference over the largest magnitude (outputs and each gradient leaf).
MOE_REL = 1e-5
#: All-to-all dispatch against the JAX one (f32 on both sides; the port
#: runs each local expert as one matmul where JAX gathers a weight per
#: token, so sums go in another order).
EP_REL = 1e-5
#: A bf16 model against the JAX one (tests/test_torch_model.py's bound).
REL_MODEL = 3e-2
#: The Switch aux and the joint loss (scalars) of a bf16 model.
LOSS_REL = 1e-3


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _moe_setup(E=4, D=64, mult=2, seed=0, shape=(2, 16)):
    jp = jax_moe.moe_ffn_init(jax.random.PRNGKey(seed), D, E, mult)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, D)).astype(np.float32)
    return jp, zoo.params_from_jax(jp), x


def test_moe_ffn_apply_output_aux_and_grads_match_jax():
    jp, tp, x = _moe_setup()

    def jloss(p):
        y, aux = jax_moe.moe_ffn_apply(p, jnp.asarray(x))
        return jnp.sum(y ** 2) + 0.01 * aux

    want_y, want_aux = jax.jit(jax_moe.moe_ffn_apply)(jp, jnp.asarray(x))
    want_g = jax.jit(jax.grad(jloss))(jp)
    flat = zoo.flatten(tp)
    for v in flat.values():
        v.requires_grad_()
    y, aux = moe.moe_ffn_apply(tp, torch.from_numpy(x))
    assert _rel(y.detach().numpy(), want_y) <= MOE_REL
    assert abs(float(aux.detach()) - float(want_aux)) <= \
        MOE_REL * float(want_aux)
    (y.pow(2).sum() + 0.01 * aux).backward()
    want_flat = zoo.flatten(want_g)
    assert set(flat) == set(want_flat)
    for k, v in flat.items():
        assert _rel(v.grad.numpy(), np.asarray(want_flat[k])) <= MOE_REL, k
    assert float((flat["['router']['w']"].grad ** 2).sum()) > 0


def _tiny_moe(n_experts: int, **enc):
    jcfg, tcfg = jax_tiny_config(), tiny_config()
    jcfg = jcfg.replace(encoder=dataclasses.replace(
        jcfg.encoder, n_experts=n_experts, **enc))
    tcfg = tcfg.replace(encoder=dataclasses.replace(
        tcfg.encoder, n_experts=n_experts, **enc))
    return jcfg, tcfg


def test_moe_param_shapes_and_init():
    """The port's shape tree knows the MoE leaves, equal to the JAX init's;
    the port's own init draws that tree."""
    jcfg, tcfg = _tiny_moe(4)
    jp = jax.eval_shape(lambda: jax_conformer.asr_init(
        jax.random.PRNGKey(0), jcfg))
    want = {k: tuple(v.shape) for k, v in zoo.flatten(jp).items()}
    shapes = conformer.asr_param_shapes(tcfg)
    got = zoo.flatten(zoo._build(shapes,
                                 lambda path, shape: torch.empty(shape)))
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    init = conformer.asr_init(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in zoo.flatten(init).items()} == want


def _batch(rng, B=2, T=64, L=8):
    mel = rng.standard_normal((B, T, 128)).astype(np.float32)
    return {"mel": mel, "mask": np.ones((B, T), bool),
            "labels": rng.integers(1, 257, (B, L)).astype(np.int32),
            "label_mask": np.ones((B, L), bool),
            "lid_label": np.zeros((B,), np.int32),
            "emotion_label": np.zeros((B,), np.int32)}


def test_moe_asr_forward_and_loss_match_jax(tmp_path):
    """asr_forward with 4 experts (outputs and the summed aux), the
    release's loader on a MoE checkpoint, and loss_fn's moe_aux and
    total, against the JAX package's."""
    jcfg, tcfg = _tiny_moe(4)
    jp = jax_conformer.asr_init(jax.random.PRNGKey(0), jcfg)
    path = tmp_path / "moe.npz"
    zoo.save_checkpoint(path, zoo.params_from_jax(jp))
    tp = zoo.load_checkpoint(path, tcfg)
    batch = _batch(np.random.default_rng(0))
    want_out = jax.jit(lambda p, m, k: jax_conformer.asr_forward(
        p, m, k, jcfg))(jp, jnp.asarray(batch["mel"]),
                        jnp.asarray(batch["mask"]))
    got_out = conformer.asr_forward(tp, torch.from_numpy(batch["mel"]),
                                    torch.from_numpy(batch["mask"]), tcfg)
    for key in ("ctc_logits", "encoder_states"):
        assert _rel(got_out[key].numpy(), want_out[key]) <= REL_MODEL, key
    assert abs(float(got_out["moe_aux"]) - float(want_out["moe_aux"])) <= \
        LOSS_REL * float(want_out["moe_aux"])
    want_total, want_m = jax.jit(lambda p, b: jax_step.loss_fn(p, b, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got_total, got_m = port_step.loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert "moe_aux" in got_m and "moe_aux" in want_m
    assert abs(float(got_m["moe_aux"]) - float(want_m["moe_aux"])) <= \
        LOSS_REL * float(want_m["moe_aux"])
    assert abs(float(got_total) - float(want_total)) <= \
        LOSS_REL * abs(float(want_total))


def _expert_meshes(n: int):
    return (Mesh(np.asarray([CPU] * n, dtype=object), ("model",)),
            jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("model",)))


@pytest.mark.parametrize("n_dev,cf", [(4, 8.0), (8, 8.0), (4, 0.01),
                                      (8, 0.01)])
def test_ep_moe_apply_matches_jax(n_dev, cf):
    """Generous capacity (nothing drops) and capacity 0.01 (one slot a
    source and destination: most tokens drop). The same rows drop on both
    sides and keep their input exactly; the rest agree."""
    jp, tp, x = _moe_setup(E=8, D=64, shape=(128,))
    tmesh, jmesh = _expert_meshes(n_dev)
    want = np.asarray(jax.jit(lambda p, t: jax_ep_moe_apply(
        p, t, jmesh, capacity_factor=cf))(jp, jnp.asarray(x)))
    stats = {}
    got = ep_moe_apply(tp, torch.from_numpy(x), tmesh, capacity_factor=cf,
                       stats=stats).numpy()
    same_want = (want == x).all(axis=1)
    same_got = (got == x).all(axis=1)
    np.testing.assert_array_equal(same_got, same_want)
    assert stats["dropped"] == int(same_got.sum())
    if cf < 1:
        assert same_got.mean() > 0.3
    else:
        assert not same_got.any()
        dense, _ = jax_moe.moe_ffn_apply(jp, jnp.asarray(x)[None])
        assert _rel(got, np.asarray(dense)[0]) <= 2e-4
    assert _rel(got, want) <= EP_REL


def test_moe_conformer_alltoall_on_2x4_mesh_matches_jax():
    """moe_dispatch="alltoall" on a (data 2, model 4) mesh: the port's
    conformer against the JAX one under the same dispatch, and against its
    own dense dispatch at capacity 16 (nothing drops)."""
    jcfg, tcfg = _tiny_moe(8, moe_dispatch="alltoall",
                           moe_capacity_factor=16.0)
    jcfg = jcfg.replace(mesh=JaxMeshConfig(data=2, model=4))
    jp = jax_conformer.asr_init(jax.random.PRNGKey(1), jcfg)
    jmesh = jax_build_mesh(jcfg.mesh)
    sharded = jax_shard(jp, jax_conformer.asr_param_specs(jcfg), jmesh)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64, 128)).astype(np.float32)
    mask = np.ones((4, 64), bool)
    want = jax.jit(lambda p, m, k: jax_conformer.asr_forward(
        p, m, k, jcfg, mesh=jmesh))(sharded, jnp.asarray(x),
                                    jnp.asarray(mask))
    tp = zoo.params_from_jax(jp)
    tmesh = build_mesh(MeshConfig(data=2, model=4), [CPU] * 8)
    got = conformer.asr_forward(tp, torch.from_numpy(x),
                                torch.from_numpy(mask), tcfg, mesh=tmesh)
    dense_cfg = tcfg.replace(encoder=dataclasses.replace(
        tcfg.encoder, moe_dispatch="dense"))
    dense = conformer.asr_forward(tp, torch.from_numpy(x),
                                  torch.from_numpy(mask), dense_cfg)
    for key in ("ctc_logits", "encoder_states"):
        assert _rel(got[key].numpy(),
                    np.asarray(want[key], np.float32)) <= REL_MODEL, key
        assert _rel(got[key].numpy(), dense[key].numpy()) <= REL_MODEL, key
    assert float(got["moe_aux"]) == 0.0


RELEASE = Path(__file__).resolve().parents[1] / "checkpoints" / "release"
#: Experts grafted onto the release model and the router's scale: the
#: router's logits are large, so almost every gate is near 1 and the
#: engine's text is the release model's.
GRAFT_EXPERTS, ROUTER_SCALE = 4, 30.0


def _graft_moe(tree, n_experts: int, seed: int):
    """The release tree with each block's second FFN made a mixture of
    ``n_experts`` copies of it behind a random router (numpy leaves)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, tree)
    for blk in out["blocks"]:
        f = blk["ffn2"]
        d = f["w1"]["w"].shape[0]
        blk["ffn2"] = {
            "ln": f["ln"],
            "router": {"w": (ROUTER_SCALE * rng.standard_normal(
                (d, n_experts))).astype(np.float32)},
            "w1": np.stack([f["w1"]["w"]] * n_experts),
            "b1": np.stack([f["w1"]["b"]] * n_experts),
            "w2": np.stack([f["w2"]["w"]] * n_experts),
            "b2": np.stack([f["w2"]["b"]] * n_experts)}
    return out


def test_moe_engine_transcribe_matches_jax():
    """The MoE engine in window mode (dense dispatch, one device): the
    release model with its second FFNs grafted into 4 experts, on the
    golden file, against the JAX engine with the same tree, by the golden
    criteria (texts, speakers, languages, emotions exact; times within 40
    ms; greedy ids on 99.5 % of frames)."""
    from omnilingual_asr_torch.config import PipelineConfig
    from omnilingual_asr_tpu.config import PipelineConfig as JaxConfig
    from omnilingual_asr_tpu.models.zoo import load_checkpoint as jax_load

    text = (RELEASE / "config.json").read_text()
    jcfg = JaxConfig.from_json(text)
    jcfg = jcfg.replace(encoder=dataclasses.replace(
        jcfg.encoder, n_experts=GRAFT_EXPERTS))
    tcfg = PipelineConfig.from_json(text)
    tcfg = tcfg.replace(encoder=dataclasses.replace(
        tcfg.encoder, n_experts=GRAFT_EXPERTS))
    tree = _graft_moe(jax_load(str(RELEASE / "asr.npz"),
                               JaxConfig.from_json(text)), GRAFT_EXPERTS, 0)
    xv = str(RELEASE / "xvector.npz")
    jeng = JaxEngine(config=jcfg, params=jax.tree.map(jnp.asarray, tree),
                     xvector_path=xv, batch_windows_per_device=1,
                     mesh=jax_build_mesh(JaxMeshConfig(data=1),
                                         devices=jax.devices()[:1]))
    teng = TranscriptionEngine(config=tcfg,
                               params=zoo.params_from_jax(tree),
                               xvector_path=xv, device="cpu",
                               batch_windows_per_device=1)
    want = dataclasses.asdict(jeng.transcribe(golden.GOLDEN_WAV))
    got = teng.transcribe(golden.GOLDEN_WAV).to_dict()
    assert len(want["segments"]) >= 2
    assert golden.result_mismatches(want, got) == []
    stored = golden.load_golden()["result"]
    assert [s["text"] for s in got["segments"]] == \
        [s["text"] for s in stored["segments"]]
