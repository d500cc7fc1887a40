"""PyTorch port: pipeline stages (``parallel/pipeline.py``) held to the JAX
package on the CPU, and to the port's own sequential blocks."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.models import layers, zoo
from omnilingual_asr_torch.parallel.mesh import Mesh
from omnilingual_asr_torch.parallel.pipeline import (apply_stacked_blocks,
                                                     pipeline_forward,
                                                     stack_blocks)
from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models.conformer import (
    conformer_block_init as jax_block_init)
from omnilingual_asr_tpu.models.layers import rope_angles as jax_rope
from omnilingual_asr_tpu.parallel.pipeline import (
    apply_stacked_blocks as jax_apply_stacked)
from omnilingual_asr_tpu.parallel.pipeline import (
    pipeline_forward as jax_pipeline_forward)
from omnilingual_asr_tpu.parallel.pipeline import (
    stack_blocks as jax_stack_blocks)

torch.set_num_threads(2)

#: bf16 conformer blocks against the JAX ones (tests/test_torch_model.py's
#: bound for a model: max abs difference over the largest magnitude).
REL_MODEL = 3e-2
N_LAYERS, B, T = 4, 2, 64


@pytest.fixture(scope="module")
def blocks():
    jcfg = jax_tiny_config()
    key = jax.random.PRNGKey(0)
    jblocks = [jax_block_init(jax.random.fold_in(key, i), jcfg.encoder)
               for i in range(N_LAYERS)]
    jstacked = jax_stack_blocks(jblocks)
    tstacked = stack_blocks([zoo.params_from_jax(b) for b in jblocks])
    return jcfg, tiny_config(), jstacked, tstacked


def _inputs(M: int, seed: int, d: int):
    rng = np.random.default_rng(seed)
    x_mb = rng.standard_normal((M, B, T, d)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 50:] = False
    return x_mb, mask


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("S,M", [(2, 2), (2, 4), (4, 4), (1, 3)])
def test_pipeline_forward_matches_jax(blocks, S, M):
    """Distinct microbatches through S stages: the port against the JAX
    pipeline (REL_MODEL), and equal to its own sequential blocks."""
    jcfg, tcfg, jstacked, tstacked = blocks
    d = tcfg.encoder.d_model
    x_mb, mask = _inputs(M, S * 10 + M, d)
    jcos, jsin = jax_rope(T, tcfg.encoder.head_dim)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:S]), ("stage",))
    want = np.asarray(jax.jit(lambda st, x, m, c, s: jax_pipeline_forward(
        st, x, m, c, s, jcfg, jmesh))(jstacked, jnp.asarray(x_mb),
                                      jnp.asarray(mask), jcos, jsin))
    tmesh = Mesh(np.asarray([torch.device("cpu")] * S, dtype=object),
                 ("stage",))
    cos, sin = layers.rope_angles(T, tcfg.encoder.head_dim)
    got = pipeline_forward(tstacked, torch.from_numpy(x_mb),
                           torch.from_numpy(mask), cos, sin, tcfg, tmesh)
    assert got.shape == x_mb.shape
    for m in range(M):
        assert _rel(got[m].numpy(), want[m]) <= REL_MODEL, m
        seq = apply_stacked_blocks(tstacked, torch.from_numpy(x_mb[m]),
                                   torch.from_numpy(mask), cos, sin, tcfg,
                                   torch.bfloat16)
        torch.testing.assert_close(got[m], seq, rtol=0, atol=0)


def test_apply_stacked_blocks_matches_jax(blocks):
    jcfg, tcfg, jstacked, tstacked = blocks
    x_mb, mask = _inputs(1, 0, tcfg.encoder.d_model)
    jcos, jsin = jax_rope(T, tcfg.encoder.head_dim)
    want = np.asarray(jax_apply_stacked(jstacked, jnp.asarray(x_mb[0]),
                                        jnp.asarray(mask), jcos, jsin, jcfg,
                                        jnp.bfloat16))
    cos, sin = layers.rope_angles(T, tcfg.encoder.head_dim)
    got = apply_stacked_blocks(tstacked, torch.from_numpy(x_mb[0]),
                               torch.from_numpy(mask), cos, sin, tcfg,
                               torch.bfloat16)
    assert _rel(got.numpy(), want) <= REL_MODEL


def test_pipeline_refuses_uneven_stages(blocks):
    _, tcfg, _, tstacked = blocks
    x_mb, mask = _inputs(2, 0, tcfg.encoder.d_model)
    cos, sin = layers.rope_angles(T, tcfg.encoder.head_dim)
    mesh = Mesh(np.asarray([torch.device("cpu")] * 3, dtype=object),
                ("stage",))
    with pytest.raises(ValueError, match="stages"):
        pipeline_forward(tstacked, torch.from_numpy(x_mb),
                         torch.from_numpy(mask), cos, sin, tcfg, mesh)
