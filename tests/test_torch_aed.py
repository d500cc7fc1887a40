"""PyTorch port: the AED model family (``models/aed.py``) against the JAX
package.

Small sizes only (``tiny_config``: d_model 128, 2 layers, 2 heads; a
decoder of 2 layers). The JAX parameters are carried across with
``models.zoo.params_from_jax``; inputs are made from a seed with numpy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnilingual_asr_tpu.config import tiny_config as jax_tiny_config
from omnilingual_asr_tpu.models import aed as jax_aed
from omnilingual_asr_tpu.models import translation as jax_translation
from omnilingual_asr_tpu.ops.ctc import text_to_byte_labels
from omnilingual_asr_torch import testing
from omnilingual_asr_torch.config import tiny_config
from omnilingual_asr_torch.models import aed, zoo

torch.set_num_threads(2)

#: The conformer's whole-model tolerance (tests/test_torch_model.py's
#: REL_MODEL): max |got - want| within 3e-2 of max |want|, for bf16 matmul
#: operands rounded from f32 sums in another order through the encoder; the
#: decoder adds its own 2^-8 on top of the encoder states' difference.
REL_MODEL = 3e-2


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rel, f"relative max error {err:.3e} > {rel}"


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    jp = jax_aed.aed_init(jax.random.PRNGKey(0), jcfg, decoder_layers=2)
    rng = np.random.default_rng(1)
    B, T, L = 2, 128, 12
    mel = (rng.standard_normal((B, T, 128)) * 2.0 - 5.0).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, 96])[:, None]
    labels = np.zeros((B, L), np.int32)
    lmask = np.zeros((B, L), bool)
    for i, text in enumerate(("hey there", "привет")):
        labels[i], lmask[i] = text_to_byte_labels(text, jcfg.vocab, L)
    batch = {"mel": mel, "mask": mask, "labels": labels,
             "label_mask": lmask}
    return jcfg, cfg, jp, batch


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_aed_forward_matches_jax(case):
    """``aed_forward`` (teacher-forced) from the JAX tree: the CTC and the
    decoder logits within ``REL_MODEL``; the subsampled mask equal."""
    jcfg, cfg, jp, b = case
    tokens = b["labels"]
    want = jax_aed.aed_forward(jp, jnp.asarray(b["mel"]),
                               jnp.asarray(b["mask"]), jnp.asarray(tokens),
                               jcfg)
    got = aed.aed_forward(zoo.params_from_jax(jp), torch.from_numpy(b["mel"]),
                          torch.from_numpy(b["mask"]),
                          torch.from_numpy(tokens), cfg)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert got["dec_logits"].shape == (2, 12, cfg.vocab.vocab_size)
    for k in ("ctc_logits", "dec_logits"):
        _close(got[k].detach().numpy(), np.asarray(want[k]), REL_MODEL)


def test_aed_loss_and_parts_match_jax(case):
    """``aed_loss`` and its CTC and CE parts within 1e-3 relative (the
    joint training loss's tolerance, tests/test_torch_train.py: bf16
    operands a ulp apart move a mean by ~1e-4); its gradient reaches the
    encoder and the decoder."""
    jcfg, cfg, jp, b = case
    _, jm = jax_aed.aed_loss(jp, {k: jnp.asarray(v) for k, v in b.items()},
                             jcfg)
    tp = zoo.params_from_jax(jp)
    for leaf in zoo.flatten(tp).values():
        leaf.requires_grad_(True)
    total, m = aed.aed_loss(tp, _port(b), cfg)
    assert set(m) == set(jm) == {"loss", "ctc", "ce"}
    for k in jm:
        got = float(m[k].detach())
        assert abs(got - float(jm[k])) <= 1e-3 * abs(float(jm[k])), k
    total.backward()
    assert float(tp["encoder"]["subsample"]["w"].grad.abs().max()) > 0
    assert float(tp["decoder"]["embed"].grad.abs().max()) > 0


def test_aed_greedy_decode_equals_jax_where_decisions_are_firm(case):
    """``aed_greedy_decode`` ids equal the JAX decode's exactly on a case
    whose every free choice is firm: the decoder's output layer scaled up
    so that each chosen token leads its runner-up among the byte classes
    (the decode's choices) by at least ``testing.MIN_TOKEN_GAP`` in the JAX
    logits (the gaps are measured here
    from a teacher-forced JAX forward over the decoded prefix, as
    ``golden_decoders.json`` stores them for the release decoders)."""
    jcfg, cfg, jp, b = case
    jp = dict(jp, decoder=dict(jp["decoder"], out={
        "w": jp["decoder"]["out"]["w"] * 40.0,
        "b": jp["decoder"]["out"]["b"]}))
    max_len = 20
    want = np.asarray(jax_aed.aed_greedy_decode(
        jp, jnp.asarray(b["mel"]), jnp.asarray(b["mask"]), jcfg,
        max_len=max_len))
    from omnilingual_asr_tpu.models.conformer import asr_forward

    enc = asr_forward(jp["encoder"], jnp.asarray(b["mel"]),
                      jnp.asarray(b["mask"]), jcfg)
    dec_in = np.concatenate([np.zeros((2, 1), np.int32), want[:, :-1]], 1)
    logits = np.asarray(jax_translation.decoder_forward(
        jp["decoder"], jnp.asarray(dec_in), enc["encoder_states"],
        enc["mask"], jcfg, n_heads=jcfg.encoder.n_heads))
    logits = logits[..., :1 + jcfg.vocab.n_bytes]   # the decode's choices
    gaps = []
    for r in range(2):
        eos = np.flatnonzero(want[r] == 0)
        n = int(eos[0]) + 1 if eos.size else max_len
        top2 = np.sort(logits[r, :n], axis=-1)[:, -2:]
        assert (np.argmax(logits[r, :n], -1) == want[r, :n]).all()
        gaps.extend(top2[:, 1] - top2[:, 0])
    assert min(gaps) >= testing.MIN_TOKEN_GAP, min(gaps)
    got = aed.aed_greedy_decode(zoo.params_from_jax(jp),
                                torch.from_numpy(b["mel"]),
                                torch.from_numpy(b["mask"]), cfg,
                                max_len=max_len).numpy()
    assert got.shape == (2, max_len) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(set(want[0].tolist())) > 1


def test_aed_init_tree_matches_jax(case):
    """``aed_init`` builds the JAX tree's structure and shapes (so a JAX
    AED checkpoint carries across leaf for leaf)."""
    jcfg, cfg, jp, _ = case
    mine = zoo.flatten(aed.aed_init(torch.Generator().manual_seed(0), cfg,
                                    decoder_layers=2))
    theirs = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
              jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k: tuple(v.shape) for k, v in mine.items()} == theirs
