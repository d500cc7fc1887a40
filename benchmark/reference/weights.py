"""Weights for both sides: read from a committed ``.npz`` (keys in the
keystr layout ``['blocks'][0]['ffn1']['w1']['w']``) or drawn from the seed
on the card in a few large calls.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _path(key: str):
    return [m.group(1) if m.group(1) is not None else int(m.group(2))
            for m in _PART.finditer(key)]


def load_npz(path, device) -> dict:
    """A nested tree (dicts; lists where the keys index) of f32 tensors."""
    root: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = _path(key)
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(
                np.asarray(z[key], np.float32)).to(device)
    return _lists(root)


def _lists(node):
    if isinstance(node, dict):
        node = {k: _lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
    return node


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# The conformer's tree, drawn from the seed
# ---------------------------------------------------------------------------

N_LANGS, N_EMOTIONS, SPK_DIM, N_SPEAKER_CLASSES = 2048, 4, 256, 1024


def conformer_spec(cfg: dict):
    """The tree of (kind, shape, fan) leaves: ``dense`` U(+-1/sqrt(fan)),
    ``zeros``, ``ones``, ``unitcols`` (normal columns of unit norm)."""
    d, f, K = cfg["d_model"], cfg["d_model"] * cfg["ffn_mult"], \
        cfg["conv_kernel"]

    def dense(i, o, bias=True):
        p = {"w": ("dense", (i, o), i)}
        if bias:
            p["b"] = ("zeros", (o,), 0)
        return p

    def ln(n):
        return {"scale": ("ones", (n,), 0), "bias": ("zeros", (n,), 0)}

    def ffn():
        return {"ln": ln(d), "w1": dense(d, f), "w2": dense(f, d)}

    def block():
        return {"ffn1": ffn(),
                "mhsa": {"ln": ln(d), **{n: dense(d, d, False)
                                         for n in ("wq", "wk", "wv", "wo")}},
                "conv": {"ln": ln(d), "pw1": dense(d, 2 * d, False),
                         "dw": ("dense", (K, d), K), "dw_ln": ln(d),
                         "pw2": dense(d, d, False)},
                "ffn2": ffn(), "ln_out": ln(d)}

    return {
        "subsample": dense(cfg["subsample_factor"] * cfg["n_mels"], d),
        "in_ln": ln(d),
        "blocks": [block() for _ in range(cfg["n_layers"])],
        "ctc_head": dense(d, cfg["vocab_size"]),
        "lid_head": dense(d, N_LANGS),
        "emotion_head": dense(d, N_EMOTIONS),
        "speaker_head": dense(d, SPK_DIM),
        "spk_head2": dense(SPK_DIM, SPK_DIM),
        "spk_proj": dense(2 * SPK_DIM, SPK_DIM),
        "spk_aam": ("unitcols", (SPK_DIM, N_SPEAKER_CLASSES), 0),
    }


def seeded_tree(spec, seed: int, device) -> dict:
    """Every leaf of ``spec`` from two draws on ``device`` (one uniform,
    one normal, each over all leaves of its kind), f32."""
    specs = leaves(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_u = sum(math.prod(s) for k, s, _ in specs if k == "dense")
    n_n = sum(math.prod(s) for k, s, _ in specs if k == "unitcols")
    uni = torch.rand(n_u, generator=gen, device=device) * 2.0 - 1.0
    nor = torch.randn(max(n_n, 1), generator=gen, device=device)
    at = {"dense": 0, "unitcols": 0}

    def make(leaf):
        kind, shape, fan = leaf
        n = math.prod(shape)
        if kind == "zeros":
            return torch.zeros(shape, device=device)
        if kind == "ones":
            return torch.ones(shape, device=device)
        src = uni if kind == "dense" else nor
        x = src[at[kind]:at[kind] + n].reshape(shape).clone()
        at[kind] += n
        if kind == "dense":
            return x / math.sqrt(fan)
        return x / x.norm(dim=0, keepdim=True)

    return tree_map(make, spec)
