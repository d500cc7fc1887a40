"""Checkpoints without JAX, and named configurations.

A release is one float16 ``.npz`` per model, written by the JAX package's
``models/zoo.py::save_release``. Its keys are ``jax.tree_util.keystr``
paths such as ``['blocks'][0]['mhsa']['wq']['w']``. This module parses
them into the port's parameter tree (nested dicts and lists of f32 tensors,
the JAX package's structure), validates every leaf against the shape tree
of the configuration, and casts up on load. :func:`save_checkpoint` writes
the same layout in f32 (the port's training checkpoints), which this
module's and the JAX package's ``load_checkpoint`` both read.

A path that is not an ``.npz`` is an Orbax checkpoint directory, the
layout of the JAX package's ``save_checkpoint``: :func:`load_checkpoint`
reads it and :func:`save_checkpoint` writes it through
``checkpoint/orbax.py``, without JAX.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import EncoderConfig, PipelineConfig
from .conformer import asr_param_shapes
from .xvector import xvector_param_shapes

_KEY_PART = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def base_config() -> PipelineConfig:
    """The reference's ~80M-parameter conformer: the default single-card
    serving model."""
    return PipelineConfig()


def large_config() -> PipelineConfig:
    """The reference's ~300M-parameter conformer (head dim 128)."""
    return PipelineConfig(encoder=EncoderConfig(
        d_model=1024, n_layers=16, n_heads=8, ffn_mult=4, conv_kernel=32))


def parse_keystr(key: str):
    """``"['blocks'][0]['w']"`` -> ``("blocks", 0, "w")``."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            raise ValueError(f"malformed checkpoint key {key!r}")
        parts.append(m.group(1) if m.group(1) is not None
                     else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"malformed checkpoint key {key!r}")
    return tuple(parts)


def keystr(path) -> str:
    """Inverse of :func:`parse_keystr`."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def _build(shapes, fetch, path=()):
    if isinstance(shapes, dict):
        return {k: _build(v, fetch, path + (k,)) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_build(v, fetch, path + (i,)) for i, v in enumerate(shapes)]
    return fetch(path, tuple(shapes))


def tree_from_arrays(arrays: dict, shapes, source: str, device="cpu"):
    """Build a parameter tree from ``{keystr: array}`` against ``shapes``.

    Raises KeyError for a missing leaf and ValueError for a wrong shape.

    The loaders default to ``device="cpu"``: they only read a file into
    host tensors, which every caller then places (unlike the compute
    entry points, which default to the card).
    """
    def fetch(path, shape):
        key = keystr(path)
        if key not in arrays:
            raise KeyError(f"{source} is missing {key}")
        x = np.asarray(arrays[key])
        if tuple(x.shape) != shape:
            raise ValueError(f"{source}: {key} has shape {x.shape}, model "
                             f"expects {shape}")
        return torch.from_numpy(x.astype(np.float32)).to(device)

    return _build(shapes, fetch)


def flatten(tree, path=()):
    """``{keystr: tensor}`` over a parameter tree's leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, path + (i,)))
        return out
    return {keystr(path): tree}


def save_checkpoint(path, params) -> None:
    """Write a parameter tree, atomically, where both packages'
    ``load_checkpoint`` read it.

    A path ending in ``.npz`` gets one f32 ``.npz`` (keystr keys): the
    port's training checkpoint, the release's layout at full precision.
    Any other path gets an Orbax checkpoint directory, as the JAX
    package's ``save_checkpoint`` writes for any path: floating leaves in
    f32, integer and boolean leaves kept."""
    if Path(path).suffix == ".npz":
        _save_npz(path, {k: v.detach().to(torch.float32).cpu().numpy()
                         for k, v in flatten(params).items()})
        return
    from ..checkpoint import orbax

    orbax.write_flat(path, {
        parse_keystr(k): (v.detach().to(torch.float32)
                          if v.is_floating_point() else v.detach())
        .cpu().numpy()
        for k, v in flatten(params).items()})


def save_release(path, params) -> None:
    """Write a parameter tree as one float16 ``.npz`` (keystr keys;
    integer leaves keep their dtype), atomically: the layout of the JAX
    package's ``save_release``, which this module's and the JAX package's
    ``load_release`` read."""
    flat = {}
    for k, v in flatten(params).items():
        x = v.detach().cpu().numpy()
        flat[k] = x.astype(np.float16) if x.dtype.kind == "f" else x
    _save_npz(path, flat)


def _save_npz(path, flat: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / (path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    tmp.replace(path)


def resolve_checkpoint(path, name: str) -> Path:
    """The checkpoint ``name`` (``"asr"``, ``"translator"``) that ``path``
    names, as the trainers' ``--ckpt``, ``--init-from`` and
    ``--resume-from`` take it: ``path`` itself when it is an ``.npz`` or an
    Orbax checkpoint directory; else the directory's ``<name>.npz`` (the
    port's trainers write it) or its Orbax ``<name>/`` (the JAX package's
    trainers), whichever exists (the ``.npz`` when neither does)."""
    from ..checkpoint.orbax import is_checkpoint

    path = Path(path)
    if path.suffix == ".npz" or is_checkpoint(path):
        return path
    npz = path / f"{name}.npz"
    if not npz.exists() and is_checkpoint(path / name):
        return path / name
    return npz


def checkpoint_path(out, name: str) -> Path:
    """Where a trainer's ``--out`` puts its ``.npz``: ``out`` itself when it
    names an ``.npz`` file, else ``out/name`` (``translator.npz``,
    ``summarizer.npz``: the names the engine finds in a release directory).
    """
    out = Path(out)
    return out if out.suffix == ".npz" else out / name


def read_arrays(path):
    """``({keystr: array}, source)`` of an ``.npz`` or of an Orbax
    checkpoint directory (any other path); ``source`` names it in
    errors."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        for k in arrays:
            parse_keystr(k)
        return arrays, f"release checkpoint {path}"
    from ..checkpoint import orbax

    return ({keystr(p): a for p, a in orbax.read_flat(path).items()},
            f"Orbax checkpoint {path}")


def load_release(path, shapes, device="cpu"):
    """Load a release ``.npz`` (or an Orbax directory) against a shape
    tree (on the CPU unless ``device`` says otherwise: see
    :func:`tree_from_arrays`)."""
    arrays, source = read_arrays(path)
    return tree_from_arrays(arrays, shapes, source, device)


def load_checkpoint(path, cfg: PipelineConfig, device="cpu"):
    """Load the ASR parameters of an ``.npz`` or of an Orbax checkpoint
    directory (the JAX package's ``save_checkpoint``), validated against
    the configuration's shape tree (host tensors unless ``device`` says
    otherwise)."""
    return load_release(path, asr_param_shapes(cfg), device)


def load_xvector(path, cfg: PipelineConfig, device="cpu"):
    """Load x-vector embedder parameters from a release ``.npz`` (host
    tensors unless ``device`` says otherwise)."""
    return load_release(path, xvector_param_shapes(cfg), device)


def params_from_jax(tree, device="cpu"):
    """Carry a JAX parameter tree (nested dicts/lists, leaves convertible
    with ``numpy.asarray``) across into the port's parameter structure, on
    ``device``. Floating leaves become f32 tensors; integer and boolean
    leaves (a quantized tree's int8 ``w_q``) keep their dtype. Host
    tensors unless ``device`` says otherwise: the callers place them."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    x = np.array(tree, copy=True)
    if x.dtype.kind not in "iub":
        x = x.astype(np.float32)
    return torch.from_numpy(x).to(device)


def tree_to(tree, device):
    """Move every tensor of a parameter tree to ``device``, dtypes
    unchanged."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def default_release_dir() -> Optional[Path]:
    """The in-repo shipped-checkpoint directory, if present.

    Resolution order: ``$OMNIASR_RELEASE_DIR`` (an empty value disables
    discovery), then ``checkpoints/release`` next to the package. Returns
    None when neither exists.
    """
    env = os.getenv("OMNIASR_RELEASE_DIR")
    if env is not None:
        p = Path(env)
        return p if env and p.is_dir() else None
    repo = Path(__file__).resolve().parent.parent.parent
    p = repo / "checkpoints" / "release"
    return p if p.is_dir() else None
