"""The processes of ``tests/test_torch_multiprocess.py`` (imports no JAX).

Each job is one update of the port's train or pretrain step over a
(data, model) mesh, from inputs the test wrote: run by :func:`main` in each
of two processes joined by ``parallel.mesh.init_distributed`` over gloo
(each process one data row and its model shards on the CPU), and by
:func:`run_job` in the test's own process over the single-process mesh of
the same global shape. A job may patch module attributes for its run: the
JAX package's random draws in place of the port's, bf16 rounding taken out,
or a planted fault.
"""

from __future__ import annotations

import contextlib
import pickle
import sys
import traceback
from pathlib import Path

import torch

CPU = torch.device("cpu")


def _patches(job, rank):
    """(module, attribute, value) for each patch the job names."""
    from omnilingual_asr_torch.models import conformer, layers
    from omnilingual_asr_torch.parallel import tensor
    from omnilingual_asr_torch.train import augment, mesh_step

    out = []
    for name in job.get("patches", ()):
        if name == "f32":
            out.append((layers, "round_to",
                        lambda x, dtype: x.to(torch.float32)))
        elif name == "jax_draws":
            aug, keep = job["jax_aug"], job["jax_keep"]

            def spec_augment(gen, mel, mask, cfg):
                assert tuple(mel.shape) == tuple(aug.shape)
                return aug.to(mel.device)

            def dropout_mask(shape, rate, seed, salt, device):
                assert tuple(shape) == tuple(keep[salt].shape)
                return keep[salt].to(device)

            out += [(augment, "spec_augment", spec_augment),
                    (conformer, "dropout_mask", dropout_mask)]
        elif name == "speaker":         # the term counted once a process
            out.append((mesh_step, "loss_tree", lambda p0, part=(0, 1): p0))
        elif name == "batch":           # each process its own batch
            out.append((mesh_step, "broadcast_batch",
                        lambda batch, device: batch))
        elif name == "allreduce":       # no sum over the processes
            out.append((tensor, "process_all_reduce_many", list))
        else:
            raise ValueError(f"unknown patch {name!r}")
    return out


@contextlib.contextmanager
def _patched(items):
    saved = [(m, a, getattr(m, a)) for m, a, _ in items]
    try:
        for m, a, v in items:
            setattr(m, a, v)
        yield
    finally:
        for m, a, v in reversed(saved):
            setattr(m, a, v)


def run_job(job, mesh, rank: int = 0):
    """One update of ``job`` over ``mesh`` -> (loss, whole leaves'
    gradients, whole leaves' clipped gradients), as numpy. Rank 0 takes
    ``job["batch"]``; another rank ``job["other_batch"]``, which the step
    must replace with rank 0's."""
    from omnilingual_asr_torch.train import pretrain, step

    batch = job["batch"] if rank == 0 else job["other_batch"]
    tx = step.make_optimizer(**job["opt"])
    with _patched(_patches(job, rank)):
        if job["kind"] == "pretrain":
            init, _, lg = pretrain.make_pretrain_step(
                job["cfg"], mesh, job["pcfg"], tx=tx)
            mp = init.place(job["params"])
            metrics, g = lg(mp, job["quantizer"], batch, job["step"],
                            draws=job.get("draws"))
        else:
            init, _, lg = step.make_train_step(
                job["cfg"], mesh, tx=tx, augment=job["augment"],
                with_translator=job["translator"], dropout=True)
            mp = init.place(job["params"])
            metrics, g = lg(mp, batch, job["step"])
        clipped = tx.clip_and_zero_nans(g, mp.counted(g))
    return (float(metrics["loss"]),
            [x.detach().numpy() for x in mp.merge(g)],
            [x.detach().numpy() for x in mp.merge(clipped)])


def _refusals():
    """What start-up and the mesh refuse in a process of two: a model
    group over both processes, and serving over a mesh that spans them."""
    from omnilingual_asr_torch.config import MeshConfig
    from omnilingual_asr_torch.engine import TranscriptionEngine
    from omnilingual_asr_torch.parallel import mesh as pm

    out = {}
    try:
        pm.build_mesh(MeshConfig(data=1, model=2), [CPU])
        out["model_group"] = "built"
    except NotImplementedError as e:
        out["model_group"] = str(e)
    try:
        TranscriptionEngine(mesh=pm.build_mesh(MeshConfig(data=2), [CPU]))
        out["engine"] = "built"
    except NotImplementedError as e:
        out["engine"] = str(e)
    return out


def main(rank: int, port: int, inputs: str, out_dir: str) -> None:
    """Process ``rank`` of two: join, run every job, write the results to
    ``out_dir/rank<rank>.pkl``."""
    torch.set_num_threads(2)
    from omnilingual_asr_torch.config import MeshConfig
    from omnilingual_asr_torch.parallel import mesh as pm

    with open(inputs, "rb") as f:
        jobs = pickle.load(f)
    assert pm.init_distributed(f"127.0.0.1:{port}", 2, rank, devices=[CPU],
                               timeout_s=120.0)
    try:
        out = {"backend": pm.distributed_backend(),
               "index": pm.process_index(), "count": pm.process_count(),
               "refusals": _refusals(), "jobs": {}}
        for job in jobs:
            model = job["model"]
            mesh = pm.build_mesh(MeshConfig(data=2, model=model),
                                 [CPU] * model)
            out["processes"] = mesh.processes.tolist()
            pm.process_bytes(reset=True)
            out["jobs"][job["name"]] = run_job(job, mesh, rank) + (
                pm.process_bytes(),)
        Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    finally:
        pm.shutdown_distributed()
