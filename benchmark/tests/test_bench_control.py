"""The control of each cell on the card comes out not correct under the
committed limits: the serving cell's int8 path (``quantize="a8"``) and the
training cell's reference in fp8 in the program's place, at sizes a test
run holds (the cells' own sizes are read by ``benchmark.readings``)."""

import time

import pytest

from benchmark import harness as H

SPEC = H.load_spec()


def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_serving_control_fails():
    card()
    cell = H.resolve(SPEC, "release_translate_2min")
    cell.traffic.update(clients=2, n_files=2, warmup_requests_per_client=1,
                        check_requests=2)
    rec = H.generator("serve_closed_loop").run(
        cell, seed=2**31 + 21, seconds=2.0, trace=False,
        t_start=time.time(), control=True)
    assert not rec.correct, [(c.name, c.value) for c in rec.checks]


@pytest.mark.cuda
def test_training_control_fails():
    card()
    cell = H.resolve(SPEC, "d512_train_b64")
    cell.traffic.update(batch=8, pool_rows=32)
    rec = H.generator("train_pool").run(
        cell, seed=2**31 + 22, seconds=0.0, trace=False,
        t_start=time.time(), control=True)
    assert not rec.correct, [(c.name, c.value) for c in rec.checks]
