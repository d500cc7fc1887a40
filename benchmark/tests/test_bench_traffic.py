"""The generators make the same inputs from the same seed and other
inputs from another, with the same sizes."""

import numpy as np
import pytest
import torch

from benchmark import audio, harness as H

SPEC = H.load_spec()
SEEDS = (7, 2**31 + 11)


def test_golden_copy():
    x = audio.golden()
    assert abs(len(x) / audio.SAMPLE_RATE - 7.63) < 0.01
    assert np.abs(x).max() <= 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_tiled_files(seed):
    a = audio.tiled_file(np.random.default_rng([seed, 1]), 48_000)
    b = audio.tiled_file(np.random.default_rng([seed, 1]), 48_000)
    c = audio.tiled_file(np.random.default_rng([seed + 1, 1]), 48_000)
    assert a.dtype == np.int16 and a.shape == (48_000,)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_rows(seed):
    a = audio.pool_rows(seed, 4, 16_000, "cpu")
    b = audio.pool_rows(seed, 4, 16_000, "cpu")
    c = audio.pool_rows(seed + 1, 4, 16_000, "cpu")
    assert a.dtype == torch.int16 and a.shape == (4, 16_000)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert len({bytes(r.numpy()) for r in a}) == 4


def _train_cell():
    cell = H.resolve(SPEC, "d512_train_b64")
    cell.traffic.update(batch=4, row_seconds=2, pool_rows=16,
                        label_bytes=[10, 20])
    return cell


@pytest.mark.parametrize("seed", SEEDS)
def test_training_pool_and_feed(seed):
    gen = H.generator("train_pool")
    cell = _train_cell()
    p1 = gen.make_pool(cell.traffic, cell.config, seed, "cpu")
    p2 = gen.make_pool(cell.traffic, cell.config, seed, "cpu")
    p3 = gen.make_pool(cell.traffic, cell.config, seed + 1, "cpu")
    for k in p1:
        assert torch.equal(p1[k], p2[k])
    assert not torch.equal(p1["labels"], p3["labels"])
    lab, m = p1["labels"].long(), p1["label_mask"]
    assert ((lab[:, 1:] != lab[:, :-1]) | ~m[:, 1:]).all()   # no repeats
    assert ((lab >= 1) & (lab <= 256) | ~m).all()
    f1, f2 = gen.Feed(cell.traffic, seed, "cpu"), gen.Feed(cell.traffic,
                                                          seed, "cpu")
    rows = [f1.rows(k) for k in range(4)]
    assert torch.equal(torch.cat(rows).sort().values, torch.arange(16))
    assert torch.equal(f1.rows(5), f2.rows(5))
    for a, b in zip(f1.draws(3, 100), f2.draws(3, 100)):
        assert torch.equal(a, b)
    assert not torch.equal(f1.draws(3, 100)[2], f1.draws(4, 100)[2])
