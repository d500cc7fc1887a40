"""The yardstick's arithmetic: hand counts at tiny dims, and the bounds
the port's card smoke test (``chip_smoke.py``) printed for the shapes of
PERF.md's kernel table (read from its output, not imported)."""

import math

import pytest

from benchmark import roofline as R


def test_bound_is_the_larger_time():
    ms, by = R.bound({"bf16": 989e9}, 1)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = R.bound({"f32": 1.0}, 3.35e9)
    assert ms == pytest.approx(1.0) and by == "bytes"


def test_hand_counts():
    # B 1, T 2, H 1, D 2, 2 valid keys: 4 * 1 * 2 * 2 * 2 FLOPs; q, k, v
    # and o bf16 (4 * 4 * 2 B), the int32 mask (8 B), lse f32 (8 B).
    assert R.k2_attn_fwd(1, 2, 1, 2, 2) == ({"bf16": 32}, 48)
    flops, n_bytes = R.k3_conv_module(1, 2, 2, 3)
    assert flops == {"bf16": 2 * 2 * 2 * 6, "f32": 2 * 2 * 2 * 3}
    assert n_bytes == 2 * 2 * 2 * 4 + 2 + 3 * 4 * 2 + 3 * 2 * 4 + 32
    assert R.k6_attn_bwd_dq(1, 2, 1, 2, 2)[0] == {"bf16": 6 * 8}
    assert R.k7_attn_bwd_dkv(1, 2, 1, 2, 2)[0] == {"bf16": 8 * 8}
    assert R.k1_mel(1, 4, 2, 3)[0] == {"f32": 2.5 * 4 * 2 + 6}


@pytest.mark.parametrize("op, printed", [
    (R.k2_attn_fwd(4, 768, 4, 64, 768 + 700 + 300), 0.0018963868656716417),
    (R.k2_attn_fwd(16, 256, 8, 64, 256 * 12 + 200 + 77 + 1),
     0.005052140895522388),
    (R.k3_conv_module(4, 768, 256, 32), 0.002007345671641791),
    (R.k3_conv_module(16, 256, 512, 32), 0.008517355782865249),
    (R.k6_attn_bwd_dq(16, 256, 8, 64, 256 * 12 + 200 + 77 + 1),
     0.006343297910447761),
    (R.k7_attn_bwd_dkv(16, 256, 8, 64, 256 * 12 + 200 + 77 + 1),
     0.007595328955223881)])
def test_bounds_printed_by_the_card_smoke_test(op, printed):
    assert R.call_bound_ms(op) == pytest.approx(printed, rel=1e-12)


def test_encoder_flops_per_frame_flagship():
    """~153 MFLOP a frame at d512 x 12 over 200 keys (a hand count:
    46 d^2 a block, attention 4 T d, the heads)."""
    f = R.encoder_flops_per_frame(512, 12, 4, 32, 128, 4, 200, 512)
    d = 512
    by_hand = (2 * 512 * d + 12 * (46 * d * d + 4 * 200 * d + 2 * d * 32)
               + 2 * d * (512 + 2048 + 4 + 256) + 2 * 256 * 256)
    assert f == by_hand
    assert 150e6 < f < 156e6


def test_decoder_and_xvector_counts():
    assert R.decoder_step_flops(4, 1, 8, 0, 3) == (
        2 * 4 * 12 + 2 * 16 + 4 * 4 + 2 * 16 + 2 * 16 + 4 * 3 * 4
        + 2 * 2 * 4 * 16 + 2 * 4 * 8)
    assert R.decoder_memory_flops(4, 2, 3) == 2 * 3 * 2 * 4 * 8
    x = R.xvector_flops_per_frame(128)
    assert x == (2 * 2 * 5 * 128 * 128 + 2 * 5 * 128 * 256
                 + 3 * 2 * 3 * 256 * 256 + 2 * 256 * 256)
    assert R.train_step_flops(10, 2.0) == 60.0
    assert math.isclose(R.MFU_PEAK, 989e12)
