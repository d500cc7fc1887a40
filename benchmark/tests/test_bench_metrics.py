"""Each per-layer reader on a recorded fake run."""

import pytest

from benchmark import harness as H, roofline


def rd(name):
    return H.metric_reader(name)


def trace(ops, start=0.0, end=1.0, host=()):
    return H.DeviceTrace(list(ops), start, end, list(host))


def test_idle_share_counts_overlap_once():
    # Two streams overlap over [0.2, 0.3]; the union is [0.1, 0.4] and
    # [0.6, 0.7]: busy 0.4 of 1 s.
    t = trace([("k_a", 0.1, 0.3), ("k_b", 0.2, 0.4), ("Memcpy HtoD", 0.6,
                                                      0.7)])
    rec = H.Record(trace=t)
    for cell in ("serve", "train"):
        assert rd(f"device_idle_share.{cell}")(rec) == pytest.approx(60.0)
    assert t.busy_s == pytest.approx(0.4)
    assert H.Record().trace is None
    assert rd("device_idle_share.serve")(H.Record()) is None


def test_ops_outside_the_slice_are_clipped():
    t = trace([("k", -0.5, 0.25), ("k", 0.9, 1.5)])
    assert t.busy_s == pytest.approx(0.35)
    # One gap, from the first operation's clipped end to the second's
    # clipped start.
    assert t.breakdown()["idle_gaps"] == [["none", pytest.approx(0.65)]]


def test_breakdown_labels_gaps_by_host_activity():
    t = trace([("k", 0.0, 0.1), ("k", 0.5, 1.0)],
              host=[("assemble.translate", 0.05, 0.4)])
    b = t.breakdown()
    assert b["device_ops"] == [["k", pytest.approx(0.6)]]
    assert b["idle_gaps"][0][0] == "assemble.translate"


def test_rooflines():
    """Calls are the kernel's events that start in the slice, and the time
    is theirs, whole: an event that started before the slice is neither."""
    op = roofline.k2_attn_fwd(4, 768, 4, 64, 3000)
    bound_s = roofline.call_bound_ms(op) * 1e-3
    t = trace([("void flash_fwd_kernel<64>(...)", 0.1, 0.1 + 10 * bound_s),
               ("void flash_fwd_kernel<64>(...)", 0.99, 0.99 + 10 * bound_s),
               ("void flash_fwd_kernel<64>(...)", -0.5, 0.25),
               ("void flash_fwd_f16_kernel<64>(...)", 0.0, 0.5),
               ("other", 0.0, 0.5)])
    assert t.calls([r"\bflash_fwd_kernel\b"]) == (
        2, pytest.approx(20 * bound_s))
    rec = H.Record(trace=t, facts={"attn_fwd": op})
    assert rd("attn_fwd_roofline.serve")(rec) == pytest.approx(10.0)
    assert rd("attn_fwd_roofline.train")(rec) == pytest.approx(10.0)
    rec.facts = {}
    assert rd("attn_fwd_roofline.serve")(rec) is None
    rec.facts = {"attn_fwd": op}
    rec.trace = trace([("other", 0.0, 0.5)])
    assert rd("attn_fwd_roofline.serve")(rec) is None   # never 0
    rec.trace = None
    assert rd("attn_fwd_roofline.serve")(rec) is None


def test_conv_and_backward_rooflines():
    op = roofline.k3_conv_module(4, 768, 256, 32)
    b = roofline.call_bound_ms(op) * 1e-3
    t = trace([("conv_stage1_kernel", 0.0, 2 * b),
               ("conv_stage2_kernel", 0.0, 2 * b)])
    rec = H.Record(trace=t, facts={"conv_module": op})
    assert rd("conv_module_roofline.serve")(rec) == pytest.approx(25.0)
    dq = roofline.k6_attn_bwd_dq(64, 256, 8, 64, 12800)
    dkv = roofline.k7_attn_bwd_dkv(64, 256, 8, 64, 12800)
    tot = (roofline.call_bound_ms(dq) + roofline.call_bound_ms(dkv)) * 1e-3
    t = trace([("flash_bwd_dq_kernel", 0.0, 2 * tot),
               ("flash_bwd_dkv_kernel", 0.0, 2 * tot)])
    rec = H.Record(trace=t, facts={"attn_bwd_dq": dq, "attn_bwd_dkv": dkv})
    assert rd("attn_bwd_roofline.train")(rec) == pytest.approx(25.0)
    # A part with no call in the slice: no reading.
    rec.trace = trace([("flash_bwd_dq_kernel", 0.0, 2 * tot)])
    assert rd("attn_bwd_roofline.train")(rec) is None


def test_idle_parts():
    t = trace([("k", 0.0, 0.2), ("k", 0.5, 0.7)], 0.0, 1.0)
    assert t.idle_parts(2) == [pytest.approx(60.0), pytest.approx(60.0)]
    assert t.idle_parts(4) == [pytest.approx(20.0), pytest.approx(100.0),
                               pytest.approx(20.0), pytest.approx(100.0)]


def test_mfu_and_launches():
    rec = H.Record(facts={"useful_flops": roofline.MFU_PEAK * 2.0,
                          "window_s": 40.0})
    assert rd("mfu.serve")(rec) == pytest.approx(5.0)
    assert rd("mfu.train")(rec) == pytest.approx(5.0)
    t = trace([("k", 0.0, 0.1)] * 30 + [("Memcpy DtoH", 0.2, 0.3),
                                        ("Memset (Device)", 0.3, 0.31)])
    rec = H.Record(trace=t, facts={"trace_steps": 3})
    assert rd("launches_per_step.train")(rec) == pytest.approx(10.0)


def test_host_stages_and_decoders():
    st = {"decode": 0.01, "forward": 0.02, "extract": 0.03,
          "assemble": 0.30, "assemble.translate": 0.12,
          "assemble.summary": 0.06}
    rec = H.Record(spans=[{"audio_s": 120.0, "stages": st}] * 3)
    # (0.01 + 0.03 + 0.30 - 0.18) s a 2-minute request = 80 ms a minute.
    assert rd("host_ms_per_audio_min.serve")(rec) == pytest.approx(80.0)
    assert rd("decoder_ms_per_request.translate")(rec) == pytest.approx(180)
    assert rd("host_ms_per_audio_min.serve")(H.Record()) is None


def test_percentile():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert H.percentile(xs, 50) == 3.0
    assert H.percentile(xs, 95) == pytest.approx(4.8)
    assert H.percentile([7.0], 95) == 7.0
