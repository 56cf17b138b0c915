"""Work counts, window arithmetic and trace reduction against numbers
worked out by hand."""

import math

import pytest

from portbench import harness


def test_smt_work():
    flops, nbytes = harness.roofline_module("smt").work(b=2, l=3, f=5, d=4, goal=True, weight_elems=100)
    # per row: 3·(5·4 + 9·16) + 2·9·4 + 6·16 + 2·3·4 = 492 + 72 + 96 + 24 = 684 multiply-adds
    assert flops == 2 * 2 * 684
    assert nbytes == 4 * (2 * 3 * 5 + 2 * 3 + 2 * 4 + 2 * 4 + 100)


def test_irfft_work():
    flops, nbytes = harness.roofline_module("irfft").work(rows=2, fft_len=8, out_len=4)
    assert flops == 2 * 2.5 * 8 * 3
    assert nbytes == 2 * (5 * 8 + 4 * 4)


def test_spectrogram_work():
    flops, nbytes = harness.roofline_module("spectrogram").work(batch=1, samples=1600, n_fft=512, hop=160,
                                                                 block=[4, 4])
    frames = 11  # 1 + 1600 // 160
    assert flops == frames * 5 * 512 * 9
    assert nbytes == 4 * (2 * 1600 + 3 * 512 + 65 * 3 * 2)


def test_roofline_share():
    rec = {"trace": {"ops": [("smt_fusion", 0.0, 1.0), ("smt_tail", 5.0, 1.0), ("other", 0.0, 50.0)]},
           "launches": {"smt": [dict(b=1, l=1, f=1, d=1, goal=False, weight_elems=0)]}}
    flops, nbytes = harness.roofline_module("smt").work(**rec["launches"]["smt"][0])
    least = max(flops / harness.PEAK["tf32"], nbytes / harness.PEAK["bytes"])
    assert harness.roofline_share(rec, "smt") == pytest.approx(100 * least / 2e-6)
    assert harness.roofline_share(rec, "irfft") is None
    assert harness.roofline_share({"launches": rec["launches"]}, "smt") is None


def test_smt_flop_count_on_the_reference_matches_the_hand_count():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.nets import savi_modules

    policy, _ = savi_modules((65, 26), device="meta")
    rows, m, f, d = 3, 150, policy.net.feature_size, 256
    l = m + 1
    with FlopCounterMode(display=False) as fc, torch.device("meta"):
        policy.heads(policy.net.smt(torch.zeros(rows, f), torch.zeros(rows, m, f), torch.zeros(rows, m),
                                    torch.zeros(rows, d)))
    per_row = (l * 5 * 16 + l * ((f - 4 + 16) * d + d * d) + l * 3 * d * d + 2 * l * l * d + l * d * d
               + l * 2 * d * d + 2 * d * d + d * d + 2 * l * d * d + 2 * l * d + d * d + 2 * d * d + d * 5)
    assert fc.get_total_flops() == 2 * rows * per_row


def test_whole_rounds():
    t = [0.0]

    def clock():
        return t[0]

    def one_round():
        t[0] += 3.0

    assert harness.whole_rounds(one_round, 10.0, clock=clock) == ([3.0, 3.0, 3.0], 9.0)
    t[0] = 0.0
    # a round that would end past the window is not started, but one always is
    assert harness.whole_rounds(one_round, 1.0, clock=clock) == ([3.0], 3.0)
    # the longest round so far decides
    t[0], steps = 0.0, iter([1.0, 4.0, 1.0, 1.0])

    def uneven():
        t[0] += next(steps)

    assert harness.whole_rounds(uneven, 7.0, clock=clock) == ([1.0, 4.0], 5.0)


def test_quantile_and_rate_use_every_sample():
    vals = list(range(1, 101))
    assert harness.quantile(vals, 0.95) == pytest.approx(95.95)
    assert harness.quantile(vals, 0.5) == pytest.approx(50.5)
    assert harness.quantile([7.0], 0.95) == 7.0


def test_union_and_idle_gaps():
    events = [("k1", True, 0, 10, False), ("k2", True, 5, 15, False), ("k1", True, 50, 10, False),
              ("collect.act", True, 15, 40, True), ("collect.act", False, 15, 40, False),
              ("update", False, 0, 100, False)]
    red = harness.reduce_trace(events, ("collect.act", "update"), (0.0, 100.0))
    assert red["busy_s"] == pytest.approx(30e-6)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    # the gap 20-50 opens inside collect.act, the gap 60-100 inside update alone
    assert dict((n, s) for n, s in red["idle_gaps"]) == {"update": pytest.approx(40e-6),
                                                         "collect.act": pytest.approx(30e-6)}
    assert math.isclose(harness.union_seconds([(0, 1), (1, 2)])[0], 2e-6)
