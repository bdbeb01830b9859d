"""The frozen counts against values worked by hand for the flagship at 518
px: one DINOv2 block, one frame block, one global block at S = 8, and
their attention calls' bounds."""

import pytest

from portbench import config, flops

ARCH = config.config("omnivggt-1b")["architecture"]
P = 1 + 4 + 37 * 37  # 1374 tokens a frame
C = 1024


def test_tokens_and_block_counts():
    # qkv 3C^2, proj C^2, fc1 and fc2 4C^2 each: 12 C^2 multiply-adds a token
    assert flops._block(P, C, 4.0) == 2 * P * 12 * C * C == 34_577_842_176
    # attention: QK^T and PV, 2 x 2 N^2 C
    assert flops._attn(P, P, C) == 4 * P * P * C == 7_732_740_096


def test_dino_frame_and_global_calls():
    calls = {(c, nq): (d, h) for c, nq, nk, d, h in flops.attention_calls(ARCH, 8, 518, 518)}
    assert (24 * 8, P) in calls  # frame blocks
    assert (24, 8 * P) in calls  # global blocks
    # DINOv2: 24 blocks a frame, 1374 valid tokens (the program pads to 1376)
    assert calls[(24 * 8, P)] == (1024, 16)


def test_attention_bound_by_hand():
    # one global call at S = 8: 4 N^2 C = 4 * 10992^2 * 1024 operations,
    # 494.9 GFLOP / 989 TFLOP/s = 0.500 ms; bytes 2 C (2 N + 2 N) = 90 MB,
    # 0.027 ms: bound by the operations
    N = 8 * P
    one = max(4 * N * N * C / flops.PEAK_BF16_FLOPS, 2 * C * 4 * N / flops.PEAK_HBM_BYTES)
    assert one == pytest.approx(5.0040e-4, rel=1e-4)
    frame = 4 * P * P * C / flops.PEAK_BF16_FLOPS  # 7.82 us, also compute-bound
    assert frame == pytest.approx(7.8187e-6, rel=1e-4)
    total = 24 * one + 24 * 8 * frame * 2  # global + frame + DINOv2
    assert flops.attention_bound_s(ARCH, 8, 518, 518) == pytest.approx(total, rel=1e-12)


def test_backward_adds_four_products():
    fwd = flops.attention_bound_s(ARCH, 4, 518, 518)
    both = flops.attention_bound_s(ARCH, 4, 518, 518, backward=True)
    assert both == pytest.approx(3 * fwd, rel=1e-3)  # every call compute-bound


def test_dpt_head_by_convolution():
    # the two largest terms: output_conv1 (256 -> 128, 3x3 at 296^2) and the
    # last 3x3 (128 -> 32 at 518^2)
    oc1 = 2 * 296 * 296 * 256 * 128 * 9
    oc2 = 2 * 518 * 518 * 128 * 32 * 9
    assert oc1 == 51_678_019_584 and oc2 == 19_782_991_872
    assert flops.dpt_flops(ARCH, 2, 518, 518) > oc1 + oc2
    assert flops.forward_flops(ARCH, 8, 518, 518) == pytest.approx(39.5678e12, rel=1e-4)
