"""The 3x3 convolution kernel's contract on the CPU: its launch shape, the
wrapper's TMA mappability rule and relayout copy, and the DPT head's
channels_last hand-off.

The kernel (csrc/conv3x3.cu) stages x by TMA, channels innermost, and so
needs every stride but the channels' a multiple of 16 bytes; the heads
convert to channels_last before the upsample that feeds it. The kernel
itself runs on the card only (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch.config import DPTHeadConfig
from omnivggt_tpu_torch.models import dpt_head as TDH
from omnivggt_tpu_torch.ops.kernels import conv3x3 as CK

BLOCK_SMEM = 232448  # the H100's 227 KB of dynamic shared memory a block
# (cin, cout) of the card tests, chip_smoke.py's cases and the flagship's
# output_conv2[0] (128 -> 32)
CASES = [(64, 32), (128, 64), (16, 8), (20, 24), (33, 48), (128, 32), (16, 16), (8, 32)]
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout", CASES)
def test_conv_launch_shape_fits_the_block(cin, cout, dtype):
    assert CK.conv3x3_eligible((1, cin, 8, 8), (cout, cin, 3, 3))
    threads, smem = CK.conv_launch_shape(cin, cout, dtype)
    # two consumer warpgroups, and a producer warp for each (bf16) or both
    assert threads == (320 if dtype == torch.bfloat16 else 288)
    assert 0 < smem <= BLOCK_SMEM
    geo = CK._geometry(cin, cout, dtype)
    assert geo["stages"] >= 2 and geo["n"] >= cout and geo["n"] in (16, 32, 64)


def test_conv_launch_shape_at_the_flagship():
    """bf16 128 -> 32: 73,728 bytes of resident weights and two rings of
    four stages of one input row (two 9,216-byte slices); fp32: three
    stages of a 10 x 66-pixel box of 16 channels and its slice's weights."""
    assert CK._geometry(128, 32, torch.bfloat16) == {
        "threads": 320, "n": 32, "rows": 16, "stages": 4,
        "smem": 1024 + 73728 + 2 * 4 * (2 * 9216 + 16)}
    assert CK._geometry(128, 32, torch.float32) == {
        "threads": 288, "n": 32, "rows": 8, "stages": 3,
        "smem": 1024 + 3 * (43008 + 9 * 16 * 32 * 4 + 16)}
    # 128 -> 64 in bf16 holds twice the weights: two stages a ring
    assert CK._geometry(128, 64, torch.bfloat16)["stages"] == 2


def test_conv_launch_shape_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="cannot hold"):
        CK.conv_launch_shape(256, 64, torch.bfloat16)
    # fp32 holds one slice's weights at a time: any cin
    assert CK.conv_launch_shape(1024, 64, torch.float32)[1] <= BLOCK_SMEM


def _meta(shape, dtype, channels_last):
    x = torch.empty(shape, dtype=dtype, device="meta")
    return x.contiguous(memory_format=torch.channels_last) if channels_last else x


@pytest.mark.parametrize(
    "shape,channels_last,mappable",
    [((8, 128, 518, 518), True, (True, True)),     # the heads' hand-off
     ((8, 128, 518, 518), False, (False, False)),  # NCHW: channels not innermost
     ((1, 33, 40, 70), True, (False, False)),      # 66 / 132-byte pixel stride
     ((1, 20, 37, 45), True, (False, True)),       # 40 / 80-byte pixel stride
     ((2, 64, 24, 22), True, (True, True))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tma_mappable_rule(shape, channels_last, mappable, dtype):
    """(bf16, fp32): whether the TMA map describes x in place; "no" means
    the wrapper copies it once (counted on conv3x3_folded.relayouts)."""
    x = _meta(shape, dtype, channels_last)
    assert CK.tma_mappable(x) == mappable[dtype == torch.float32]


def test_tma_mappable_refuses_an_unaligned_base():
    x = torch.zeros((1, 24, 5, 5), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert CK.tma_mappable(x)
    view = x.permute(0, 2, 3, 1).reshape(-1)[4:4 + 24 * 24].reshape(1, 4, 6, 24).permute(0, 3, 1, 2)
    assert view.stride(1) == 1 and not CK.tma_mappable(view)  # base 8 bytes in


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,channels_last", [(33, True), (20, True), (16, False), (128, False)])
def test_mappable_copy_is_mappable_and_equal(cin, channels_last, dtype):
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(2, cin, 7, 9)), dtype=dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    got = CK._mappable_copy(x)
    assert CK.tma_mappable(got) and got.shape == x.shape
    assert torch.equal(got, x)


def test_head_hands_the_kernel_channels_last(monkeypatch):
    """With the head-conv flag on, output_conv2[0] (the flagship's 128 -> 32,
    here 8 -> 32) receives a channels_last tensor, converted before the
    upsample, which with the pos-embed add keeps it, and returns NCHW; the
    head's outputs equal the flag-off outputs bit for bit. With the flag off
    nothing is converted."""
    torch.manual_seed(0)
    cfg = DPTHeadConfig(dim_in=32, features=16, out_channels=(16, 32, 64, 64))
    head = TDH.DPTHead(cfg).eval()
    rng = np.random.default_rng(7)
    layers = [torch.tensor(rng.normal(size=(1, 2, 4, 32)), dtype=torch.float32)
              for _ in range(4)]
    handed = []
    folded = TDH.conv3x3_folded

    def spy(p, x, relu=False, memory_format=None):
        handed.append((p.weight.shape[0], x.is_contiguous(memory_format=torch.channels_last)))
        out = folded(p, x, relu=relu, memory_format=memory_format)
        assert out.is_contiguous()  # NCHW out: what follows runs as with the flag off
        return out

    monkeypatch.setattr(TDH, "conv3x3_folded", spy)
    with torch.no_grad():
        off = TDH.apply(head, layers, (28, 28), 0)
        assert handed == []
        monkeypatch.setattr(TDH, "_PALLAS_HEAD_CONVS", True)
        on = TDH.apply(head, layers, (28, 28), 0)
    # output_conv1 (16 -> 8) in the fusion's layout, output_conv2[0] channels_last
    assert handed == [(8, False), (32, True)]
    assert CK.conv3x3_folded.launches == 0 and CK.conv3x3_folded.relayouts == 0
    for a, b in zip(on, off):
        assert torch.equal(a, b)
