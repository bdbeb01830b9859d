"""The tensor-core fp32 convolution kernel's contract on the CPU: its launch
shape at the heads' widths, the weight split it multiplies, which of a
flagship DPT head's convolutions it takes (28 of 32) and which calls keep
the library, the channels-last hand-off, and its plain version.

The kernel (csrc/conv_tf32x3.cu) runs on the card only
(tests/test_torch_conv_tf32x3_cuda.py). Here the routing rule is evaluated
as if the CPU tensors lay on the card (`_on_card`), and a convolution it
accepts runs the wrapper's plain version.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from omnivggt_tpu_torch.config import DPTHeadConfig
from omnivggt_tpu_torch.models import dpt_head as TDH
from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT

BLOCK_SMEM = 232448  # the H100's 227 KB of dynamic shared memory a block
# (cin, cout) of the flagship heads' convolutions that the kernel takes
HEAD_CONVS = [(2048, 256), (2048, 512), (2048, 1024), (256, 256), (512, 256), (1024, 256),
              (256, 128), (128, 32)]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, for the routing rule."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.fixture
def on_card(monkeypatch):
    """CT.eligible judged as if x lay on the card; the accepted calls then
    run conv2d_tf32x3's plain version on the CPU. Yields the list of the
    (cin, cout, k, stride, accepted) of each call."""
    rule, calls = CT.eligible, []

    def eligible(p, x, stride=1, padding=0):
        ok = rule(p, x.as_subclass(_OnCard), stride, padding)
        cout, cin, k, _ = p.weight.shape
        calls.append((cin, cout, k, stride, ok))
        return ok

    monkeypatch.setattr(CT, "eligible", eligible)
    return calls


@pytest.mark.parametrize("cin,cout", HEAD_CONVS)
def test_launch_shape_fits_the_block(cin, cout):
    threads, smem = CT.launch_shape(cout)
    geo = CT._geometry(cout)
    assert threads == 384 and 0 < smem <= BLOCK_SMEM
    assert geo["stages"] >= 3 and geo["n"] >= min(cout, 128) and geo["n"] in (16, 32, 64, 128)
    # a stage: the 128 x 32 fp32 pixel tile and the hi and lo weight tiles
    assert smem == 1024 + geo["stages"] * (16384 + 2 * 128 * geo["n"] + 16)


def test_launch_shape_at_the_heads_widths():
    """N 128 (four stages of 48 KB) for the 256-wide and wider layers, N 32
    (eight of 24 KB) for output_conv2[0]'s 32 channels."""
    assert CT._geometry(256) == {"threads": 384, "n": 128, "stages": 4,
                                 "smem": 1024 + 4 * (49152 + 16)}
    assert CT._geometry(128)["n"] == 128
    assert CT._geometry(32) == {"threads": 384, "n": 32, "stages": 8,
                                "smem": 1024 + 8 * (24576 + 16)}


@pytest.mark.parametrize("cout,built", [(16, False), (32, True), (48, False), (128, True),
                                        (256, True), (1024, True)])
def test_planted_faults_are_built_at_n_32_and_128_alone(cout, built):
    """The faulted forms of the kernel exist at the N tiles of FAULT_N (the
    heads' widths all give one), and the wrapper refuses a fault at any
    other N before it touches the card."""
    assert (CT._geometry(cout)["n"] in CT.FAULT_N) == built
    if not built:
        conv = torch.nn.Conv2d(8, cout, 3, padding=1)
        with pytest.raises(ValueError, match="planted faults"):
            CT._launch(conv, torch.zeros((1, 8, 4, 4)), False, fault=CT.FAULTS["halo_column"])


@pytest.mark.parametrize(
    "w_shape,stride,padding,groups,taken",
    [((256, 256, 3, 3), 1, 1, 1, True), ((256, 2048, 1, 1), 1, 0, 1, True),
     ((32, 128, 3, 3), 1, 1, 1, True), ((1024, 1024, 3, 3), 2, 1, 1, False),
     ((2, 32, 1, 1), 1, 0, 1, False), ((24, 16, 3, 3), 1, 1, 1, False),
     ((32, 32, 3, 3), 1, 0, 1, False), ((32, 32, 1, 1), 1, 1, 1, False),
     ((32, 32, 5, 5), 1, 2, 1, False), ((32, 16, 3, 3), 1, 1, 2, False)])
def test_the_shape_rule(w_shape, stride, padding, groups, taken):
    assert CT.takes(w_shape, stride, padding, groups) == taken


def test_eligible_refuses_what_the_kernel_does_not_serve():
    conv = torch.nn.Conv2d(32, 16, 3, padding=1)
    x = torch.zeros((1, 32, 5, 5))
    assert not CT.eligible(conv, x, 1, 1)  # a CPU tensor
    card = x.as_subclass(_OnCard)
    assert torch.is_grad_enabled() and not CT.eligible(conv, card, 1, 1)  # recorded
    with torch.no_grad():
        assert CT.eligible(conv, card, 1, 1)
        assert not CT.eligible(conv, x.to(torch.bfloat16).as_subclass(_OnCard), 1, 1)
        assert not CT.eligible(conv, torch.zeros((1, 16, 5, 5)).as_subclass(_OnCard), 1, 1)
    conv.requires_grad_(False)
    assert CT.eligible(conv, card, 1, 1)  # grad mode on, nothing to record


def _flagship_head():
    torch.manual_seed(0)
    return TDH.DPTHead(DPTHeadConfig()).eval()


def _layers(frames=3, patches=16, seed=7):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(1, frames, 5 + patches, 2048)), dtype=torch.float32)
            for _ in range(4)]


def test_flagship_head_gives_the_kernel_28_of_32_channels_last(on_card, monkeypatch):
    """At the flagship's widths (4 x 4 patches, 56 px, chunks of 2 frames
    over 3): per chunk the 4 projections, 4 layerN_rn, 14 residual-unit
    convolutions, 4 out_convs, output_conv1 and output_conv2[0] take the
    kernel, each handed a TMA-mappable channels-last x (no relayout
    copy); the stride-2 resize and output_conv2[2] (and the transposed
    convolutions) keep the library; the outputs equal the library route's
    bit for bit (the plain version is F.conv2d) and the final (K, H, W, C)
    is a view of the channels-last output."""
    head = _flagship_head()
    head.cfg = DPTHeadConfig(frames_chunk_size=2)
    handed = []
    kernel = CT.conv2d_tf32x3

    def spy(p, x, padding=0, relu=False):
        handed.append((CT.tma_mappable(x), x.is_contiguous(memory_format=torch.channels_last)))
        return kernel(p, x, padding, relu)

    monkeypatch.setattr(CT, "conv2d_tf32x3", spy)
    layers = _layers()
    with torch.no_grad():
        before = TDH.conv_counts()
        preds, conf = TDH.apply(head, layers, (56, 56), 5)
        counts = TDH.conv_counts(since=before)
    assert counts == {"kernel_convs": 2 * 28, "library_convs": 2 * 4}
    assert handed == [(True, True)] * 56
    refused = [c for c in on_card[:30] if not c[-1]]
    assert refused == [(1024, 1024, 3, 2, False), (32, 4, 1, 1, False)]
    taken = sorted({c[:4] for c in on_card if c[-1]})
    assert taken == sorted({(2048, 256, 1, 1), (2048, 512, 1, 1), (2048, 1024, 1, 1),
                            (256, 256, 3, 1), (512, 256, 3, 1), (1024, 256, 3, 1),
                            (256, 256, 1, 1), (256, 128, 3, 1), (128, 32, 3, 1)})
    monkeypatch.setattr(CT, "eligible", lambda *a, **k: False)
    with torch.no_grad():
        lib_preds, lib_conf = TDH.apply(head, layers, (56, 56), 5)
    assert torch.equal(preds, lib_preds) and torch.equal(conf, lib_conf)


@pytest.mark.parametrize("mode", ["grad", "bf16", "int8"])
def test_training_bf16_and_int8_heads_keep_the_library(on_card, mode):
    head = _flagship_head()
    layers = _layers(frames=1, patches=4)
    kw = {"dtype": torch.bfloat16} if mode == "bf16" else {"quant": "int8"} if mode == "int8" else {}
    before = TDH.conv_counts()
    with torch.no_grad() if mode != "grad" else torch.enable_grad():
        TDH.apply(head, layers, (28, 28), 5, **kw)
    assert TDH.conv_counts(since=before) == {"kernel_convs": 0, "library_convs": 32}


@pytest.mark.parametrize("k,bias,relu", [(3, True, False), (3, False, True), (1, True, True)])
def test_plain_version_is_f_conv2d(k, bias, relu):
    rng = np.random.default_rng(k)
    conv = torch.nn.Conv2d(40, 32, k, padding=k // 2, bias=bias)
    x = torch.tensor(rng.normal(size=(2, 40, 9, 11)), dtype=torch.float32)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = CT.conv2d_tf32x3(conv, x, padding=k // 2, relu=relu)
        want = F.conv2d(x, conv.weight, conv.bias, padding=k // 2)
    assert torch.equal(got, F.relu(want) if relu else want)
    with pytest.raises(ValueError, match="does not take"):
        CT.conv2d_tf32x3(conv, x, padding=1 - k // 2)


@pytest.mark.parametrize("cout,cin,k", [(32, 128, 3), (16, 40, 1), (48, 64, 3)])
def test_weight_split_is_exact_tf32_in_the_kernels_order(cout, cin, k):
    """hi and lo are TF32 values (low 13 bits zero), hi + lo is w within
    2^-22 |w|, and undoing the slice order gives w's channels back."""
    rng = np.random.default_rng(cin)
    w = torch.tensor(rng.normal(size=(cout, cin, k, k)), dtype=torch.float32)
    hi, lo = CT.split_weights_plain(w)
    cin32 = -(-cin // 32) * 32
    assert hi.shape == lo.shape == (cout, k * k, cin32)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    inverse = torch.argsort(torch.tensor(CT.SLICE_ORDER))
    undo = (hi.double() + lo.double()).reshape(cout, k * k, cin32 // 32, 32)[..., inverse]
    undo = undo.reshape(cout, k, k, cin32)
    assert not undo[..., cin:].any()  # the channels past cin are zeros
    undo = undo[..., :cin].permute(0, 3, 1, 2)
    assert ((undo - w.double()).abs() <= 2.0**-22 * w.double().abs()).all()
    # hi alone (one-pass TF32) is off by up to 2^-12 |w|: lo carries that
    assert lo.abs().max() > 2.0**-16 * w.abs().max()
