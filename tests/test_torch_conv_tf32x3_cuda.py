"""The tensor-core fp32 convolution kernel (csrc/conv_tf32x3.cu) on the card.

Every test here needs an NVIDIA GPU with nvcc (sm_90a) and skips without
one. This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_conv_tf32x3_cuda.py -m cuda --noconftest -q

The precision gate, at every convolution a flagship DPT head gives the
kernel, at a chunk of 8 frames and a ragged 3, against a float64 F.conv2d
of the same fp32 inputs:
  - every entry within the repo's fp32 convolution tolerance
    2 (taps cin + 1) 2^-24 conv(|x|, |w|) + |b| terms (as conv3x3_fp32_tma's);
  - the median relative error at most twice cuDNN fp32's (TF32 off) on the
    same inputs.
Planted faults (one-pass TF32, the lo*hi product dropped, the left halo
column of 64-column strips lost, the bias or the ReLU left out) fail it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytestmark = pytest.mark.cuda

# (cin, cout, k, side) of each convolution a flagship head (518 px, 37 x 37
# patches, features 256, out_channels (256, 512, 1024, 1024)) gives the
# kernel: the projections, layerN_rn (layer1_rn's shape is also the
# residual units' at 148), the residual units, the fusion out_convs,
# output_conv1, output_conv2[0]
HEAD_SHAPES = [
    (2048, 256, 1, 37), (2048, 512, 1, 37), (2048, 1024, 1, 37),
    (256, 256, 3, 148), (512, 256, 3, 74), (1024, 256, 3, 37), (1024, 256, 3, 19),
    (256, 256, 3, 19), (256, 256, 3, 37), (256, 256, 3, 74),
    (256, 256, 1, 37), (256, 256, 1, 74), (256, 256, 1, 148), (256, 256, 1, 296),
    (256, 128, 3, 296), (128, 32, 3, 518),
]
MEDIAN_RATIO = 2.0  # the kernel's median relative error against cuDNN fp32's


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(cin, cout, k, side, frames, seed, dev, bias=True):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    conv = torch.nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.rand(conv.weight.shape, generator=gen) * 2 - 1)
        conv.weight.mul_((cin * k * k) ** -0.5)
        if bias:
            conv.bias.copy_(torch.rand(cout, generator=gen) - 0.5)
    conv = conv.to(dev).requires_grad_(False)
    x = torch.randn((frames, side, side, cin), generator=gen).to(dev).permute(0, 3, 1, 2)
    return conv, x  # x channels-last, as the heads hand it


def _references(conv, x, relu):
    """(float64 reference, the tolerance's conv(|x|, |w|) + |b|, cuDNN fp32)"""
    k = conv.weight.shape[-1]
    b = conv.bias
    w64 = conv.weight.double()
    ref = F.conv2d(x.double(), w64, None if b is None else b.double(), padding=k // 2)
    mag = F.conv2d(x.double().abs(), w64.abs(), None if b is None else b.double().abs(),
                   padding=k // 2)
    lib = F.conv2d(x, conv.weight, b, padding=k // 2)
    if relu:
        ref, lib = F.relu(ref), F.relu(lib)
    return ref, mag, lib


def _gate(out, ref, mag, lib, cin, k):
    """(max err / tol, kernel median relative error, cuDNN's)"""
    tol = 2 * (k * k * cin + 1) * 2.0**-24 * mag
    err = (out.double() - ref).abs()
    worst = (err / tol.clamp_min(1e-300)).max().item()
    nz = ref != 0
    med = (err[nz] / ref[nz].abs()).median().item()
    med_lib = ((lib.double() - ref).abs()[nz] / ref[nz].abs()).median().item()
    return worst, med, med_lib


@pytest.mark.parametrize("frames", [8, 3])
@pytest.mark.parametrize("cin,cout,k,side", HEAD_SHAPES)
def test_kernel_within_fp32_at_every_head_shape(cuda, cin, cout, k, side, frames):
    from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT

    conv, x = _case(cin, cout, k, side, frames, 1000 * cin + side + frames, cuda)
    with torch.no_grad():
        before = (CT.conv2d_tf32x3.launches, CT.conv2d_tf32x3.relayouts)
        out = CT.conv2d_tf32x3(conv, x, padding=k // 2)
        assert (CT.conv2d_tf32x3.launches, CT.conv2d_tf32x3.relayouts) == (before[0] + 1,
                                                                            before[1])
        assert out.is_contiguous(memory_format=torch.channels_last)
        ref, mag, lib = _references(conv, x, relu=False)
    torch.cuda.synchronize()
    worst, med, med_lib = _gate(out, ref, mag, lib, cin, k)
    print(f"conv_tf32x3 {frames}x{cin}->{cout} k{k} {side}^2: err/tol {worst:.3e}, median rel "
          f"{med:.3e} (cuDNN fp32 {med_lib:.3e}, ratio {med / med_lib:.3f})")
    assert worst <= 1.0, worst
    assert med <= MEDIAN_RATIO * med_lib, (med, med_lib)


# (fault, cin, cout, k, side, frames, relu)
FAULT_CASES = [
    ("one_pass_tf32", 256, 256, 3, 74, 3, False), ("one_pass_tf32", 2048, 512, 1, 37, 3, False),
    ("lo_hi_dropped", 256, 256, 3, 74, 3, False), ("lo_hi_dropped", 256, 256, 1, 148, 3, False),
    ("halo_column", 256, 256, 3, 148, 3, False), ("halo_column", 128, 32, 3, 518, 3, True),
    ("bias_dropped", 256, 128, 3, 296, 3, False), ("bias_dropped", 256, 256, 1, 74, 3, False),
    ("relu_dropped", 128, 32, 3, 518, 3, True), ("relu_dropped", 256, 256, 3, 37, 3, True),
]


@pytest.mark.parametrize("fault,cin,cout,k,side,frames,relu", FAULT_CASES)
def test_planted_faults_fail_the_gate(cuda, fault, cin, cout, k, side, frames, relu):
    from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT

    conv, x = _case(cin, cout, k, side, frames, 7 + side, cuda)
    with torch.no_grad():
        sound = CT._launch(conv, x, relu)
        bad = CT._launch(conv, x, relu, fault=CT.FAULTS[fault])
        ref, mag, lib = _references(conv, x, relu)
    torch.cuda.synchronize()
    ok = _gate(sound, ref, mag, lib, cin, k)
    worst, med, med_lib = _gate(bad, ref, mag, lib, cin, k)
    print(f"fault {fault} at {frames}x{cin}->{cout} k{k} {side}^2: err/tol {worst:.3e}, median "
          f"rel {med:.3e} (cuDNN fp32 {med_lib:.3e}); sound {ok[0]:.3e}, {ok[1]:.3e}")
    assert ok[0] <= 1.0 and ok[1] <= MEDIAN_RATIO * ok[2], ok
    assert worst > 1.0 or med > MEDIAN_RATIO * med_lib, (worst, med, med_lib)


@pytest.mark.parametrize("relu", [False, True])
def test_layouts_relu_and_determinism(cuda, relu):
    """An NCHW x is copied once (relayouts) and gives an NCHW output equal
    to the channels-last one's; a strided channels-last view is taken in
    place; a layer without bias; 21 launches bitwise equal."""
    from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT

    conv, x = _case(96, 48, 3, 45, 2, 3, cuda, bias=False)
    with torch.no_grad():
        out = CT.conv2d_tf32x3(conv, x, padding=1, relu=relu)
        before = CT.conv2d_tf32x3.relayouts
        nchw = CT.conv2d_tf32x3(conv, x.contiguous(), padding=1, relu=relu)
        assert CT.conv2d_tf32x3.relayouts == before + 1 and nchw.is_contiguous()
        assert torch.equal(nchw, out)
        wide = torch.randn((2, 45, 45, 128), device=cuda)[..., 16:112].permute(0, 3, 1, 2)
        assert CT.tma_mappable(wide)
        got = CT.conv2d_tf32x3(conv, wide, padding=1, relu=relu)
        assert CT.conv2d_tf32x3.relayouts == before + 1
        ref, mag, lib = _references(conv, wide, relu)
        assert all(torch.equal(CT.conv2d_tf32x3(conv, x, padding=1, relu=relu), out)
                   for _ in range(20))
    worst, med, med_lib = _gate(got, ref, mag, lib, 96, 3)
    assert worst <= 1.0 and med <= MEDIAN_RATIO * med_lib, (worst, med, med_lib)


def test_split_weights_bitwise_the_plain_packing_and_launch_shape(cuda):
    from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT

    for cout, cin, k in ((256, 1024, 3), (32, 128, 3), (512, 2048, 1), (48, 40, 3)):
        w = torch.randn((cout, cin, k, k), device=cuda) * 0.37
        assert torch.equal(CT.split_weights(w), CT.split_weights_plain(w))
    for cout in (16, 32, 48, 128, 256, 1024):
        assert CT.built_launch_shape(cout) == CT.launch_shape(cout)


def test_refuses_grad_and_other_types(cuda):
    from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT

    conv, x = _case(32, 16, 3, 9, 1, 5, cuda)
    conv.requires_grad_(True)
    assert torch.is_grad_enabled() and not CT.eligible(conv, x, 1, 1)
    with pytest.raises(ValueError, match="forward-only"):
        CT.conv2d_tf32x3(conv, x, padding=1)
    with torch.no_grad():
        assert CT.eligible(conv, x, 1, 1)
        assert not CT.eligible(conv, x.to(torch.bfloat16), 1, 1)
        assert not CT.eligible(conv, x, 2, 1)


def test_flagship_head_routes_28_of_32_and_matches_the_library(cuda):
    """A flagship-width DPT head (2 frames at 140 px): 28 of its 32
    convolutions take the kernel, none copies its input, and its outputs
    lie within the library route's rounding; under grad mode with weights
    that require grad none does."""
    from omnivggt_tpu_torch.config import DPTHeadConfig
    from omnivggt_tpu_torch.models import dpt_head as TDH
    from omnivggt_tpu_torch.ops.kernels import conv_tf32x3 as CT

    torch.manual_seed(0)
    head = TDH.DPTHead(DPTHeadConfig()).to(cuda).eval()
    rng = np.random.default_rng(11)
    layers = [torch.tensor(rng.normal(size=(1, 2, 5 + 100, 2048)), dtype=torch.float32,
                           device=cuda) for _ in range(4)]
    with torch.no_grad():
        before = (TDH.conv_counts(), CT.conv2d_tf32x3.launches, CT.conv2d_tf32x3.relayouts)
        preds, conf = TDH.apply(head, layers, (140, 140), 5)
        assert TDH.conv_counts(since=before[0]) == {"kernel_convs": 28, "library_convs": 4}
        assert CT.conv2d_tf32x3.launches == before[1] + 28
        assert CT.conv2d_tf32x3.relayouts == before[2]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(CT, "eligible", lambda *a, **k: False)
            lib_preds, lib_conf = TDH.apply(head, layers, (140, 140), 5)
    for got, want in ((preds, lib_preds), (conf, lib_conf)):
        rel = ((got - want).abs() / want.abs().clamp_min(1e-6)).median().item()
        assert rel < 1e-5, rel
    launches = CT.conv2d_tf32x3.launches
    with torch.enable_grad():
        TDH.apply(head, layers, (140, 140), 5)
    assert CT.conv2d_tf32x3.launches == launches
