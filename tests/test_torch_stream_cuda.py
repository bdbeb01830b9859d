"""The frame-causal stream on the card: its CUDA graphs (models/stream.py,
`StreamState.replay`) against the same steps run eagerly, and a whole clip's
forward, at the tiny test configuration; and the flash kernels at the
published model's stream shapes, one frame's 1374 queries against a prefix
view of a 256-frame cache. Every test here needs a CUDA device and skips
without one:

    python -m pytest tests/test_torch_stream_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import pytest
import torch

from omnivggt_tpu_torch.config import tiny_test_config
from omnivggt_tpu_torch.models import omnivggt as M
from omnivggt_tpu_torch.ops import attention as A
from omnivggt_tpu_torch.ops.kernels import flash_attention as FK

pytestmark = pytest.mark.cuda
FRAMES = 6
KEYS = ("pose_enc", "depth", "depth_conf", "world_points", "world_points_conf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _clip(model, state, frames):
    return [model.stream_step(state, frames[t]) for t in range(len(frames))]


def test_graphs_replay_the_eager_steps(cuda):
    cfg = dataclasses.replace(tiny_test_config(), global_attention="frame_causal")
    model = M.OmniVGGT(cfg, device=cuda, seed=2).eval()
    frames = torch.rand(FRAMES, 28, 28, 3, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    graphed = model.stream(FRAMES)
    eager = model.stream(FRAMES)
    eager._pool = None  # the same steps, launched op by op
    got = _clip(model, graphed, frames)
    want = _clip(model, eager, frames)
    # the conv patch embed, frame and global blocks (the DINOv2 graph
    # needs a ViT embedder), and the two heads
    assert len(graphed._graphs) == 2 * cfg.aggregator.depth + 2
    for t in range(FRAMES):
        for k in KEYS:
            g, w = got[t][k], want[t][k]
            # fp32 on both sides; a graph may take other library kernels
            assert torch.allclose(g, w, rtol=1e-5, atol=1e-5 * w.abs().max().item()), (t, k)
    # outputs are the frame's own, not the graphs' buffers
    assert got[0]["depth"].data_ptr() != got[1]["depth"].data_ptr()
    graphed.reset()
    again = _clip(model, graphed, frames)
    for t in range(FRAMES):
        for k in KEYS:
            assert torch.equal(again[t][k], got[t][k]), (t, k)


def test_a_clip_forward_launches_op_by_op(cuda, monkeypatch):
    """apply() of a whole clip makes a cache for the call with no graph
    pool (captures it would replay S - 1 times at most), and answers what
    the steps answer."""
    cfg = dataclasses.replace(tiny_test_config(), global_attention="frame_causal")
    model = M.OmniVGGT(cfg, device=cuda, seed=2).eval()
    frames = torch.rand(FRAMES, 28, 28, 3, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    made = []

    class Recorded(M.StreamState):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(M, "StreamState", Recorded)
    with torch.no_grad():
        out = M.apply(model, frames[None], cfg)
    assert len(made) == 1 and made[0]._pool is None and not made[0]._graphs
    eager = model.stream(FRAMES)
    eager._pool = None
    want = _clip(model, eager, frames)
    for t in range(FRAMES):
        for k in KEYS:
            assert torch.equal(out[k][:, t], want[t][k][:, 0]), (t, k)


# the published model's stream: P tokens a frame, 16 heads of 64, a cache of
# CAPACITY frames a layer, two layers in one buffer as StreamState holds them
P, HEADS, HEAD_DIM, CAPACITY = 1374, 16, 64, 256


@pytest.fixture(scope="module")
def long_cache():
    """q (1, P, 16, 64) and a (2, CAPACITY P, 16, 64) bf16 K and V, layer 1
    the one read. The query and its own frame's keys share a direction per
    head, so the frame's own keys take a large share of each row's
    probability (scores ~6 against ~N(0, 1) elsewhere, within the bounded
    softmax's range), and each frame's values have a mean of their own: the
    output depends on which frames' keys are read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    u = torch.nn.functional.normalize(
        torch.randn(HEADS, HEAD_DIM, device=dev, generator=g), dim=-1) * 7.0
    q = torch.randn(1, P, HEADS, HEAD_DIM, device=dev, generator=g) + u
    k = torch.randn(2, CAPACITY * P, HEADS, HEAD_DIM, device=dev, generator=g,
                    dtype=torch.bfloat16)
    v = torch.randn(2, CAPACITY * P, HEADS, HEAD_DIM, device=dev, generator=g,
                    dtype=torch.bfloat16).mul_(0.1)
    means = torch.randn(2, CAPACITY, 1, HEADS, HEAD_DIM, device=dev, generator=g)
    v.view(2, CAPACITY, P, HEADS, HEAD_DIM).add_(means.to(torch.bfloat16))
    return q.to(torch.bfloat16), k, v, u.to(torch.bfloat16)


def _chunked_plain(q, k, v, block=16384):
    """attention_plain's bounded arithmetic (fp32 scores, P = exp(min(s,
    80)) rounded to bf16 before P @ V, row sums of the unrounded P) over key
    blocks, so 351,744 keys need no (16, 1374, Nk) score tensor."""
    qf = q.float() * HEAD_DIM**-0.5
    den = torch.zeros(1, HEADS, P, device=q.device)
    acc = torch.zeros(1, HEADS, P, HEAD_DIM, device=q.device)
    for k0 in range(0, k.shape[1], block):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, k0:k0 + block].float())
        p = s.clamp_max_(FK.BOUNDED_CLAMP).exp_()
        den += p.sum(dim=-1)
        acc += torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
                            v[:, k0:k0 + block].float())
    return (acc / den[..., None]).transpose(1, 2)


@pytest.mark.parametrize("t", [0, 1, 95, 255])
def test_one_frame_against_a_long_cache_matches_plain(long_cache, t):
    """Frame t's queries against frames 0..t of the cache, read as the
    global layers read it (a prefix view of one layer of the buffer), through
    the port's dispatch: the packed kernel while Nk <= PACKED_MAX_KEYS (t =
    0), the head-major kernel past it. Within the forward kernels' 2^-7
    max|v| of the plain arithmetic; the same call with the frame's own keys
    left out (t >= 1) fails it."""
    q, kbuf, vbuf, u = long_cache
    layer_k, layer_v = kbuf[1:2], vbuf[1:2]
    own = slice(t * P, (t + 1) * P)
    saved = layer_k[:, own].clone()
    layer_k[:, own] += u  # frame t's keys lean towards its queries
    try:
        k, v = layer_k[:, :(t + 1) * P], layer_v[:, :(t + 1) * P]
        assert k.data_ptr() == kbuf[1].data_ptr()  # a view, no copy
        packed = t * P + P <= FK.PACKED_MAX_KEYS
        launches = (FK.flash_attention_packed.launches, FK.flash_attention.launches)
        out = A.scaled_dot_product_attention(q, k, v, bounded_logits=True)
        torch.cuda.synchronize()
        assert (FK.flash_attention_packed.launches - launches[0],
                FK.flash_attention.launches - launches[1]) == ((1, 0) if packed else (0, 1))
        want = _chunked_plain(q, k, v)
        tol = 2.0**-7 * v.float().abs().max().item()
        err = (out.float() - want).abs().max().item()
        assert err <= tol, (err, tol)
        assert want.abs().max().item() > 10 * tol  # the output is far from 0
        if t:
            dropped = A.scaled_dot_product_attention(q, k[:, :t * P], v[:, :t * P],
                                                     bounded_logits=True)
            assert (dropped.float() - want).abs().max().item() > tol
    finally:
        layer_k[:, own] = saved
