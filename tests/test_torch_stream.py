"""The frame-causal stream (StreamVGGT: `global_attention="frame_causal"`,
`OmniVGGT.stream` / `stream_step`) at the tiny test configuration on the
CPU, with the benchmark's seeded weights in the VGGT layout (camera
adapters' biases and depth placeholder at zero), against the plain
reference's whole-clip forward (`portbench/reference/stream.py`)."""

import dataclasses

import numpy as np
import pytest
import torch

from omnivggt_tpu_torch.checkpoint import OMNIVGGT_ONLY, load_vggt_layout
from omnivggt_tpu_torch.config import OmniVGGTConfig, tiny_test_config
from omnivggt_tpu_torch.models import omnivggt as M
from omnivggt_tpu_torch.models import stream as ST
from omnivggt_tpu_torch.utils import profiling
from portbench import faults_stream
from portbench.config import arch_of
from portbench.drivers.stream import vggt_state_dict
from portbench.reference.stream import StreamVGGT

torch.set_num_threads(1)
FRAMES = 6
KEYS = ("pose_enc", "pose_enc_list", "depth", "depth_conf", "world_points", "world_points_conf")
# The program computes in float32 here, like the reference: the same
# mathematics in another order (the cache's prefix against the whole clip's
# keys, the plain softmax against the reference's blocked one). Its largest
# gap, over each output's largest magnitude, reads ~2e-6 (rounding grown
# through the blocks and the heads' exp / expm1); 2e-5 leaves ten times that,
# and every planted fault reads above 1e-3.
TOLERANCE = 2e-5


def _config(embed="conv", mode="frame_causal"):
    cfg = tiny_test_config() if embed == "conv" else tiny_test_config(
        embed_dim=384, num_heads=6, patch_embed=embed)
    return dataclasses.replace(cfg, global_attention=mode)


def _pair(cfg, seed=3):
    sd = vggt_state_dict(arch_of(cfg), seed, "cpu")
    model = M.OmniVGGT(cfg, device="cpu", seed=None)
    model.load_state_dict(sd, strict=True)
    ref = StreamVGGT(arch_of(cfg))
    ref.load_state_dict(sd, strict=True)
    return model.eval(), ref.eval()


def _clip(seed=0, frames=FRAMES, size=28):
    return torch.rand(1, frames, size, size, 3, generator=torch.Generator().manual_seed(seed))


def _steps(model, state, clip):
    outs = [model.stream_step(state, clip[0, t]) for t in range(clip.shape[1])]
    return {k: torch.cat([o[k] for o in outs], dim=2 if k == "pose_enc_list" else 1)
            for k in KEYS}


def _gap(got, want) -> float:
    """The largest gap over the outputs, each over its largest magnitude."""
    return max(((got[k].double() - want[k].double()).abs().max()
                / want[k].double().abs().max()).item() for k in KEYS)


@pytest.fixture(scope="module")
def conv_case():
    cfg = _config()
    model, ref = _pair(cfg)
    clip = _clip()
    with torch.no_grad():
        want = ref(clip)
    return model, clip, want


@pytest.mark.parametrize("embed", ["conv", "dinov2_vits14_reg"])
def test_steps_match_the_reference(embed):
    model, ref = _pair(_config(embed))
    clip = _clip(size=28)
    with torch.no_grad():
        want = ref(clip)
    got = _steps(model, model.stream(FRAMES, (28, 28)), clip)
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
    assert _gap(got, want) < TOLERANCE


def test_forward_of_the_clip_is_the_steps(conv_case):
    model, clip, _ = conv_case
    with torch.no_grad():
        whole = model(clip)
    steps = _steps(model, model.stream(FRAMES), clip)
    for k in KEYS:
        assert torch.equal(whole[k], steps[k]), k
    assert torch.equal(whole["images"], clip)


@pytest.mark.parametrize("fault", ["own_keys", "oldest_dropped", "slot0_everywhere"])
def test_a_planted_fault_fails_the_tolerance(conv_case, fault):
    model, clip, want = conv_case
    with faults_stream.planted(fault):
        got = _steps(model, model.stream(FRAMES), clip)
    assert _gap(got, want) > 50 * TOLERANCE


def test_non_causal_global_attention_fails_the_tolerance(conv_case):
    model, clip, want = conv_case
    cfg = dataclasses.replace(model.config, global_attention="full")
    with torch.no_grad():
        got = M.apply(model, clip, cfg)
    assert _gap(got, want) > 50 * TOLERANCE


def test_the_cache_is_written_in_place_and_refuses_past_capacity(conv_case):
    model, clip, _ = conv_case
    state = model.stream(FRAMES)
    buffers = [x.untyped_storage().data_ptr() for x in
               (state.k, state.v, state.camera_k, state.camera_v)]
    P = state.tokens_per_frame
    assert P == 9 and state.k.shape == (2, FRAMES * P, 2, 32)
    assert state.camera_k.shape == (4, 2, FRAMES, 2, 64)
    with profiling.recording() as rec:
        for t in range(FRAMES):
            model.stream_step(state, clip[0, t])
            assert state.filled == t + 1
            assert [x.untyped_storage().data_ptr() for x in
                    (state.k, state.v, state.camera_k, state.camera_v)] == buffers
    appends = [s for s in rec.spans if s["name"] == "stream.cache_append"]
    assert len(appends) == FRAMES * (2 + 4 * 2)  # the global layers, the camera trunk's
    steps = [s["counts"] for s in rec.spans if s["name"] == "model.stream_step"]
    assert steps[-1] == {"frame": 5, "cached_frames": 5, "keys": 2 * 6 * P}
    with pytest.raises(ValueError, match="full"):
        model.stream_step(state, clip[0, 0])
    with pytest.raises(ValueError, match="holds frames of"):
        model.stream(2, (28, 28)).check_frame((42, 42))


def test_reset_gives_the_next_clip_the_same_outputs(conv_case):
    model, clip, _ = conv_case
    state = model.stream(FRAMES)
    first = _steps(model, state, clip)
    with profiling.recording() as rec:
        state.reset()
    assert state.filled == 0
    assert [(s["name"], s["counts"]) for s in rec.spans] == [("stream.reset", {"frames": FRAMES})]
    second = _steps(model, state, clip)
    for k in KEYS:
        assert torch.equal(first[k], second[k]), k


def test_the_full_path_runs_none_of_the_stream(monkeypatch):
    """global_attention="full" (the default) computes what it did before the
    stream existed: with every entry of the stream's code made to raise,
    its outputs, with and without GT cameras and padded frames, are
    bitwise those of the untouched run."""
    cfg = tiny_test_config()
    assert cfg.global_attention == "full" and OmniVGGTConfig().global_attention == "full"
    model = M.OmniVGGT(cfg, device="cpu", seed=3).eval()
    x = _clip(frames=4).expand(2, -1, -1, -1, -1)
    ex = torch.eye(3, 4).expand(2, 4, 3, 4).clone()
    ex[..., 3] = torch.randn(2, 4, 3, generator=torch.Generator().manual_seed(2))
    K = torch.tensor([[30.0, 0, 14], [0, 30, 14], [0, 0, 1]]).expand(2, 4, 3, 3)

    def run():
        with torch.no_grad():
            return [model(x), model(x, extrinsics=ex, intrinsics=K, camera_gt_index=[0, 2],
                                    num_valid_frames=3)]

    before = run()

    def refuse(*args, **kwargs):
        raise AssertionError("the full path reached the stream's code")

    for owner, name in ((ST.LayerCache, "append"), (ST.StreamState, "__init__"),
                        (M, "_apply_clip"), (M, "_stream_step")):
        monkeypatch.setattr(owner, name, refuse)
    for a, b in zip(before, run()):
        for k in KEYS:
            assert torch.equal(a[k], b[k]), k


def test_a_frame_causal_model_refuses_what_it_cannot_stream(conv_case):
    model, clip, _ = conv_case
    with pytest.raises(ValueError, match="images only"):
        model(clip, extrinsics=torch.eye(3, 4).expand(1, FRAMES, 3, 4),
              intrinsics=torch.eye(3).expand(1, FRAMES, 3, 3), camera_gt_index=[0])
    full = M.OmniVGGT(tiny_test_config(), device="cpu", seed=0)
    with pytest.raises(ValueError, match="frame_causal"):
        full.stream(4)
    with pytest.raises(ValueError, match="global_attention"):
        tiny_test_config().__class__(global_attention="causal")


def test_config_json_carries_the_field(tmp_path, conv_case):
    model, _, _ = conv_case
    model.save_pretrained(str(tmp_path))
    loaded = M.OmniVGGT.from_pretrained(str(tmp_path), device="cpu")
    assert loaded.config == model.config
    assert loaded.config.global_attention == "frame_causal"
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_a_vggt_layout_state_dict_loads(tmp_path):
    """A VGGT-layout state dict (StreamVGGT's): no OmniVGGT-only leaves, a
    track head; the OmniVGGT-only leaves load as zero, the track head's are
    skipped and listed, every other leaf is the file's."""
    from omnivggt_tpu_torch.checkpoint import write_safetensors

    cfg = _config()
    donor = M.OmniVGGT(cfg, device="cpu", seed=7).state_dict()
    sd = {k: v.clone() for k, v in donor.items() if not k.startswith(OMNIVGGT_ONLY)}
    track = {"track_head.feature_extractor.norm.weight": torch.ones(4),
             "track_head.tracker.fmap_proj.weight": torch.randn(4, 4)}
    sd.update(track)
    model = M.OmniVGGT(cfg, device="cpu", seed=1)
    assert load_vggt_layout(model, sd) == sorted(track)
    for k, v in model.state_dict().items():
        if k.startswith(OMNIVGGT_ONLY):
            assert not v.any(), k
        else:
            assert torch.equal(v, donor[k]), k
    with pytest.raises(ValueError, match="not a VGGT-layout"):
        load_vggt_layout(model, donor)
    del sd["aggregator.camera_token"]
    with pytest.raises(RuntimeError, match="camera_token"):
        load_vggt_layout(model, sd)
    # the converter's route: a file, loaded by from_safetensors(layout="vggt")
    sd["aggregator.camera_token"] = donor["aggregator.camera_token"]
    write_safetensors(str(tmp_path / "vggt.safetensors"), sd)
    loaded = M.OmniVGGT.from_safetensors(str(tmp_path / "vggt.safetensors"), cfg, device="cpu",
                                         head_dtype="float32", layout="vggt")
    assert torch.equal(loaded.state_dict()["aggregator.camera_token"],
                       donor["aggregator.camera_token"])
    assert not loaded.state_dict()["aggregator.depth_placeholder"].any()


def test_the_converter_cli_takes_a_vggt_layout(tmp_path, capsys):
    from omnivggt_tpu_torch.checkpoint import write_safetensors
    from omnivggt_tpu_torch.tools import convert_checkpoint

    donor = M.OmniVGGT(tiny_test_config(), device="cpu", seed=7).state_dict()
    sd = {k: v for k, v in donor.items() if not k.startswith(OMNIVGGT_ONLY)}
    sd["track_head.tracker.fmap_proj.weight"] = torch.randn(4, 4)
    write_safetensors(str(tmp_path / "vggt.safetensors"), sd)
    model = convert_checkpoint.main([str(tmp_path / "vggt.safetensors"), str(tmp_path / "out"),
                                     "--layout", "vggt", "--global_attention", "frame_causal",
                                     "--tiny", "--device", "cpu", "--head_dtype", "float32"])
    assert "track_head.tracker.fmap_proj.weight" in capsys.readouterr().out
    loaded = M.OmniVGGT.from_pretrained(str(tmp_path / "out"), device="cpu")
    assert loaded.config.global_attention == "frame_causal"
    assert np.array_equal(loaded.state_dict()["aggregator.register_token"].numpy(),
                          model.state_dict()["aggregator.register_token"].numpy())
