"""The port's streaming shards (omnivggt_tpu_torch/data/streaming.py) and its
make_shards tool against the JAX package's (omnivggt_tpu/data/streaming.py,
tools/make_shards.py): the shard bytes, reading each other's shards, the
sample order under every partition and shuffle setting, batching, the
default partition from torch.distributed, and the tool's output."""

import importlib.util
import io
import sys
import tarfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from omnivggt_tpu.data import streaming as JS
from omnivggt_tpu.utils import platform as JPlatform
from omnivggt_tpu_torch.data import streaming as TS
from omnivggt_tpu_torch.tools import make_shards as TMS
from tests.test_torch_train import _write_scene

REPO = Path(__file__).resolve().parents[1]
# np.savez stamps each .npy member with the clock's time: fix it to compare bytes
FIXED_CLOCK = mock.patch("time.time", return_value=1.7e9)


def _samples(n, seed=0):
    """SceneDataset-layout samples with an index, two view counts and two
    resolutions, and (S,) masks (S = 1 for some: a (1,) mask)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        S, H = (1, 4) if i % 3 == 0 else (2, 4 + 2 * (i % 2))
        yield {
            "images": rng.uniform(size=(1, S, H, 4, 3)).astype(np.float32),
            "extrinsics": rng.normal(size=(1, S, 3, 4)).astype(np.float32),
            "idx": np.asarray([i]),
            "camera_mask": rng.uniform(size=S) < 0.5,
        }


def _equal_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_shards_bytes_equal_and_cross_readable(tmp_path):
    with FIXED_CLOCK:
        p_t = TS.write_shards(_samples(7), str(tmp_path / "t"), samples_per_shard=3)
        p_j = JS.write_shards(_samples(7), str(tmp_path / "j"), samples_per_shard=3)
    assert [Path(p).name for p in p_t] == [Path(p).name for p in p_j] == [
        "shard-000000.tar", "shard-000001.tar", "shard-000002.tar"]
    for a, b in zip(p_t, p_j):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    with tarfile.open(p_t[1]) as tar:
        assert tar.getnames() == ["sample-000000003.npz", "sample-000000004.npz",
                                  "sample-000000005.npz"]
    # each package reads the other's shards, in order, array for array
    kw = dict(shard_rank=0, num_shards=1, shuffle_shards=False, repeat=False)
    for reader, root in ((TS, "j"), (JS, "t")):
        got = list(reader.ShardedSampleStream(str(tmp_path / root / "shard-*.tar"), **kw))
        assert len(got) == 7
        for a, b in zip(got, _samples(7)):
            _equal_samples(a, b)


def _order(mod, pattern, n, **kw):
    it = iter(mod.ShardedSampleStream(pattern, **kw))
    return [int(next(it)["idx"][0]) for _ in range(n)]


@pytest.mark.parametrize("rank,world,buffer,seed", [
    (0, 1, 0, 0), (0, 1, 4, 1), (1, 2, 0, 3), (1, 3, 5, 2), (2, 4, 1, 7),
    (5, 9, 3, 4),  # more ranks than the 7 shards: the rank wraps
])
def test_sample_order_matches_jax(tmp_path, rank, world, buffer, seed):
    """Three epochs of an endless stream (the shard order and the buffer
    reshuffle each epoch), and one pass, in the JAX package's order."""
    with FIXED_CLOCK:
        TS.write_shards(_samples(20), str(tmp_path), samples_per_shard=3)  # 7 shards
    pattern = str(tmp_path / "shard-*.tar")
    kw = dict(shard_rank=rank, num_shards=world, shuffle_buffer=buffer, seed=seed)
    per_epoch = len(list(TS.ShardedSampleStream(pattern, **kw, repeat=False)))
    got = _order(TS, pattern, 3 * per_epoch, **kw)
    assert got == _order(JS, pattern, 3 * per_epoch, **kw)
    assert [int(s["idx"][0]) for s in TS.ShardedSampleStream(pattern, **kw, repeat=False)] == [
        int(s["idx"][0]) for s in JS.ShardedSampleStream(pattern, **kw, repeat=False)]
    if world > 7:
        assert per_epoch == 3  # one wrapped shard
    if seed:
        assert got[:per_epoch] != got[per_epoch : 2 * per_epoch] or per_epoch <= 1


@pytest.mark.parametrize("batch_size", [1, 2, 3])
def test_batch_stream_matches_jax(batch_size):
    """Buckets by shape, the straggler flush, the leading 1 squeezed only on
    multi-axis arrays ((1,) masks stack to (B, 1))."""
    got = list(TS.batch_stream(_samples(11), batch_size))
    want = list(JS.batch_stream(_samples(11), batch_size))
    assert len(got) == len(want) >= 3
    for a, b in zip(got, want):
        _equal_samples(a, b)
    shapes = {b["camera_mask"].shape[1:] for b in got}
    assert shapes == {(1,), (2,)}


def test_default_partition_reads_the_process_group(tmp_path):
    assert not dist.is_initialized()
    assert TS._default_partition() == (0, 1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        with mock.patch.object(dist, "get_rank", wraps=dist.get_rank) as rank:
            assert TS._default_partition() == (0, 1)
            assert rank.call_count == 1
        # a group of three seen from rank 2: the stream takes that partition
        with mock.patch.object(dist, "get_rank", return_value=2), \
                mock.patch.object(dist, "get_world_size", return_value=3):
            assert TS._default_partition() == (2, 3)
            with FIXED_CLOCK:
                TS.write_shards(_samples(8), str(tmp_path / "s"), samples_per_shard=2)
            stream = TS.ShardedSampleStream(str(tmp_path / "s" / "shard-*.tar"), seed=1)
            assert (stream.rank, stream.world) == (2, 3)
            assert stream._epoch_paths(0) == JS.ShardedSampleStream(
                str(tmp_path / "s" / "shard-*.tar"), shard_rank=2, num_shards=3,
                seed=1)._epoch_paths(0)
    finally:
        dist.destroy_process_group()
    assert TS._default_partition() == (0, 1)


def _read_all(paths):
    out = []
    for p in paths:
        with tarfile.open(p) as tar:
            for m in tar:
                with np.load(io.BytesIO(tar.extractfile(m).read())) as z:
                    out.append((m.name, {k: z[k] for k in z.files}))
    return out


def test_make_shards_matches_jax_tool(tmp_path, monkeypatch, capsys):
    """The same root and seed: the same shard files and members, the same
    samples: every array equal but the world points, within 1e-5 (the two
    packages unproject the depth with different fp32 roundings)."""
    for i in range(2):
        _write_scene(tmp_path / "scenes" / f"s{i}", seed=i)
    argv = ["--data_root", str(tmp_path / "scenes"), "--num_samples", "5", "--views", "3",
            "--target_size", "28", "--samples_per_shard", "2", "--seed", "4"]
    paths = TMS.main([*argv, "--out", str(tmp_path / "t")])
    assert "wrote 5 samples into 3 shard(s)" in capsys.readouterr().out

    monkeypatch.setattr(JPlatform, "_CACHE_DIR", str(tmp_path / "xla_cache"))
    monkeypatch.setattr(sys, "argv", ["make_shards.py", *argv, "--out", str(tmp_path / "j")])
    spec = importlib.util.spec_from_file_location("jax_make_shards", REPO / "tools" / "make_shards.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.main()
    want = sorted(str(p) for p in (tmp_path / "j").iterdir())
    assert [Path(p).name for p in paths] == [Path(p).name for p in want]
    got_s, want_s = _read_all(paths), _read_all(want)
    assert [n for n, _ in got_s] == [n for n, _ in want_s]
    for (_, a), (_, b) in zip(got_s, want_s):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5 if k == "world_points" else 0,
                                       err_msg=k)
    # the shards feed batch_stream at B=2: (2, 3, 28, 28, 3) images, (2, 3) masks
    stream = TS.ShardedSampleStream(str(tmp_path / "t" / "shard-*.tar"), repeat=False)
    batch = next(iter(TS.batch_stream(stream, 2)))
    assert batch["images"].shape == (2, 3, 28, 28, 3) and batch["camera_mask"].shape == (2, 3)
    assert torch.as_tensor(batch["camera_mask"]).dtype == torch.bool
