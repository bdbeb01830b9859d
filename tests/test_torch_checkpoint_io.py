"""Checkpoints of the PyTorch port without the `safetensors` package: the
port's own safetensors reader and writer against safetensors 0.8.0 (both
directions bitwise, every dtype, with and without metadata, the same file
bytes), malformed files refused; save_pretrained / from_pretrained against
the JAX package (config.json byte for byte, a JAX-written config parsed to
an equal config, the loaded forward against the JAX apply on the same
weights, 5e-4 with fp32 heads), the offline hub path, and
tools/convert_checkpoint."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors.torch import load_file, save_file

from omnivggt_tpu import config as JC
from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.checkpoint import read_safetensors, write_safetensors
from omnivggt_tpu_torch.models import omnivggt as TM
from tests.test_torch_fastmodes import _assert_close
from tests.torch_port_util import ATOL, assert_outputs_close, t, tiny_pair


def _every_dtype(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(7, generator=g).bfloat16(),
        "f16": torch.randn(2, 2, generator=g).half(),
        "i64": torch.randint(-2**40, 2**40, (4,), generator=g),
        "bool": torch.rand(6, generator=g) > 0.5,
        "f64": torch.randn(1, generator=g).double(),
        "i32": torch.randint(-9, 9, (3,), generator=g, dtype=torch.int32),
        "i16": torch.randint(-9, 9, (2,), generator=g, dtype=torch.int16),
        "i8": torch.randint(-9, 9, (5,), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 255, (3,), generator=g, dtype=torch.uint8),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
        "transposed": torch.randn(4, 6, generator=g).t(),  # written from a strided view
    }


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}, {"format": "pt", "note": "ünïcode"}])
def test_safetensors_both_ways_bitwise(tmp_path, metadata):
    ts = _every_dtype()
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    write_safetensors(str(ours), ts, metadata)
    save_file({k: v.contiguous() for k, v in ts.items()}, str(theirs), metadata=metadata)
    _equal(load_file(str(ours)), ts)
    _equal(read_safetensors(str(theirs)), ts)
    # the same layout: header, order and padding (the package keeps
    # metadata in a hash map, so with two keys or more its order may differ)
    if metadata is None or len(metadata) == 1:
        assert ours.read_bytes() == theirs.read_bytes()


def _tamper(path, fn):
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8 : 8 + n])
    body = raw[8 + n :]
    header, body, n_override = fn(header, body)
    hb = json.dumps(header).encode()
    path.write_bytes((n_override if n_override is not None else len(hb)).to_bytes(8, "little")
                     + hb + body)


def _set(name, key, value):
    def fn(h, b):
        h[name][key] = value
        return h, b, None
    return fn


MALFORMED = {
    "header length past the end": (lambda h, b: (h, b, 1 << 30), "past the end"),
    "offsets out of range": (_set("f32", "data_offsets", [0, 10**6]), "outside the data area"),
    "offsets overlap": (_set("b", "data_offsets", [0, 8]), "overlap"),
    "offsets leave a gap": (lambda h, b: (h, b + b"\0" * 8, None), "cover"),
    "shape against bytes": (_set("f32", "shape", [3, 4]), "needs 48 bytes"),
    "unknown dtype": (_set("f32", "dtype", "F8_E4M3"), "unknown dtype"),
    "not JSON": (None, "not JSON"),
    "shorter than 8 bytes": (None, "shorter than"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_files_raise(tmp_path, case):
    """Each fault raises ValueError naming it, and a strict model load from
    such a file leaves the model as it was (no tensor is read first)."""
    fn, msg = MALFORMED[case]
    path = tmp_path / "bad.safetensors"
    write_safetensors(str(path), {"f32": torch.ones(3, 5), "a": torch.ones(2), "b": torch.ones(2)})
    if case == "not JSON":
        raw = path.read_bytes()
        n = int.from_bytes(raw[:8], "little")
        path.write_bytes(raw[:8] + b"{" * n + raw[8 + n :])
    elif case == "shorter than 8 bytes":
        path.write_bytes(b"\x01\x00")
    else:
        _tamper(path, fn)
    with pytest.raises(ValueError, match=msg):
        read_safetensors(str(path))


def test_truncated_checkpoint_leaves_the_model_untouched(tmp_path):
    cfg = TC.tiny_test_config()
    src = TM.OmniVGGT(cfg, device="cpu", seed=1)
    path = tmp_path / "model.safetensors"
    write_safetensors(str(path), src.state_dict())
    path.write_bytes(path.read_bytes()[:-1000])
    dst = TM.OmniVGGT(cfg, device="cpu", seed=2)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    from omnivggt_tpu_torch.checkpoint import load_safetensors

    with pytest.raises(ValueError):
        load_safetensors(dst, str(path))
    _equal(dst.state_dict(), before)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The tiny pair's port model written by save_pretrained."""
    jcfg, tcfg, params, model = tiny_pair(seed=0)
    d = tmp_path_factory.mktemp("pretrained")
    model.save_pretrained(str(d))
    return d


def _forward(model, images):
    with torch.inference_mode():
        return TM.apply(model, t(images), model.config)


@pytest.mark.parametrize("head_dtype", ["keep", "auto", "float32", "bfloat16"])
def test_save_then_from_pretrained(saved, head_dtype):
    jcfg, tcfg, params, model = tiny_pair(seed=0)
    loaded = TM.OmniVGGT.from_pretrained(str(saved), head_dtype=head_dtype, device="cpu")
    _equal(loaded.state_dict(), model.state_dict())
    want = {"keep": "float32", "float32": "float32", "bfloat16": "bfloat16"}.get(head_dtype)
    if want:
        assert loaded.config.head_dtype == want
    images = np.random.default_rng(3).uniform(size=(1, 2, 28, 28, 3)).astype(np.float32)
    out_t = _forward(loaded, images)
    # the loaded model computes what the saved one does under the same modes
    model.config = loaded.config
    ref_t = _forward(model, images)
    for k in ("pose_enc", "depth", "world_points"):
        assert torch.equal(out_t[k], ref_t[k]), k
    # and what the JAX package computes on the same weights under them
    modes = {f: getattr(loaded.config, f) for f in ("head_dtype", "approx_gelu", "trunk_quant",
                                                    "attn_quant", "head_quant")}
    jc = dataclasses.replace(jcfg, **modes)
    out_j = jax.jit(lambda p, x: JM.apply(p, x, jc))(params, jnp.asarray(images))
    if loaded.config.head_dtype == "float32" and not loaded.config.approx_gelu:
        assert_outputs_close(out_j, out_t, atol=ATOL)
    else:
        _assert_close(out_j, out_t, modes)


@pytest.mark.parametrize("which", ["default", "tiny"])
def test_config_json_is_the_jax_packages(tmp_path, which):
    """config.json byte for byte as the JAX package's save_pretrained
    writes it, and a JAX-written config.json parses to an equal config."""
    jcfg = JC.OmniVGGTConfig() if which == "default" else JC.tiny_test_config()
    tcfg = TC.OmniVGGTConfig() if which == "default" else TC.tiny_test_config()
    want = tmp_path / "jax.json"
    with open(want, "w") as f:
        json.dump(dataclasses.asdict(jcfg), f, indent=2)
    with open(tmp_path / "port.json", "w") as f:
        json.dump(TM.config_to_dict(tcfg), f, indent=2)
    assert (tmp_path / "port.json").read_bytes() == want.read_bytes()
    parsed = TM.config_from_dict(json.loads(want.read_text()))
    assert parsed == tcfg
    # a file written before the fast-mode fields existed takes their defaults
    raw = json.loads(want.read_text())
    for k in ("head_dtype", "approx_gelu", "trunk_quant", "attn_quant", "head_quant",
              "bounded_attn_logits"):
        raw.pop(k)
    assert TM.config_from_dict(raw) == tcfg


def test_save_pretrained_writes_the_config_and_weights(tmp_path):
    jcfg, tcfg, params, model = tiny_pair(seed=0)
    saved = tmp_path / "ckpt"
    assert model.save_pretrained(str(saved)) == str(saved)
    assert sorted(os.listdir(saved)) == ["config.json", "model.safetensors"]
    assert (saved / "config.json").read_text() == json.dumps(dataclasses.asdict(jcfg), indent=2)
    _equal(read_safetensors(str(saved / "model.safetensors")), model.state_dict())


def test_from_pretrained_offline_hub_and_typo(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub is not installed"):
        TM.OmniVGGT.from_pretrained("some-org/omnivggt", device="cpu")
    with pytest.raises(FileNotFoundError):
        TM.OmniVGGT.from_pretrained(str(tmp_path / "no" / "such" / "dir"), device="cpu")
    with pytest.raises(FileNotFoundError):
        TM.OmniVGGT.from_pretrained(str(tmp_path), device="cpu")  # a directory without config.json


def test_convert_checkpoint(tmp_path, capsys):
    from omnivggt_tpu_torch.tools import convert_checkpoint

    jcfg, tcfg, params, model = tiny_pair(seed=0)
    src = tmp_path / "ref.safetensors"
    sd = dict(model.state_dict())
    sd["aggregator._resnet_mean"] = torch.zeros(1, 3, 1, 1)  # dropped on load, as the reference's
    save_file({k: v.contiguous() for k, v in sd.items()}, str(src))
    convert_checkpoint.main([str(src), str(tmp_path / "out"), "--tiny", "--device", "cpu",
                             "--head_dtype", "float32"])
    out = capsys.readouterr().out
    assert "M params" in out and "MB in" in out
    loaded = TM.OmniVGGT.from_pretrained(str(tmp_path / "out"), device="cpu")
    _equal(loaded.state_dict(), model.state_dict())
    assert loaded.config == tcfg
