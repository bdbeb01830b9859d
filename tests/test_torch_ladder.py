"""The certification ladder of the port against the JAX package on the CPU,
at a tiny size: certify_fast_modes walks the same rungs at the same probe
sizes and returns the same config on the same probe batch, the gate
functions decide alike, and a checkpoint load keeps and reuses its
verdict. The tiny model has the JAX package's init as its weights, as in
tests/test_torch_fastmodes.py.
"""

import dataclasses
import functools
import json
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from omnivggt_tpu.models import omnivggt as JM
from omnivggt_tpu_torch import config as TC
from omnivggt_tpu_torch.models import omnivggt as TM
from tests.torch_port_util import tiny_pair


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0, weights="jax")


@pytest.fixture(scope="module")
def pair56(pair):
    """The same weights under img_size 56 (the tiny config's conv patch
    embed has no size-dependent parameter), so the ladder's two probe
    sizes differ."""
    jcfg, tcfg, params, model = pair
    return (dataclasses.replace(jcfg, img_size=56), dataclasses.replace(tcfg, img_size=56),
            params, model)


@functools.lru_cache(maxsize=None)
def _jax_probe_forward(cfg):
    """The JAX probe forward under one config, jitted once per module run:
    the two gate settings probe many of the same configs."""
    return jax.jit(lambda p, x: JM.apply(p, x, cfg))


def _shared_probe(monkeypatch, params):
    """Hand both packages' _probe_outputs the same numpy probe batch (the
    JAX package draws its own inside; the port's generator cannot give the
    same bits) and record every config each ladder probes."""
    probed = {"jax": [], "port": []}

    def batch(probe_s, probe_hw):
        rng = np.random.default_rng(7)
        return rng.uniform(size=(1, probe_s, probe_hw, probe_hw, 3)).astype(np.float32)

    def jax_probe(p, cfg, probe_hw, probe_s):
        if probe_hw is None:
            probe_hw = min(140, cfg.img_size)
        probe_hw -= probe_hw % cfg.patch_size
        probed["jax"].append((probe_hw, cfg))
        out = _jax_probe_forward(cfg)(p, jnp.asarray(batch(probe_s, probe_hw)))
        return {k: np.asarray(out[k]) for k in TM.PROBE_KEYS}

    port_probe = TM._probe_outputs

    def recording_port_probe(model, cfg, probe_hw, probe_s):
        probed["port"].append((probe_hw, cfg))
        return port_probe(model, cfg, probe_hw, probe_s)

    monkeypatch.setattr(JM, "_probe_outputs", jax_probe)
    monkeypatch.setattr(TM, "_probe_batch", batch)
    monkeypatch.setattr(TM, "_probe_outputs", recording_port_probe)
    return probed


def _modes(cfg):
    return (cfg.head_dtype, cfg.approx_gelu, cfg.trunk_quant, cfg.attn_quant, cfg.head_quant)


@pytest.mark.parametrize(
    "gates",
    [
        # the default gates at two probe sizes: the final stage runs
        dict(probe_hw=28, final_hw=56),
        # gates that bf16 heads cannot meet: every rung falls through to
        # the parity config, and the upgrades are probed on it
        dict(probe_hw=28, final_hw=28, pose_tol=1e-4, rel_tol=1e-5),
    ],
    ids=["default_gates", "tight_gates"],
)
def test_ladder_walks_the_same_rungs_as_jax(pair56, gates, monkeypatch, caplog):
    """certify_fast_modes probes the same configs in the same order at the
    same sizes, and returns the same config, as the JAX ladder on the same
    probe batch."""
    jcfg, tcfg, params, model = pair56
    probed = _shared_probe(monkeypatch, params)
    report = []
    with caplog.at_level(logging.ERROR):
        want = JM.certify_fast_modes(params, jcfg, **gates)
        got = TM.certify_fast_modes(model, tcfg, report=report, **gates)
    assert [(hw, _modes(c)) for hw, c in probed["port"]] == \
        [(hw, _modes(c)) for hw, c in probed["jax"]]
    assert _modes(got) == _modes(want)
    assert len(report) == len(probed["port"]) - len({hw for hw, _ in probed["port"]})
    assert all(np.isfinite(r["pose_enc_maxabs"]) for r in report)
    assert TM.certification_gates(**gates) == JM.certification_gates(**gates)
    # a caller who already chose a fast mode gets the config back unprobed
    chosen = dataclasses.replace(tcfg, approx_gelu=True)
    n = len(probed["port"])
    assert TM.certify_fast_modes(model, chosen) is chosen and len(probed["port"]) == n
    # without the quantising rungs only the two bf16-head candidates are
    # walked, no upgrade is probed, and the winner is the last to pass
    cut_report = []
    with caplog.at_level(logging.ERROR):
        cut = TM.certify_fast_modes(model, tcfg, quantising_rungs=False, report=cut_report, **gates)
    walked = [_modes(c) for _, c in probed["port"][n:]]
    assert len(walked) > 1 and all(m[2:] == ("none", "none", "none") for m in walked)
    stage = "final" if gates["final_hw"] != gates["probe_hw"] else "ladder"
    passed = [r for r in cut_report if r["passed"] and r["stage"] == stage]
    winner = (passed[-1]["head_dtype"], passed[-1]["approx_gelu"]) if passed else ("float32", False)
    assert _modes(cut) == winner + ("none", "none", "none")


def test_probe_gate_functions_match_jax(pair):
    """_probe_failures: the same violations as the JAX gate on the same
    outputs, NaN readings failing; certify_head_dtype decides alike."""
    jcfg, tcfg, params, model = pair
    rng = np.random.default_rng(3)
    ref = {k: rng.normal(size=(1, 2, 4, 4, 1)).astype(np.float32) for k in TM.PROBE_KEYS}
    fast = {k: v + rng.normal(size=v.shape).astype(np.float32) * s
            for (k, v), s in zip(ref.items(), (3e-2, 1e-4, 1e-1, 1e-4))}
    for pose_tol, rel_tol in ((2e-2, 2e-2), (1.0, 1e-6), (1e-9, 1.0)):
        want = JM._probe_failures(ref, fast, pose_tol, rel_tol)
        got = TM._probe_failures(ref, fast, pose_tol, rel_tol)
        assert got.keys() == want.keys() and all(got[k] == want[k] for k in got)
    fast["depth"] = np.full_like(fast["depth"], np.nan)
    assert "depth_medrel" in TM._probe_failures(ref, fast, 1.0, 1.0)
    assert TM.certify_head_dtype(model, tcfg, probe_hw=28).head_dtype == \
        JM.certify_head_dtype(params, jcfg, probe_hw=28).head_dtype
    forced = dataclasses.replace(tcfg, head_dtype="bfloat16")
    assert TM.certify_head_dtype(model, forced) is forced


def test_certified_load_keeps_and_reuses_the_verdict(tmp_path, monkeypatch):
    """from_safetensors(head_dtype="auto") runs the ladder and writes the
    certificate; the second load reads it and probes nothing; a forced
    head dtype skips the ladder."""
    from safetensors.torch import save_file

    cfg = TC.tiny_test_config()
    src = TM.OmniVGGT(cfg, device="cpu", seed=3)
    path = tmp_path / "model.safetensors"
    save_file({k: v.contiguous() for k, v in src.state_dict().items()}, str(path))
    first = TM.OmniVGGT.from_safetensors(str(path), cfg, device="cpu")
    assert (tmp_path / "model.safetensors.certified.json").exists()

    def no_probe(*a, **k):
        raise AssertionError("a valid certificate must skip the ladder")

    monkeypatch.setattr(TM, "certify_fast_modes", no_probe)
    second = TM.OmniVGGT.from_safetensors(str(path), cfg, device="cpu")
    assert _modes(second.config) == _modes(first.config)
    forced = TM.OmniVGGT.from_safetensors(str(path), cfg, device="cpu", head_dtype="float32")
    assert _modes(forced.config) == ("float32", False, "none", "none", "none")
    # the default load certifies nothing that quantises, and says in the
    # certificate that its ladder was cut; the whole ladder (the JAX
    # package's) is asked for, and then does not take that verdict for its own
    assert _modes(first.config)[2:] == ("none", "none", "none")
    cert = json.loads((tmp_path / "model.safetensors.certified.json").read_text())
    assert cert["gates"]["quantising_rungs"] is False
    monkeypatch.undo()
    whole = []
    ladder = TM.certify_fast_modes
    monkeypatch.setattr(TM, "certify_fast_modes",
                        lambda *a, **k: (whole.append(k["quantising_rungs"]), ladder(*a, **k))[1])
    TM.OmniVGGT.from_safetensors(str(path), cfg, device="cpu", quantising_rungs=True)
    assert whole == [True]
    cert = json.loads((tmp_path / "model.safetensors.certified.json").read_text())
    assert cert["gates"] == TM.certification_gates()
