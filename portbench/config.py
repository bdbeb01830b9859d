"""Configurations and traffic mixes, found by the names in BENCHMARK.json.

A configuration is `configs/<name>.json`: the published sizes the plain
reference reads (`architecture`), the overrides of the program's
`OmniVGGTConfig` (`program`), and `source`, `reduced` and `assumed`. A
traffic mix is `traffic/<name>.json`: the general driver it uses
(`driver`, a module under drivers/) and its parameters.
"""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)


def benchmark() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def cell(name: str) -> dict:
    """The BENCHMARK.json entry of workload `name`, with its configuration
    and traffic mix loaded and its per-layer metrics listed."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = dict(found[0])
    w["config_data"] = config(w["config"])
    w["traffic_data"] = traffic(w["traffic"])

    def applies(m):
        return name in m.get("workloads", [name])

    w["end_to_end"] = [m for m in bench["end_to_end"] if applies(m)]
    w["per_layer"] = [m for m in bench["per_layer"] if applies(m)]
    return w


def arch_of(cfg) -> dict:
    """The reference's architecture dict of a program OmniVGGTConfig (the
    program's object is only read: tests and the harness's own check that a
    configuration file and the program agree)."""
    a, c, d = cfg.aggregator, cfg.camera_head, cfg.depth_head
    out = {
        "img_size": cfg.img_size, "patch_size": cfg.patch_size, "embed_dim": cfg.embed_dim,
        "depth": a.depth, "num_heads": a.num_heads, "mlp_ratio": a.mlp_ratio,
        "num_register_tokens": a.num_register_tokens, "patch_embed": a.patch_embed,
        "rope_freq": a.rope_freq, "ln_eps": a.ln_eps, "pose_hidden_dim": a.pose_hidden_dim,
        "trunk_gelu": "tanh" if cfg.approx_gelu else "none",
        "camera_head": {"trunk_depth": c.trunk_depth, "num_heads": c.num_heads,
                        "mlp_ratio": c.mlp_ratio, "num_iterations": c.num_iterations,
                        "ln_eps": c.ln_eps, "adaln_eps": c.adaln_eps},
        "dpt": {"features": d.features, "out_channels": list(d.out_channels),
                "intermediate_layer_idx": list(d.intermediate_layer_idx), "ln_eps": d.ln_eps},
        "depth_head": {"output_dim": cfg.depth_head.output_dim,
                       "activation": cfg.depth_head.activation},
        "point_head": {"output_dim": cfg.point_head.output_dim,
                       "activation": cfg.point_head.activation},
    }
    if a.patch_embed != "conv":
        b = a.backbone
        out["dino"] = {"img_size": b.img_size, "embed_dim": b.embed_dim, "depth": b.depth,
                       "num_heads": b.num_heads, "mlp_ratio": b.mlp_ratio, "ln_eps": b.ln_eps}
    return out


def program_config(cfg_data: dict):
    """The program's OmniVGGTConfig for a configuration file; raises when
    the program's sizes differ from the file's architecture."""
    import dataclasses

    from omnivggt_tpu_torch.config import OmniVGGTConfig

    cfg = dataclasses.replace(OmniVGGTConfig(), **cfg_data["program"])
    if arch_of(cfg) != cfg_data["architecture"]:
        raise SystemExit("the program's configuration differs from the file's architecture: "
                         f"{arch_of(cfg)} vs {cfg_data['architecture']}")
    return cfg
