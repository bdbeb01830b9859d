"""What the drivers share: the cell's parameters, the seed, the program's
model from seeded weights, and the reference from the same weights."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import config as C


class Driver:
    kind = "infer"

    def __init__(self, cell: dict, seed: int, device, program_overrides=None, fault=None):
        """program_overrides: fields of the program's config to change (a
        lower-precision control); fault: a function planted in the timed
        path by a test (None in every benchmark run)."""
        self.cell = cell
        self.mix = cell["traffic_data"]
        self.arch = cell["config_data"]["architecture"]
        self.seed = seed
        self.device = device
        self.rng = np.random.default_rng([seed, 3 << 20])
        self.program_cfg = cell.get("program_cfg") or C.program_config(cell["config_data"])
        if program_overrides:
            self.program_cfg = dataclasses.replace(self.program_cfg, **program_overrides)
        self.fault = fault

    def sync(self):
        from portbench import harness

        harness.sync(self.device)

    def build_model(self):
        from portbench import harness

        return harness.build_model(self.program_cfg, self.arch, self.seed, self.device)

    def reference(self):
        """The plain float32 reference with the same seeded weights."""
        import torch

        from portbench.reference.model import OmniVGGT
        from portbench.weights import make_state_dict

        with torch.device("meta"):
            ref = OmniVGGT(self.arch)
        ref.to_empty(device=self.device)
        ref.load_state_dict(make_state_dict(self.arch, self.seed, self.device), strict=True)
        return ref.eval()
