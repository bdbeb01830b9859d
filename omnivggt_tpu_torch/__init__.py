"""omnivggt_tpu_torch — the PyTorch + Hopper port of omnivggt_tpu.

Same model, same weights (the reference's state-dict names), same inputs and
outputs as the JAX package, written in PyTorch for one NVIDIA H100. The
attention kernels are hand-written CUDA (csrc/), built by nvcc at first use;
on CPU tensors every kernel wrapper computes its plain PyTorch version.

Top-level API (the JAX package's names; the model and the loaders are
imported on first use):

    from omnivggt_tpu_torch import OmniVGGT, load_images_and_cameras
    model = OmniVGGT()                         # on "cuda", random weights from a seed
    model = OmniVGGT(device="cpu")             # the CPU only when asked for
    model = OmniVGGT.from_safetensors(path)    # reference checkpoint
    model.save_pretrained(directory)           # config.json + model.safetensors
    model = OmniVGGT.from_pretrained(directory)
    preds = model(images)                      # (S, H, W, 3) in [0, 1]

fp32 work runs in full fp32 (TF32 off) at every entry point and inside
the forward. This package imports neither JAX nor omnivggt_tpu, and reads
and writes safetensors files without the `safetensors` package.
"""

from omnivggt_tpu_torch.config import (
    AggregatorConfig,
    CameraHeadConfig,
    DPTHeadConfig,
    OmniVGGTConfig,
)

# name -> module it lives in, imported when the name is first asked for
_LAZY = {
    "OmniVGGT": "omnivggt_tpu_torch.models.omnivggt",
    "AuxInputs": "omnivggt_tpu_torch.models.aggregator",
    "InferenceSession": "omnivggt_tpu_torch.serving",
    "serve": "omnivggt_tpu_torch.serving",
    "load_images_and_cameras": "omnivggt_tpu_torch.data.loader",
    "load_and_preprocess_images": "omnivggt_tpu_torch.data.loader",
    "SceneDataset": "omnivggt_tpu_torch.data.dataset",
    "ShardedSampleStream": "omnivggt_tpu_torch.data.streaming",
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(_LAZY[name]), name)


__version__ = "0.1.0"

__all__ = [
    "AggregatorConfig",
    "CameraHeadConfig",
    "DPTHeadConfig",
    "OmniVGGTConfig",
    "OmniVGGT",
]
