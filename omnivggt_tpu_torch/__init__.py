"""omnivggt_tpu_torch — the PyTorch + Hopper port of omnivggt_tpu.

Same model, same weights (the reference's state-dict names), same inputs and
outputs as the JAX package, written in PyTorch for one NVIDIA H100. The
attention kernels are hand-written CUDA (csrc/), built by nvcc at first use;
on CPU tensors every kernel wrapper computes its plain PyTorch version.

    from omnivggt_tpu_torch.models.omnivggt import OmniVGGT
    model = OmniVGGT()                         # on "cuda", random weights from a seed
    model = OmniVGGT(device="cpu")             # the CPU only when asked for
    model = OmniVGGT.from_safetensors(path)    # reference checkpoint
    preds = model(images)                      # (S, H, W, 3) in [0, 1]

This package imports neither JAX nor omnivggt_tpu.
"""

__version__ = "0.1.0"
