"""Faults planted in the timed path, for the tests and the control runs
(`portbench.controls`): each must turn `correct` false. Never used by a
benchmark run.

  - altered: the program's DPT heads scale the first output of the last
    frame of every forward by 1 + 2^-4 (an answer altered where it is
    produced);
  - unchanged: the training step computes its gradients and returns the
    state without an update;
  - half_batch: the training step sees only the first half of each batch,
    its mean taken over that half;
  - bwd_dk, bwd_dq: the backward of every attention call hands autograd
    its dK (dQ) scaled by 1 + 2^-4 (planted where `ops/layers` calls the
    attention, so the CPU's plain path has it too; on the card that dK or
    dQ is the flash backward kernels').
"""

from __future__ import annotations

import contextlib

ALTERED_SCALE = 1.0 + 2.0 ** -4
BWD_SCALE = 1.0 + 2.0 ** -4


@contextlib.contextmanager
def altered():
    from omnivggt_tpu_torch.models import dpt_head

    original = dpt_head.apply

    def apply(*args, **kwargs):
        preds, conf = original(*args, **kwargs)
        preds = preds.clone()
        preds[:, -1, ..., 0] *= ALTERED_SCALE
        return preds, conf

    dpt_head.apply = apply
    try:
        yield None
    finally:
        dpt_head.apply = original


@contextlib.contextmanager
def scaled_gradient(of: str):
    """bwd_dk (of="k") and bwd_dq (of="q")."""
    import torch

    from omnivggt_tpu_torch.ops import layers

    class ScaledGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * BWD_SCALE

    original = layers.scaled_dot_product_attention

    def attend(q, k, v, *args, **kwargs):
        if of == "q":
            q = ScaledGrad.apply(q)
        else:
            k = ScaledGrad.apply(k)
        return original(q, k, v, *args, **kwargs)

    layers.scaled_dot_product_attention = attend
    try:
        yield None
    finally:
        layers.scaled_dot_product_attention = original


def unchanged(step):
    def broken(state, batch):
        metrics = step.loss_and_grads(state.model, batch, state.step)
        state.step += 1
        return state, metrics

    return broken


def half_batch(step):
    def broken(state, batch):
        half = batch["images"].shape[0] // 2
        return step(state, {k: v[:half] if v.ndim and v.shape[0] == 2 * half else v
                            for k, v in batch.items()})

    return broken


@contextlib.contextmanager
def planted(name: str):
    """(context, training step wrapper) of fault `name`."""
    if name == "altered":
        with altered():
            yield None
    elif name in ("bwd_dk", "bwd_dq"):
        with scaled_gradient(name[-1]):
            yield None
    else:
        yield {"unchanged": unchanged, "half_batch": half_batch}[name]
