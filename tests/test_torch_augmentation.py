"""The port's photometric augmentation (omnivggt_tpu_torch/data/augmentation.py)
against the JAX package's (omnivggt_tpu/data/augmentation.py).

The two packages draw the parameters from different generators, so each
operation is held to the JAX one given the same parameter (within 1e-6;
the hue within 1e-5, where floor(6 h) may pick the neighbouring sector at
a boundary and the output is continuous), and `make_augmentation` is held
to its own contract: deterministic per generator seed, in [0, 1], jitter
at a rate near its p.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from omnivggt_tpu.data import augmentation as JA
from omnivggt_tpu_torch.data import augmentation as TA


def _image(seed, hw=(9, 11)):
    return np.random.default_rng(seed).uniform(size=(*hw, 3)).astype(np.float32)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("name,param", [
    ("adjust_brightness", 0.6), ("adjust_brightness", 1.4),
    ("adjust_contrast", 0.55), ("adjust_contrast", 1.45),
    ("adjust_saturation", 0.5), ("adjust_saturation", 1.5),
    ("gaussian_blur", 0.1), ("gaussian_blur", 0.73),
    ("to_grayscale", None),
])
def test_operation_matches_jax(name, param):
    img = _image(1)
    args = () if param is None else (np.float32(param),)
    want = getattr(JA, name)(jnp.asarray(img), *(jnp.float32(a) for a in args))
    got = getattr(TA, name)(torch.from_numpy(img), *(float(a) for a in args))
    assert got.shape == img.shape
    _close(got, want)


def _hue_image():
    """Random pixels, grey pixels (r = g = b, black and white too), pixels
    whose largest channel is tied, and pure colours on the six sector
    boundaries."""
    rng = np.random.default_rng(2)
    px = [rng.uniform(size=(40, 3))]
    px.append(np.repeat(np.array([0.0, 0.3, 0.5, 1.0])[:, None], 3, 1))
    px.append(np.array([[0.7, 0.7, 0.2], [0.2, 0.6, 0.6], [0.5, 0.1, 0.5], [0.9, 0.9, 0.9]]))
    px.append(np.array([[1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], [1, 0, 1]], float))
    px = np.concatenate(px).astype(np.float32)
    return px.reshape(6, 9, 3)


@pytest.mark.parametrize("shift", [-0.5, -0.1, -0.03, 0.0, 0.04, 0.1, 0.5])
def test_hue_matches_jax(shift):
    img = _hue_image()
    want = JA.adjust_hue(jnp.asarray(img), jnp.float32(shift))
    got = TA.adjust_hue(torch.from_numpy(img), float(np.float32(shift)))
    _close(got, want, atol=1e-5)
    # the round trip alone (a zero shift) keeps every pixel
    if shift == 0.0:
        _close(got, img, atol=1e-5)


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0), (2, 0, 3, 1)])
def test_color_jitter_matches_the_jax_operations_in_order(order):
    img = _image(3)
    factors = (np.float32(1.3), np.float32(0.7), np.float32(1.2), np.float32(-0.06))
    ops = (JA.adjust_brightness, JA.adjust_contrast, JA.adjust_saturation, JA.adjust_hue)
    want = jnp.asarray(img)
    for idx in order:
        want = ops[idx](want, jnp.float32(factors[idx]))
    got = TA.color_jitter(torch.from_numpy(img), *(float(f) for f in factors), order=order)
    _close(got, want, atol=1e-5)


def _augment(seed, img, **kw):
    return TA.make_augmentation(**kw)(torch.Generator().manual_seed(seed), img)


def test_make_augmentation_is_deterministic_and_bounded():
    img = torch.from_numpy(_image(4))
    for kw in ({}, {"gau_blur": True}, {"gray_scale": False}):
        a, b = _augment(7, img, **kw), _augment(7, img, **kw)
        assert torch.equal(a, b)
        outs = [_augment(s, img, **kw) for s in range(8)]
        assert sum(not torch.equal(outs[0], o) for o in outs[1:]) >= 6
        for o in outs:
            assert o.shape == img.shape and o.min() >= 0.0 and o.max() <= 1.0


def test_make_augmentation_jitters_at_its_rate():
    """Without grayscale and blur an output differs from its input exactly
    when the jitter ran: the share over 400 draws is near p = 0.9 (the
    binomial standard deviation is 0.015); each draw consumes the same
    number of values, so one generator serves every view."""
    img = torch.from_numpy(_image(5, (4, 4)))
    augment = TA.make_augmentation(gray_scale=False)
    gen = torch.Generator().manual_seed(0)
    changed = sum(not torch.equal(augment(gen, img), img) for _ in range(400)) / 400
    assert 0.84 <= changed <= 0.96, changed
    never = TA.make_augmentation({"p": 0.0}, gray_scale=False)
    assert all(torch.equal(never(gen, img), img) for _ in range(20))
