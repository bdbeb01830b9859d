"""Photometric training augmentation (counterpart of
omnivggt_tpu/data/augmentation.py), in torch on tensors of any device.

The reference composes a random ColorJitter, RandomGrayscale and
GaussianBlur. Here each operation is a plain function of its drawn
parameter, so it can be held to the JAX package's operation given the same
parameter, and `make_augmentation` draws the parameters from a
torch.Generator (the JAX rng stream is not reproduced). Images are
(..., H, W, 3) float in [0, 1].
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

DEFAULT_JITTER = {
    "brightness": 0.5,
    "contrast": 0.5,
    "saturation": 0.5,
    "hue": 0.1,
    "p": 0.9,
}

_LUMA = (0.299, 0.587, 0.114)


def _luma(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img.unbind(-1)
    return _LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b


def _rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img.unbind(-1)
    mx = img.amax(-1)
    d = mx - img.amin(-1)
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    # the sector of the largest channel; the first of r's is floored mod 6
    # (jnp's %, torch.remainder) so that a negative (g - b) wraps
    sector = torch.where(
        mx == r, torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0),
    )
    # divided by a tensor, not a Python number: CUDA turns a division by a
    # number into a product with its reciprocal, which rounds differently
    h = sector / torch.tensor(6.0, dtype=sector.dtype, device=sector.device)
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)[..., None]

    def select(*by_sector):
        return torch.stack(by_sector, dim=-1).gather(-1, i)[..., 0]

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * factor, 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """Towards the mean of the luma over the whole tensor, summed in float64
    so that it rounds to the same float32 on every device (the hue's round
    trip after it would magnify a last-bit difference)."""
    mean = _luma(img).double().mean().to(img.dtype)
    return torch.clamp((img - mean) * factor + mean, 0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    gray = _luma(img)[..., None]
    return torch.clamp(gray + (img - gray) * factor, 0.0, 1.0)


def adjust_hue(img: torch.Tensor, shift) -> torch.Tensor:
    """The hue rotated by `shift` (a fraction of the circle, floored mod 1)."""
    hsv = _rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + shift, 1.0)
    hsv = torch.cat([h[..., None], hsv[..., 1:]], dim=-1)
    return torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    return _luma(img)[..., None].expand(img.shape)


def gaussian_blur(img: torch.Tensor, sigma, kernel_size: int = 5) -> torch.Tensor:
    """A separable Gaussian blur with edge padding: along H, then along W.
    The taps are computed on the CPU, so every device blurs with the same
    weights."""
    x = torch.arange(kernel_size, dtype=torch.float32) - (kernel_size - 1) / 2
    k = torch.exp(-(x**2) / (2 * torch.as_tensor(sigma, dtype=torch.float32).cpu() ** 2))
    k = (k / k.sum()).to(img.device, img.dtype)
    pad = kernel_size // 2
    H, W = img.shape[-3], img.shape[-2]
    img_p = torch.cat([img[..., :1, :, :].expand(*img.shape[:-3], pad, W, 3), img,
                       img[..., -1:, :, :].expand(*img.shape[:-3], pad, W, 3)], dim=-3)
    img = sum(img_p[..., i : i + H, :, :] * k[i] for i in range(kernel_size))
    img_p = torch.cat([img[..., :, :1, :].expand(*img.shape[:-2], pad, 3), img,
                       img[..., :, -1:, :].expand(*img.shape[:-2], pad, 3)], dim=-2)
    return sum(img_p[..., :, i : i + W, :] * k[i] for i in range(kernel_size))


_JITTER_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter(img: torch.Tensor, brightness, contrast, saturation, hue,
                 order: Sequence[int] = (0, 1, 2, 3)) -> torch.Tensor:
    """torchvision-style ColorJitter with its factors given: brightness,
    contrast and saturation factors and the hue shift, applied in `order`
    (indices into that list, a permutation of 0..3)."""
    factors = (brightness, contrast, saturation, hue)
    for idx in order:
        img = _JITTER_OPS[int(idx)](img, factors[int(idx)])
    return img


def _uniform(generator: torch.Generator, lo: float, hi: float) -> float:
    u = torch.rand((), generator=generator, device=generator.device).item()
    return lo + (hi - lo) * u


def make_augmentation(
    color_jitter_params: Optional[Dict[str, float]] = None,
    gray_scale: bool = True,
    gau_blur: bool = False,
):
    """Returns augment(generator, img): ColorJitter with probability p
    (factors in [max(0, 1 - x), 1 + x], the hue shift in [-hue, hue], a
    random order), grayscale with probability 0.05, a Gaussian blur with
    probability 0.05 and sigma in [0.1, 1.0]: the reference's composition
    with its defaults.

    Every parameter is drawn from `generator` (on its own device), the same
    number of draws each call whatever is applied; the image may be on any
    device."""
    params = {**DEFAULT_JITTER, **(color_jitter_params or {})}

    def augment(generator: torch.Generator, img: torch.Tensor) -> torch.Tensor:
        u_jitter = _uniform(generator, 0.0, 1.0)
        fb = _uniform(generator, max(0.0, 1 - params["brightness"]), 1 + params["brightness"])
        fc = _uniform(generator, max(0.0, 1 - params["contrast"]), 1 + params["contrast"])
        fs = _uniform(generator, max(0.0, 1 - params["saturation"]), 1 + params["saturation"])
        fh = _uniform(generator, -params["hue"], params["hue"])
        order = torch.randperm(4, generator=generator, device=generator.device).tolist()
        u_gray = _uniform(generator, 0.0, 1.0)
        u_blur = _uniform(generator, 0.0, 1.0)
        sigma = _uniform(generator, 0.1, 1.0)
        if u_jitter < params["p"]:
            img = color_jitter(img, fb, fc, fs, fh, order)
        if gray_scale and u_gray < 0.05:
            img = to_grayscale(img)
        if gau_blur and u_blur < 0.05:
            img = gaussian_blur(img, sigma)
        return img

    return augment
