"""Train-time augmentation on the device, as batched tensor ops.

Port of atq_tpu/data/augment.py: the trainer moves raw uint8 batches to the
card and normalizes and augments them there. ``_rotate_bilinear`` rotates
each NHWC image about its center by its own angle (bilinear, zero fill
outside the source frame); ``random_rotate`` draws angles uniformly from
±max_deg; ``random_hflip`` flips each image with probability p. Random
numbers come from a ``torch.Generator`` on the images' device, so they
differ from JAX's; the tests feed both packages the same angles and flips.
"""

from __future__ import annotations

import math

import torch

__all__ = ["random_rotate", "random_hflip", "classifier_augment"]


def _rotate_bilinear(images: torch.Tensor, theta: torch.Tensor):
    """Rotate each (B, H, W, C) image by ``theta[b]`` radians. At angle 0
    the grid lands on the source pixels, so the op is an exact identity."""
    b, h, w, c = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=images.device) - cy,
        torch.arange(w, dtype=torch.float32, device=images.device) - cx,
        indexing="ij")
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    # Inverse-rotate output coords into the source frame (per-sample grid).
    src_x = cos * xx + sin * yy + cx
    src_y = -sin * xx + cos * yy + cy
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = (src_x - x0)[..., None]
    fy = (src_y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = images.reshape(b, h * w, c)

    def gather(yi, xi):
        lin = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, h * w)
        return torch.gather(flat, 1, lin[..., None].expand(b, h * w, c)
                            ).reshape(b, h, w, c)

    out = (gather(y0i, x0i) * (1 - fx) * (1 - fy)
           + gather(y0i, x0i + 1) * fx * (1 - fy)
           + gather(y0i + 1, x0i) * (1 - fx) * fy
           + gather(y0i + 1, x0i + 1) * fx * fy)
    oob = ((src_x < 0) | (src_x > w - 1) | (src_y < 0)
           | (src_y > h - 1))[..., None]
    return torch.where(oob, torch.zeros((), dtype=out.dtype,
                                        device=out.device), out)


def random_rotate(images: torch.Tensor, generator: torch.Generator,
                  max_deg: float = 5.0) -> torch.Tensor:
    """Per-sample rotation by an angle uniform in ±max_deg degrees."""
    u = torch.rand(images.shape[0], generator=generator,
                   device=images.device)
    theta = (u * (2 * max_deg) - max_deg) * (math.pi / 180.0)
    return _rotate_bilinear(images, theta)


def hflip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Flip the images where the bool vector ``flips`` is set."""
    return torch.where(flips[:, None, None, None],
                       torch.flip(images, dims=(2,)), images)


def random_hflip(images: torch.Tensor, generator: torch.Generator,
                 p: float = 0.5) -> torch.Tensor:
    """Per-sample horizontal flip with probability ``p``."""
    u = torch.rand(images.shape[0], generator=generator,
                   device=images.device)
    return hflip(images, u < p)


def classifier_augment(images: torch.Tensor, generator: torch.Generator, *,
                       flip: bool = True,
                       max_deg: float = 5.0) -> torch.Tensor:
    """The classifier's train-time augmentation: RandomRotation(5), then
    RandomHorizontalFlip for Fashion-MNIST only (digits are
    chirality-sensitive)."""
    images = random_rotate(images, generator, max_deg)
    if flip:
        images = random_hflip(images, generator)
    return images
