"""Rotation augmentation on the device — counterpart of
``spatialvae_tpu/transforms/augment.py``.

The reference rotates each observed image with PIL's BICUBIC on the host
inside its minibatch loop.  Here, as in the JAX package, the whole batch is
resampled on the device: the inverse rotation of every output pixel centre,
then a 4 x 4 cubic-convolution stencil gathered over the batch at once (16
batched gathers; no loop over images).  Semantics of
``PIL.Image.rotate(degrees(theta), resample=BICUBIC)``: rotation about the
image centre (m/2, n/2), the same output size, pixel centres at (c + 0.5,
r + 0.5), out-of-bounds samples 0, and the cubic kernel with a = -1 (PIL's
affine-transform path).  The caller re-injects the offsets into theta.
"""

from __future__ import annotations

import torch


def _cubic_weights(t: torch.Tensor) -> tuple:
    """Cubic-convolution weights, a = -1, for the samples at offsets
    (-1, 0, 1, 2) from the base index; t in [0, 1) is the fractional
    offset."""
    a = -1.0

    def k1(x):   # |x| <= 1
        return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0

    def k2(x):   # 1 < |x| < 2
        return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a

    return (k2(t + 1.0), k1(t), k1(1.0 - t), k2(2.0 - t))


def _sample_bicubic(imgs: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Sample imgs (B, n, m, C) at continuous positions xs, ys (B, n, m) in
    the pixel-centre convention; out-of-bounds taps contribute 0.  Returns
    (B, n, m, C)."""
    b, n, m, c = imgs.shape
    flat = imgs.reshape(b, n * m, c)

    fx = xs - 0.5
    fy = ys - 0.5
    bx = torch.floor(fx)
    by = torch.floor(fy)
    tx = fx - bx
    ty = fy - by
    bx = bx.to(torch.int64)
    by = by.to(torch.int64)

    wxs = _cubic_weights(tx)
    wys = _cubic_weights(ty)

    out = torch.zeros(xs.shape + (c,), dtype=imgs.dtype, device=imgs.device)
    for dy in range(-1, 3):
        ry = by + dy
        vy = (ry >= 0) & (ry < n)
        ryc = torch.clamp(ry, 0, n - 1)
        wy = wys[dy + 1] * vy
        for dx in range(-1, 3):
            rx = bx + dx
            vx = (rx >= 0) & (rx < m)
            rxc = torch.clamp(rx, 0, m - 1)
            w = (wxs[dx + 1] * vx * wy)[..., None]
            idx = (ryc * m + rxc).reshape(b, n * m, 1).expand(b, n * m, c)
            out = out + w * torch.gather(flat, 1, idx).reshape(b, n, m, c)
    return out


def rotate_images_bicubic(images: torch.Tensor,
                          theta: torch.Tensor) -> torch.Tensor:
    """Rotate a batch of images counter-clockwise by theta (radians) about
    their centres.  images: (B, n, m) or (B, n, m, C); theta: (B,)."""
    has_c = images.dim() == 4
    imgs = images if has_c else images[..., None]
    n, m = imgs.shape[1], imgs.shape[2]
    cx, cy = m / 2.0, n / 2.0
    # output pixel centres
    ys, xs = torch.meshgrid(
        torch.arange(n, dtype=images.dtype, device=images.device) + 0.5,
        torch.arange(m, dtype=images.dtype, device=images.device) + 0.5,
        indexing="ij")
    # PIL's inverse map for a rotation by t counter-clockwise in y-down
    # image coordinates:
    #   x_in = cos(t) * (x - cx) - sin(t) * (y - cy) + cx
    #   y_in = sin(t) * (x - cx) + cos(t) * (y - cy) + cy
    c = torch.cos(theta).to(images.dtype)[:, None, None]
    s = torch.sin(theta).to(images.dtype)[:, None, None]
    xo = xs - cx
    yo = ys - cy
    xin = c * xo - s * yo + cx
    yin = s * xo + c * yo + cy
    out = _sample_bicubic(imgs, xin, yin)
    return out if has_c else out[..., 0]
