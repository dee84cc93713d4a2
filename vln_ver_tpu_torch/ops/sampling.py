"""Bilinear and trilinear grid sampling with torch ``grid_sample``
semantics.

The plain reference for the deformable-attention kernel, and the 3D
sampler of the decoder's cross-attention: a normalised
location ``u`` in [0, 1] maps to the pixel coordinate ``u * size - 0.5``
(``align_corners=False``) and every tap outside the map contributes zero,
each tap checked on its own.
"""

from __future__ import annotations

import torch


def _taps_1d(coord: torch.Tensor, size: int):
    """Return (i0, i1, w0, w1, ok0, ok1) for linear interpolation along one
    axis with zero padding; ``coord`` is in pixel space.  The bounds test
    runs on the float index, so a far-out coordinate can never wrap an
    integer conversion into range."""
    f0 = torch.floor(coord)
    w1 = coord - f0
    w0 = 1.0 - w1
    f1 = f0 + 1.0
    ok0 = (f0 >= 0) & (f0 <= size - 1)
    ok1 = (f1 >= 0) & (f1 <= size - 1)
    i0 = f0.clamp(0, size - 1).long()
    i1 = f1.clamp(0, size - 1).long()
    return i0, i1, w0, w1, ok0, ok1


def bilinear_sample_2d(value: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """Sample ``value`` (..., H, W, C) at pixel coords ``x``/``y`` (..., S).

    Leading dims of ``value`` and ``x``/``y`` must agree; returns
    (..., S, C) with zero padding outside the grid.
    """
    h, w, c = value.shape[-3:]
    vflat = value.reshape(value.shape[:-3] + (h * w, c))
    x0, x1, wx0, wx1, okx0, okx1 = _taps_1d(x, w)
    y0, y1, wy0, wy1, oky0, oky1 = _taps_1d(y, h)

    def gather(yi, xi):
        idx = (yi * w + xi)[..., None].expand(yi.shape + (c,))
        return torch.gather(vflat, -2, idx)

    def tap_w(wy, wx, ok):
        return (wy * wx * ok.to(wy.dtype))[..., None].to(value.dtype)

    return (gather(y0, x0) * tap_w(wy0, wx0, oky0 & okx0)
            + gather(y0, x1) * tap_w(wy0, wx1, oky0 & okx1)
            + gather(y1, x0) * tap_w(wy1, wx0, oky1 & okx0)
            + gather(y1, x1) * tap_w(wy1, wx1, oky1 & okx1))


def trilinear_sample_3d(value: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Sample ``value`` (..., D, H, W, C) at pixel coords ``x``/``y``/``z``
    (..., S): ``x`` indexes W, ``y`` H and ``z`` D (the 5-D grid_sample
    convention, grid (x, y, z)).  Returns (..., S, C) with zero padding
    outside the grid, each of the 8 taps checked on its own in float."""
    d, h, w, c = value.shape[-4:]
    vflat = value.reshape(value.shape[:-4] + (d * h * w, c))

    def axis(coord, size):
        i0, i1, w0, w1, ok0, ok1 = _taps_1d(coord, size)
        return (i0, w0, ok0), (i1, w1, ok1)

    out = 0.0
    for zi, wz, okz in axis(z, d):
        for yi, wy, oky in axis(y, h):
            for xi, wx, okx in axis(x, w):
                idx = ((zi * h + yi) * w + xi)[..., None].expand(
                    xi.shape + (c,))
                wgt = wz * wy * wx * (okz & oky & okx).to(wz.dtype)
                out = out + torch.gather(vflat, -2, idx) * wgt[
                    ..., None].to(value.dtype)
    return out
