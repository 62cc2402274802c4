"""Seeded synthetic PIV pairs, rendered in bulk on the device.

Each pair follows the upstream's ``parabolic01`` test pair: Gaussian
particles (~3 px across) at uniform positions covering a set share of the
area, with uniform intensities, displaced in the second frame by a
horizontal parabolic profile u(y) = d (1 - ((y - H/2) / (H/2))^2) sampled
at each particle's pixel, then scaled so that the brightest pixel of the
pair is the bit depth's peak and rounded to integers.  Every pair draws its
own peak displacement d from the configuration's range.

All draws come from one ``torch.Generator`` seeded with the run's seed, so
a seed gives the same pool on the same device type; the particle sums
accumulate as integers in units of 2^-40, whose sum does not depend on
the order in which the device adds them.
"""

from __future__ import annotations

import math

import torch


FIXED = 2.0**40   # the particle sums' integer unit is 1 / FIXED


def _render(px, py, amp, shape, radius: float) -> torch.Tensor:
    """The (H, W) float64 sum of one frame's particles."""
    h, w = shape
    r = int(math.ceil(4 * radius))
    s2 = 2.0 * (radius / 1.5) ** 2
    off = torch.arange(-r, r + 1, device=px.device)
    ys = torch.floor(py).long()[:, None, None] + off[None, :, None]
    xs = torch.floor(px).long()[:, None, None] + off[None, None, :]
    dy = ys.to(torch.float64) - py[:, None, None]
    dx = xs.to(torch.float64) - px[:, None, None]
    val = amp[:, None, None] * torch.exp(-(dy * dy + dx * dx) / s2)
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    keep = keep.expand(val.shape)
    idx = (ys * w + xs).expand(val.shape)[keep]
    img = torch.zeros(h * w, dtype=torch.int64, device=px.device)
    img.index_put_((idx,), torch.round(val[keep] * FIXED).long(), accumulate=True)
    return (img.to(torch.float64) / FIXED).reshape(h, w)


def make_pool(cfg: dict, seed: int, n_pairs: int, device) -> tuple:
    """(im1s, im2s, peaks): (n_pairs, H, W) float32 frames on ``device`` and
    each pair's peak displacement in pixels."""
    h, w = int(cfg["height"]), int(cfg["width"])
    part = cfg["particles"]
    radius = float(part["radius"])
    lo, hi = (float(x) for x in part["intensity"])
    n = int(float(part["density"]) * h * w / (math.pi * radius**2))
    d_lo, d_hi = (float(x) for x in cfg["displacement"]["peak_px"])
    peak = float(2 ** int(cfg["bit_depth"]) - 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    yy = torch.arange(h, dtype=torch.float64, device=device)
    prof = 1.0 - ((yy - h / 2.0) / (h / 2.0)) ** 2
    out1, out2, peaks = [], [], []
    for _ in range(n_pairs):
        u = torch.rand((3, n), generator=gen, device=device, dtype=torch.float64)
        d = d_lo + (d_hi - d_lo) * torch.rand((), generator=gen, device=device,
                                               dtype=torch.float64)
        px, py = u[0] * w, u[1] * h
        amp = lo + (hi - lo) * u[2]
        shift = d * prof[py.long().clamp(0, h - 1)]
        a = _render(px, py, amp, (h, w), radius)
        b = _render(px + shift, py, amp, (h, w), radius)
        scale = peak / torch.maximum(torch.maximum(a.max(), b.max()),
                                     torch.tensor(1e-6, dtype=torch.float64, device=device))
        out1.append(torch.round((a * scale).clamp(0, peak)).to(torch.float32))
        out2.append(torch.round((b * scale).clamp(0, peak)).to(torch.float32))
        peaks.append(d)
    return torch.stack(out1), torch.stack(out2), torch.stack(peaks).tolist()
