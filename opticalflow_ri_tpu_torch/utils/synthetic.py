"""Synthetic PIV image-pair generation for hermetic tests and benchmarks.

Generates particle images in the style of the reference's bundled test data
(512x512 8-bit pairs, Gaussian particles ~3 px diameter, displacement <= 4 px)
so tests do not depend on external assets.
"""

from __future__ import annotations

import numpy as np


def parabolic_flow(shape, max_disp=3.0):
    """A parabolic horizontal displacement profile (max at mid-height), like
    the reference's 'parabolic01' test case."""
    h, w = shape
    y = np.arange(h, dtype=np.float32)
    prof = max_disp * (1.0 - ((y - h / 2.0) / (h / 2.0)) ** 2)
    u = np.broadcast_to(prof[:, None], shape).astype(np.float32)
    v = np.zeros(shape, np.float32)
    return u, v


def particle_image_pair(shape=(128, 128), n_particles=None, seed=0, max_disp=3.0,
                        particle_radius=1.5, bit_depth=8):
    """Render a particle image and its displaced pair under a parabolic flow.

    Returns (im1, im2, u_true, v_true), images float32 in [0, 2^bit_depth-1].
    """
    h, w = shape
    rng = np.random.default_rng(seed)
    if n_particles is None:
        n_particles = int(0.06 * h * w / (np.pi * particle_radius**2))

    px = rng.uniform(0, w, n_particles)
    py = rng.uniform(0, h, n_particles)
    intens = rng.uniform(0.4, 1.0, n_particles)

    u_true, v_true = parabolic_flow(shape, max_disp)

    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]

    def render(pxs, pys):
        img = np.zeros(shape, np.float32)
        s2 = 2.0 * (particle_radius / 1.5) ** 2
        for x0, y0, a in zip(pxs, pys, intens):
            r = int(np.ceil(4 * particle_radius))
            yl, yh = max(0, int(y0) - r), min(h, int(y0) + r + 1)
            xl, xh = max(0, int(x0) - r), min(w, int(x0) + r + 1)
            if yl >= yh or xl >= xh:
                continue
            dy = ys[yl:yh] - y0
            dx = xs[:, xl:xh] - x0
            img[yl:yh, xl:xh] += a * np.exp(-(dy**2 + dx**2) / s2)
        return img

    im1 = render(px, py)
    # displacement sampled at each particle's own position
    iy = np.clip(py.astype(int), 0, h - 1)
    ix = np.clip(px.astype(int), 0, w - 1)
    im2 = render(px + u_true[iy, ix], py + v_true[iy, ix])

    peak = float(2**bit_depth - 1)
    scale = peak / max(im1.max(), im2.max(), 1e-6)
    im1 = np.round(np.clip(im1 * scale, 0, peak)).astype(np.float32)
    im2 = np.round(np.clip(im2 * scale, 0, peak)).astype(np.float32)
    return im1, im2, u_true, v_true
