"""Numerics primitives: padding, stencils, Gaussian, resize, warp."""
