"""Framebuffer -> displayable image: gamma, Reinhard tonemap, SSAA downsample.

Mirrors ``Sampler::img`` (reference src/sampler.rs:80-99): mean over
accumulated samples, ``v^gamma``, the Reinhard variant
``v * (1 + v / (1-exp)^2) / (1 + v)``, byte quantization with saturating
cast, then a Lanczos3 resize from the supersampled resolution down to the
output resolution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tonemap(mean_rgb, gamma, exp):
    """Gamma + Reinhard tone mapping on linear radiance (sampler.rs:87-91)."""
    g = jnp.power(jnp.maximum(mean_rgb, 0.0), gamma)
    return g * (1.0 + g / (1.0 - exp) ** 2) / (1.0 + g)


def to_u8(img):
    """``(255 * v) as u8`` with Rust saturating-cast semantics."""
    v = jnp.nan_to_num(img * 255.0, nan=0.0, posinf=255.0, neginf=0.0)
    return jnp.clip(v, 0.0, 255.0).astype(jnp.uint8)


def finalize(accum, count, gamma, exp, out_wh):
    """Accumulated (H, W, 3) sums + count -> tonemapped, resized u8 image.

    Matches the reference's order exactly (sampler.rs:85-98): tonemap and
    quantize to u8 at the supersampled resolution, then Lanczos3-resize the
    8-bit image down to the output resolution.
    """
    mean = accum / count
    mapped = to_u8(tonemap(mean, gamma, exp))
    w, h = out_wh
    if mapped.shape[:2] != (h, w):
        mapped = jax.image.resize(mapped.astype(jnp.float32), (h, w, 3),
                                  method="lanczos3", antialias=True)
        mapped = jnp.clip(jnp.round(mapped), 0.0, 255.0).astype(jnp.uint8)
    return mapped
