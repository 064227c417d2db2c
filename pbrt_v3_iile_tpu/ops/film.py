"""Pure-functional film: accumulation buffers + reconstruction filters.

Replaces the reference's mutex-guarded Film/FilmTile (ref:
src/core/film.cpp:92-238) and IisptFilmMonitor (ref:
src/integrators/iisptfilmmonitor.cpp) with (H, W, 3) sum + (H, W) weight
arrays updated by pure adds; cross-device reduction is a psum at pass
boundaries (SURVEY P1/P7 mapping).

Filter reconstruction exploits the regular sample grid: a sample at
pixel p contributes to neighbors p+o for offsets o in a static support
window, so filtering is a sum of shifted weighted images — dense vector work,
no scatter.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class Film(NamedTuple):
    rgb: jnp.ndarray     # (H, W, 3) weighted radiance sum
    weight: jnp.ndarray  # (H, W) filter-weight sum


def new_film(h: int, w: int) -> Film:
    return Film(rgb=jnp.zeros((h, w, 3), jnp.float32),
                weight=jnp.zeros((h, w), jnp.float32))


def filter_eval(name: str, x, y, xw, yw, alpha=2.0, B=1.0 / 3, C=1.0 / 3,
                tau=3.0):
    """Filter kernels (ref: src/filters/*.cpp Evaluate)."""
    ax, ay = jnp.abs(x), jnp.abs(y)
    if name == "box":
        return jnp.where((ax <= xw) & (ay <= yw), 1.0, 0.0)
    if name == "triangle":
        return jnp.maximum(0.0, xw - ax) * jnp.maximum(0.0, yw - ay)
    if name == "gaussian":
        def g1(d, w):
            e = jnp.exp(-alpha * d * d)
            edge = jnp.exp(-alpha * w * w)
            return jnp.maximum(0.0, e - edge)
        return g1(x, xw) * g1(y, yw)
    if name == "mitchell":
        def m1(v, w):
            t = jnp.abs(2.0 * v / w)
            t3, t2 = t ** 3, t ** 2
            inner = ((12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2
                     + (6 - 2 * B)) * (1.0 / 6.0)
            outer = ((-B - 6 * C) * t3 + (6 * B + 30 * C) * t2
                     + (-12 * B - 48 * C) * t + (8 * B + 24 * C)) * (1.0 / 6.0)
            return jnp.where(t > 1.0, jnp.where(t < 2.0, outer, 0.0), inner)
        return m1(x, xw) * m1(y, yw)
    if name == "sinc":
        def s1(v, w):
            v = jnp.abs(v)
            sinc = jnp.where(v < 1e-5, 1.0,
                             jnp.sin(jnp.pi * v) / jnp.maximum(jnp.pi * v, 1e-9))
            lanczos = jnp.where(v < 1e-5, 1.0,
                                jnp.sin(jnp.pi * v / tau)
                                / jnp.maximum(jnp.pi * v / tau, 1e-9))
            return jnp.where(v > w, 0.0, sinc * lanczos)
        return s1(x, xw) * s1(y, yw)
    raise ValueError(f"unknown filter {name}")


def add_sample_image(film: Film, L: jnp.ndarray, jitter: jnp.ndarray,
                     filter_name: str = "box", xw: float = 0.5,
                     yw: float = 0.5, **fparams) -> Film:
    """Add one 1spp pass: L (H,W,3) radiance, jitter (H,W,2) in-pixel
    sample offsets.  Filter support handled by shifted adds."""
    H, W = L.shape[:2]
    if filter_name == "box" and xw <= 0.5 and yw <= 0.5:
        return Film(rgb=film.rgb + L, weight=film.weight + 1.0)
    rx = int(np.ceil(xw - 0.5))
    ry = int(np.ceil(yw - 0.5))
    rgb, wsum = film.rgb, film.weight
    for oy in range(-ry, ry + 1):
        for ox in range(-rx, rx + 1):
            # sample at pixel p lands in pixel p+o; distance from target
            # pixel center to the sample position:
            dx = jitter[..., 0] - 0.5 - ox
            dy = jitter[..., 1] - 0.5 - oy
            w = filter_eval(filter_name, dx, dy, xw, yw, **fparams)
            contrib = jnp.roll(L * w[..., None], shift=(oy, ox), axis=(0, 1))
            wshift = jnp.roll(w, shift=(oy, ox), axis=(0, 1))
            rgb = rgb + contrib
            wsum = wsum + wshift
    return Film(rgb=rgb, weight=wsum)


def resolve(film: Film) -> jnp.ndarray:
    """Weighted average -> (H,W,3) radiance (ref: film.cpp WriteImage)."""
    w = jnp.maximum(film.weight, 1e-12)[..., None]
    return jnp.where(film.weight[..., None] > 0, film.rgb / w, 0.0)


def merge_films(a: Film, b: Film) -> Film:
    """IILE direct+indirect merge: normalize both, then add (ref:
    iisptfilmmonitor.cpp:231-276 merge_into)."""
    return Film(rgb=resolve(a) + resolve(b),
                weight=jnp.ones_like(a.weight))
