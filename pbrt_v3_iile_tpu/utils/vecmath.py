"""Vector math over (..., 3) jnp arrays.

Array-first replacement for the reference's Vector3f/Point3f/Normal3f class
hierarchy (ref: src/core/geometry.h:869 and friends).  There are no vector
classes: everything is a batched array, so the whole wavefront is one vector
operation.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-7
INF = jnp.inf
# Conservative ray-origin offset factor used instead of pbrt's exact
# error-bound offsetting (ref: src/core/interaction.h OffsetRayOrigin /
# src/core/efloat.h).  Scale-relative epsilon works in f32 for the
# target scenes and keeps the wavefront free of per-ray error state.
# 1e-4: the round-5 oracle matrix showed the old 1e-3 offset (~0.1-0.2
# units at killeroo's |p|~200) pushing shadow origins across concave
# creases of fine geometry — false self-occlusion, statue region -6.7%
# vs the reference; at 1e-4 the region agrees to +0.04% while the
# robust-offset/acne suites stay green (f32 ulp at |p| is ~6e-6*|p|,
# so 1e-4 keeps a ~16x safety margin).
RAY_EPS = 1e-4


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def absdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.abs(dot(a, b))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def length_sq(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    return a * jnp.expand_dims(jax_rsqrt_safe(dot(a, a)), -1)


def jax_rsqrt_safe(x2: jnp.ndarray) -> jnp.ndarray:
    """1/sqrt(x2) with 0 -> 0 (degenerate vectors stay zero)."""
    return jnp.where(x2 > 0.0, 1.0 / jnp.sqrt(jnp.maximum(x2, 1e-30)), 0.0)


def distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return length(a - b)


def face_forward(n: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Flip n so it lies in the hemisphere of v (ref: geometry.h Faceforward)."""
    return jnp.where(jnp.expand_dims(dot(n, v) < 0.0, -1), -n, n)


def reflect(wo: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror direction (ref: src/core/reflection.h Reflect)."""
    return -wo + 2.0 * jnp.expand_dims(dot(wo, n), -1) * n


def refract(wi: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Refract wi about n with relative IOR eta (ref: reflection.h Refract).

    Returns (wt, valid) — valid is False on total internal reflection.
    """
    cos_i = dot(n, wi)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta * eta * sin2_i
    valid = sin2_t < 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
    wt = -wi * jnp.expand_dims(eta, -1) + jnp.expand_dims(
        eta * cos_i - cos_t, -1
    ) * n
    return wt, valid


def coordinate_system(n: jnp.ndarray):
    """Build an orthonormal frame (t, b) around unit n.

    Branchless Duff et al. construction — replaces the reference's
    CoordinateSystem (geometry.h) with a select instead of a branch so the
    whole wavefront stays vectorized.
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    bt = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def to_local(v, t, b, n):
    """World -> shading frame (ref: reflection.h BSDF::WorldToLocal)."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def to_world(v, t, b, n):
    return (
        jnp.expand_dims(v[..., 0], -1) * t
        + jnp.expand_dims(v[..., 1], -1) * b
        + jnp.expand_dims(v[..., 2], -1) * n
    )


def spherical_direction(sin_theta, cos_theta, phi):
    """(ref: geometry.h SphericalDirection)."""
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta],
        axis=-1,
    )


def spherical_theta(v):
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * jnp.pi, p)


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    """Relative luminance of linear RGB (ref: spectrum.h RGBSpectrum::y())."""
    w = jnp.array([0.212671, 0.715160, 0.072169], dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def max_component(rgb: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(rgb, axis=-1)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def offset_ray_origin(p: jnp.ndarray, n: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Offset p along n (sign-matched to d) to avoid self-intersection.

    Scale-relative variant of pbrt's OffsetRayOrigin (interaction.h): offset
    grows with |p| so it stays meaningful for large scenes in f32.
    """
    scale = jnp.maximum(1.0, jnp.max(jnp.abs(p), axis=-1))
    off = jnp.expand_dims(RAY_EPS * scale, -1) * n
    return jnp.where(jnp.expand_dims(dot(d, n) < 0.0, -1), p - off, p + off)
