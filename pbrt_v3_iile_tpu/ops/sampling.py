"""Monte-Carlo warps and MIS heuristics as vectorized jnp ops.

Semantics follow the reference's src/core/sampling.{h,cpp}; every function
maps (..., k) uniform samples to (..., d) outputs so an entire wavefront is
one vector pass.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import vecmath as vm

PI = jnp.pi
INV_PI = 1.0 / jnp.pi
INV_2PI = 1.0 / (2.0 * jnp.pi)
INV_4PI = 1.0 / (4.0 * jnp.pi)


def concentric_sample_disk(u: jnp.ndarray) -> jnp.ndarray:
    """(ref: sampling.cpp ConcentricSampleDisk) u: (..., 2) -> (..., 2)."""
    u_offset = 2.0 * u - 1.0
    ux, uy = u_offset[..., 0], u_offset[..., 1]
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = jnp.abs(ux) > jnp.abs(uy)
    r = jnp.where(use_x, ux, uy)
    theta = jnp.where(
        use_x,
        (PI / 4.0) * (uy / jnp.where(ux == 0.0, 1.0, ux)),
        (PI / 2.0) - (PI / 4.0) * (ux / jnp.where(uy == 0.0, 1.0, uy)),
    )
    pt = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, pt)


def cosine_sample_hemisphere(u: jnp.ndarray) -> jnp.ndarray:
    """(ref: sampling.h CosineSampleHemisphere) -> (..., 3), +z up."""
    d = concentric_sample_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_sphere(u: jnp.ndarray) -> jnp.ndarray:
    """(ref: sampling.cpp UniformSampleSphere)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sample_hemisphere(u: jnp.ndarray) -> jnp.ndarray:
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sample_cone(u: jnp.ndarray, cos_theta_max) -> jnp.ndarray:
    """(ref: sampling.cpp UniformSampleCone) — +z axis cone."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = u[..., 1] * 2.0 * PI
    return jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * jnp.maximum(1.0 - cos_theta_max, 1e-9))


def uniform_sample_triangle(u: jnp.ndarray) -> jnp.ndarray:
    """Barycentrics (b0, b1) (ref: sampling.cpp UniformSampleTriangle)."""
    su0 = jnp.sqrt(jnp.maximum(u[..., 0], 0.0))
    return jnp.stack([1.0 - su0, u[..., 1] * su0], axis=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """(ref: sampling.cpp PowerHeuristic) beta=2 balance."""
    f, g = nf * f_pdf, ng * g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0.0, (f * f) / jnp.where(denom > 0.0, denom, 1.0), 0.0)


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    denom = nf * f_pdf + ng * g_pdf
    return jnp.where(denom > 0.0, nf * f_pdf / jnp.where(denom > 0.0, denom, 1.0), 0.0)


def stratified_offsets_2d(nx: int, ny: int) -> jnp.ndarray:
    """Cell-center offsets for stratified jitter, shape (nx*ny, 2)."""
    ix = jnp.arange(nx * ny) % nx
    iy = jnp.arange(nx * ny) // nx
    return jnp.stack([ix / nx, iy / ny], axis=-1)
