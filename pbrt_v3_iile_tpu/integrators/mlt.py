"""Primary-sample-space Metropolis light transport (PSSMLT).

Parity target: the reference's `mlt` integrator (ref:
src/integrators/mlt.cpp — Kelemen-style primary-sample-space Metropolis;
MLTSampler mutations mlt.cpp:57-107, bootstrap + b estimate
mlt.cpp:Render, expected-values splatting with weights
(a + large)/ (I/b + pLarge)).

Wavefront restructuring: instead of one sequential chain per thread,
thousands of independent Markov chains run as one wavefront — each chain
is a row of a (C, D) primary-sample matrix, one `trace_paths` call
evaluates every chain's proposal simultaneously, and `lax.scan` advances
all chains one mutation per step.  Splats scatter-add into the film on
device.  The estimator is the standard Veach expected-values technique,
so results are unbiased given the bootstrap estimate of b.

Primary-sample layout per chain:
  u[0:2]  film position in [0,1)^2
  u[2:4]  lens sample
  u[4:]   (max_depth+1) x PRIM_DIMS_PER_BOUNCE bounce dims (path.py)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import camera as camlib
from ..utils import vecmath as vm
from . import path as pathlib_


class MLTConfig(NamedTuple):
    max_depth: int = 5
    n_chains: int = 1024          # parallel Markov chains (wavefront)
    n_bootstrap: int = 4096       # samples for the b estimate + chain init
    p_large: float = 0.3          # large-step probability (ref mlt.cpp
                                  # "largestepprobability" default 0.3)
    sigma: float = 0.01           # small-step size (ref default 0.01)
    bdpt: bool = True             # Metropolis over BDPT proposals with
                                  # depth-stratified (s,t) selection
                                  # (ref: mlt.cpp:36,144-153); False =
                                  # the older unidirectional PSSMLT


def _dims(cfg: MLTConfig) -> int:
    if cfg.bdpt:
        return _dims_bdpt(cfg.max_depth)
    return 4 + (cfg.max_depth + 1) * pathlib_.PRIM_DIMS_PER_BOUNCE


def _dims_bdpt(max_depth: int) -> int:
    T = max_depth + 1
    S = max_depth
    # film2 + depth + strategy + lens2 + cam T*3 + lit S*3 + root7 + nee T*4
    return 6 + 3 * T + 3 * S + 7 + 4 * T


def _eval_bdpt(scene, cam, cam_kind, has_lens, u, max_depth):
    """Deterministic single-strategy BDPT estimate of the path encoded
    by u (ref: mlt.cpp MLT::L — depth from one dim, (s,t) from the
    next, ConnectBDPT on explicit sampler streams, result scaled by the
    per-depth strategy count).  t >= 2 strategies only (light-tracing
    t=1 splats need the camera importance model; excluded like the
    non-pinhole reference path), so nStrategies = depth + 1 with
    s in [0, depth] and t = depth + 2 - s."""
    from . import bdpt as bdptlib

    C = u.shape[0]
    T = max_depth + 1
    S = max_depth
    film_xy = u[:, 0:2]
    depth = jnp.minimum((u[:, 2] * (max_depth + 1)).astype(jnp.int32),
                        max_depth)
    nstrat = depth + 1
    s_sel = jnp.minimum((u[:, 3] * nstrat.astype(jnp.float32))
                        .astype(jnp.int32), nstrat - 1)
    t_sel = depth + 2 - s_sel

    p_film = film_xy * cam.resolution.astype(jnp.float32)
    u_lens = u[:, 4:6] if has_lens else None
    o, d = camlib.generate_rays(cam, p_film, u_lens, kind=cam_kind)
    off = 6
    u_cam = u[:, off:off + 3 * T].reshape(C, T, 3)
    off += 3 * T
    u_lit = u[:, off:off + 3 * S].reshape(C, S, 3)
    off += 3 * S
    u_root = u[:, off:off + 7]
    off += 7
    u_nee = u[:, off:off + 4 * T].reshape(C, T, 4)
    u_ext = dict(cam=u_cam, lit=u_lit, root=u_root, nee=u_nee)

    key = jax.random.PRNGKey(0)  # unused: all draws come from u_ext
    L, _ = bdptlib.trace_bdpt(scene, o, d, key, max_depth,
                              u_ext=u_ext,
                              sel_st=(s_sel, t_sel))
    # scale by the strategy count AND the uniform depth selection
    # (ref: mlt.cpp L() "* nStrategies" + Render()
    # "b = bootstrap.funcInt * (maxDepth + 1)")
    scale = (nstrat.astype(jnp.float32) * (max_depth + 1))[:, None]
    return L * scale, film_xy


def _eval(scene, cam, cam_kind, has_lens, u, path_cfg):
    """f(u): deterministic radiance of the path encoded by u.

    Returns (L (C,3), film_xy (C,2) in [0,1)^2)."""
    C = u.shape[0]
    film_xy = u[:, 0:2]
    p_film = film_xy * cam.resolution.astype(jnp.float32)
    u_lens = u[:, 2:4] if has_lens else None
    o, d = camlib.generate_rays(cam, p_film, u_lens, kind=cam_kind)
    u_prim = u[:, 4:].reshape(C, path_cfg.max_depth + 1,
                              pathlib_.PRIM_DIMS_PER_BOUNCE)
    key = jax.random.PRNGKey(0)  # unused: all draws come from u_prim
    L, _ = pathlib_.trace_paths(scene, o, d, key, path_cfg, u_prim=u_prim)
    return L, film_xy


def _mutate(u, key, sigma, p_large):
    """Kelemen mutation: large step = fresh uniform; small step = wrapped
    gaussian perturbation (ref: mlt.cpp MLTSampler::EnsureReady
    mutation kernel, sqrt(2)*sigma*ErfInv(2u-1))."""
    C, D = u.shape
    k_large, k_u, k_pert = jax.random.split(key, 3)
    fresh = jax.random.uniform(k_large, (C, D))
    eps = jax.random.uniform(k_pert, (C, D), minval=1e-7, maxval=1.0 - 1e-7)
    dv = jnp.sqrt(2.0) * sigma * jax.scipy.special.erfinv(2.0 * eps - 1.0)
    perturbed = jnp.mod(u + dv, 1.0)
    is_large = jax.random.uniform(k_u, (C, 1)) < p_large
    return jnp.where(is_large, fresh, perturbed), is_large[:, 0]


def render_mlt(sd, mutations_per_pixel: int = 64, seed: int = 0,
               cfg: MLTConfig = None):
    """Full MLT render; returns (image (H,W,3) np.ndarray, stats dict)."""
    import time
    from . import render as renderlib
    from ..scene import device as devlib

    t0 = time.time()
    H, W = sd.film.y_resolution, sd.film.x_resolution
    if cfg is None:
        cfg = MLTConfig(max_depth=sd.integrator.max_depth,
                        p_large=getattr(sd.integrator, "mlt_p_large", 0.3),
                        sigma=getattr(sd.integrator, "mlt_sigma", 0.01))
    base = renderlib.make_integrator_config(sd, accel="bvh")
    path_cfg = base._replace(max_depth=cfg.max_depth, nee=True,
                             nee_all=False, direct_only=False)
    scene = devlib.build_device_scene(sd)
    cam = camlib.make_camera(sd.camera, sd.film)
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    has_lens = sd.camera.lens_radius > 0.0
    D = _dims(cfg)
    key = jax.random.PRNGKey(seed)

    if cfg.bdpt:
        def eval_fn(u):
            return _eval_bdpt(scene, cam, cam_kind, has_lens, u,
                              cfg.max_depth)
    else:
        def eval_fn(u):
            return _eval(scene, cam, cam_kind, has_lens, u, path_cfg)

    # ---- bootstrap: estimate b = E[I(u)] and seed the chains ----
    # (ref: mlt.cpp Render "Generate bootstrap samples and compute
    # normalization constant b")
    k_boot, k_sel, k_run = jax.random.split(key, 3)

    @jax.jit
    def bootstrap(k):
        u = jax.random.uniform(k, (cfg.n_bootstrap, D))
        L, _ = eval_fn(u)
        return u, vm.luminance(jnp.abs(L))

    u_boot, I_boot = bootstrap(k_boot)
    b = float(jnp.mean(I_boot))
    if b <= 0.0:
        return np.zeros((H, W, 3), np.float32), dict(seconds=0.0, b=0.0)
    # chain starts ~ I(u) (the stationary distribution)
    idx = jax.random.categorical(
        k_sel, jnp.log(jnp.maximum(I_boot, 1e-20)), shape=(cfg.n_chains,))
    u0 = u_boot[idx]

    n_total = mutations_per_pixel * H * W
    n_steps = max(1, n_total // cfg.n_chains)

    def splat(film, film_xy, w, L):
        px = jnp.clip((film_xy[:, 0] * W).astype(jnp.int32), 0, W - 1)
        py = jnp.clip((film_xy[:, 1] * H).astype(jnp.int32), 0, H - 1)
        return film.at[py, px].add(w[:, None] * L)

    @jax.jit
    def chain_scan(u0, k):
        L0, xy0 = eval_fn(u0)
        I0 = vm.luminance(jnp.abs(L0))
        film0 = jnp.zeros((H, W, 3), jnp.float32)

        def step(carry, k_step):
            u, L, I, xy, film = carry
            u_new, is_large = _mutate(u, k_step, cfg.sigma, cfg.p_large)
            L_new, xy_new = eval_fn(u_new)
            I_new = vm.luminance(jnp.abs(L_new))
            a = jnp.minimum(1.0, I_new / jnp.maximum(I, 1e-20))
            # expected-values splatting (ref: mlt.cpp Run:
            # AddSplat(pProposed, L*a/L.y()); AddSplat(pCur, L*(1-a)/L.y()))
            w_new = jnp.where(I_new > 0.0,
                              a / jnp.maximum(I_new, 1e-20), 0.0)
            w_cur = jnp.where(I > 0.0,
                              (1.0 - a) / jnp.maximum(I, 1e-20), 0.0)
            del is_large  # large steps only serve ergodicity here
            film = splat(film, xy_new, w_new, L_new)
            film = splat(film, xy, w_cur, L)
            k_acc = jax.random.fold_in(k_step, 7)
            accept = jax.random.uniform(k_acc, a.shape) < a
            u = jnp.where(accept[:, None], u_new, u)
            L = jnp.where(accept[:, None], L_new, L)
            I = jnp.where(accept, I_new, I)
            xy = jnp.where(accept[:, None], xy_new, xy)
            return (u, L, I, xy, film), None

        ks = jax.random.split(k, n_steps)
        (u, L, I, xy, film), _ = jax.lax.scan(
            step, (u0, L0, I0, xy0, film0), ks)
        return film

    film = chain_scan(u0, k_run)
    # final scale (ref: mlt.cpp film.WriteImage(b / mutationsPerPixel))
    done = n_steps * cfg.n_chains
    img = np.asarray(film) * (b * H * W / done)
    return img, dict(seconds=time.time() - t0, b=b,
                     mutations=done, chains=cfg.n_chains)
