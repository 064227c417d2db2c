"""Stochastic progressive photon mapping.

Parity target: the reference's `sppm` integrator (ref:
src/integrators/sppm.cpp — per-iteration camera pass storing one visible
point per pixel + direct lighting, photon pass depositing into a spatial
hash grid, and the SPPM radius/flux statistics update with alpha = 2/3).

Wavefront restructuring: both passes are wavefronts (one jitted program
each); the photon map is a *sorted* array instead of a linked-list hash
grid — photons are hashed to cells, sorted by cell id, and every visible
point gathers from the <=8 cells its radius ball overlaps via
searchsorted + a bounded scan (K_CAP photons per cell; overflow is
counted and reported, not silently dropped).  The cell hash is re-checked
against the true photon distance, so hash collisions only cost compute,
never correctness.
"""

from __future__ import annotations

import numpy as np

from ..utils import log
import jax
import jax.numpy as jnp

from ..ops import bsdf as bsdflib
from ..ops import camera as camlib
from ..ops import intersect as isect
from ..ops import lights as lightlib
from ..ops import samplers as smplr
from ..utils import vecmath as vm

ALPHA = 2.0 / 3.0   # SPPM radius-shrink exponent (ref: sppm.cpp alpha)
K_CAP = 32          # max photons gathered per cell per visible point


def _camera_pass(scene, o0, d0, key, max_depth):
    """Trace camera rays through specular chains; returns (Ld, vp dict).

    (ref: sppm.cpp 'Generate SPPM visible points'): Le is added when
    depth==0 or after a specular bounce; one-light NEE at every surface
    vertex; the path ends (and records a visible point) at the first
    vertex with a non-specular lobe."""
    N = o0.shape[0]
    o, d = o0, d0
    beta = jnp.ones((N, 3), jnp.float32)
    alive = jnp.ones(N, bool)
    spec = jnp.zeros(N, bool)
    Ld = jnp.zeros((N, 3), jnp.float32)
    vp_valid = jnp.zeros(N, bool)
    vp_p = jnp.zeros((N, 3), jnp.float32)
    vp_wo = jnp.zeros((N, 3), jnp.float32)
    vp_beta = jnp.zeros((N, 3), jnp.float32)
    vp_frame = (jnp.zeros((N, 3), jnp.float32),) * 3
    vp_params = None

    for b in range(max_depth):
        t_max = jnp.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max)
        it = isect.make_interaction(scene, o, d, hit)
        found = hit.valid & alive

        le_ok = (b == 0) | spec
        esc = alive & (~hit.valid)
        env = lightlib.environment_le(scene, d)
        Ld = Ld + jnp.where((esc & le_ok)[:, None], beta * env, 0.0)
        emissive = found & (it.light >= 0)
        lid = jnp.maximum(it.light, 0)
        le = lightlib.area_light_le(scene, lid, it.ng, it.wo)
        Ld = Ld + jnp.where((emissive & le_ok)[:, None], beta * le, 0.0)

        ns = vm.face_forward(it.ns, it.ng)
        ng_f = vm.face_forward(it.ng, -d)
        t_f, b_f = vm.coordinate_system(ns)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        params = bsdflib.gather_params(scene, jnp.maximum(it.mat, 0),
                                       uv=it.uv, p=it.p)
        black = bsdflib.is_black(params)
        alive = found & (~black)

        # one-light NEE (light-sampling strategy only: the camera path
        # never collects Le past a non-specular vertex, so no MIS is
        # needed for unbiasedness)
        k_sel = smplr.wave_key(key, 1, b, smplr.DIM_LIGHT_SELECT)
        k_l = smplr.wave_key(key, 1, b, smplr.DIM_LIGHT_SAMPLE)
        u_sel = smplr.uniform(k_sel, (N,))
        u_l = smplr.uniform(k_l, (N, 3))
        light_id, sel_pdf = lightlib.choose_light(scene, u_sel)
        ls = lightlib.sample_li(scene, light_id, it.p, u_l)
        wi_l = vm.to_local(ls.wi, t_f, b_f, ns)
        f_l, _ = bsdflib.evaluate(params, wo_l, wi_l)
        cos_l = vm.absdot(ls.wi, ns)
        can = alive & bsdflib.has_nonspecular(params) & (ls.pdf > 0.0) & \
            (vm.luminance(ls.li) > 0.0) & (scene.n_lights > 0)
        o_sh = vm.offset_ray_origin(it.p, ng_f, ls.wi)
        # shadow length from the OFFSET origin (see path.py nee_once)
        sh_tmax = jnp.where(
            can, (ls.dist - vm.dot(o_sh - it.p, ls.wi)) * 0.999, -1.0)
        occ = isect.occluded(scene, o_sh, ls.wi, sh_tmax)
        contrib = beta * f_l * ls.li * (cos_l / jnp.maximum(
            ls.pdf * sel_pdf, 1e-12))[:, None]
        Ld = Ld + jnp.where((can & ~occ)[:, None], contrib, 0.0)

        # record the visible point at the first non-specular vertex
        is_vp = alive & bsdflib.has_nonspecular(params) & (~vp_valid)
        vp_p = jnp.where(is_vp[:, None], it.p, vp_p)
        vp_wo = jnp.where(is_vp[:, None], it.wo, vp_wo)
        vp_beta = jnp.where(is_vp[:, None], beta, vp_beta)
        vp_frame = tuple(jnp.where(is_vp[:, None], new, old)
                         for new, old in zip((t_f, b_f, ns), vp_frame))
        if vp_params is None:
            vp_params = params
        else:
            vp_params = jax.tree.map(
                lambda new, old: jnp.where(
                    is_vp[:, None] if new.ndim == 2 else is_vp, new, old),
                params, vp_params)
        vp_valid = vp_valid | is_vp
        alive = alive & (~is_vp)   # camera path ends at the visible point

        # specular continuation
        k_lobe = smplr.wave_key(key, 1, b, smplr.DIM_BSDF_LOBE)
        k_dir = smplr.wave_key(key, 1, b, smplr.DIM_BSDF_DIR)
        bs = bsdflib.sample(params, wo_l, smplr.uniform(k_lobe, (N,)),
                            smplr.uniform(k_dir, (N, 2)))
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / jnp.maximum(bs.pdf, 1e-12))[:, None]
        ok = bs.valid & alive & (vm.luminance(jnp.abs(beta_new)) > 0.0)
        beta = jnp.where(ok[:, None], beta_new, beta)
        alive = alive & ok
        spec = bs.is_specular
        o = vm.offset_ray_origin(it.p, ng_f, wi_w)
        d = wi_w

    vp = dict(valid=vp_valid, p=vp_p, wo=vp_wo, beta=vp_beta,
              frame=vp_frame, params=vp_params)
    return Ld, vp


def _photon_pass(scene, key, n_photons, max_depth):
    """Emit and trace photons; returns per-deposit SoA (positions, power,
    incident dir, valid) of shape (n_photons * max_depth, ...).

    (ref: sppm.cpp 'Trace photons and accumulate contributions'):
    deposits start at depth > 0 (the depth-0 segment is direct lighting,
    already covered by the camera pass NEE)."""
    P = n_photons
    k_sel = smplr.wave_key(key, 2, 0, smplr.DIM_LIGHT_SELECT)
    k_le = smplr.wave_key(key, 2, 0, smplr.DIM_LIGHT_SAMPLE)
    u_sel = smplr.uniform(k_sel, (P,))
    light_id, sel_pdf = lightlib.choose_light(scene, u_sel)
    em = lightlib.sample_le(scene, light_id, smplr.uniform(k_le, (P, 6)))
    beta = em.beta / jnp.maximum(sel_pdf, 1e-12)[:, None]
    o = vm.offset_ray_origin(em.o, em.d, em.d)
    d = em.d
    alive = em.valid & (scene.n_lights > 0)

    dep_p, dep_pow, dep_wi, dep_ok = [], [], [], []
    for b in range(max_depth):
        t_max = jnp.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max)
        it = isect.make_interaction(scene, o, d, hit)
        found = hit.valid & alive
        params = bsdflib.gather_params(scene, jnp.maximum(it.mat, 0),
                                       uv=it.uv, p=it.p)
        black = bsdflib.is_black(params)

        if b > 0:
            dep_p.append(it.p)
            dep_pow.append(beta)
            dep_wi.append(-d)
            dep_ok.append(found)

        alive = found & (~black)
        ns = vm.face_forward(it.ns, it.ng)
        ng_f = vm.face_forward(it.ng, -d)
        t_f, b_f = vm.coordinate_system(ns)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        k_lobe = smplr.wave_key(key, 3, b, smplr.DIM_BSDF_LOBE)
        k_dir = smplr.wave_key(key, 3, b, smplr.DIM_BSDF_DIR)
        k_rr = smplr.wave_key(key, 3, b, smplr.DIM_RR)
        bs = bsdflib.sample(params, wo_l, smplr.uniform(k_lobe, (P,)),
                            smplr.uniform(k_dir, (P, 2)))
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / jnp.maximum(bs.pdf, 1e-12))[:, None]
        ok = bs.valid & alive & (vm.luminance(jnp.abs(beta_new)) > 0.0)
        # photon russian roulette (ref: sppm.cpp q = max(0, 1-y(bnew)/y(b)))
        q = jnp.maximum(0.0, 1.0 - vm.luminance(beta_new) /
                        jnp.maximum(vm.luminance(beta), 1e-12))
        u_rr = smplr.uniform(k_rr, (P,))
        ok = ok & (u_rr >= q)
        beta = jnp.where(ok[:, None],
                         beta_new / jnp.maximum(1.0 - q, 1e-6)[:, None], beta)
        alive = alive & ok
        o = vm.offset_ray_origin(it.p, ng_f, wi_w)
        d = wi_w

    return (jnp.concatenate(dep_p), jnp.concatenate(dep_pow),
            jnp.concatenate(dep_wi), jnp.concatenate(dep_ok))


def _hash_cells(ic, m):
    """Spatial hash of int cell coords (ic (N,3)) into [0, m)."""
    h = (ic[:, 0] * jnp.int32(73856093)) ^ \
        (ic[:, 1] * jnp.int32(19349663)) ^ (ic[:, 2] * jnp.int32(83492791))
    return jnp.abs(h) % m


def _gather(vp, ph_p, ph_pow, ph_wi, ph_ok, radius, grid_origin, cell):
    """For each visible point, sum photon flux within its radius.

    Sorted-cell-id gather: ball of radius r <= cell/2 overlaps at most 2
    cells per axis.  Returns (Phi (N,3) incl. vp beta and f, M (N,),
    dropped count)."""
    Pn = ph_p.shape[0]
    m = jnp.int32(max(1, int(2 ** np.ceil(np.log2(max(Pn, 2))))))
    ic = jnp.floor((ph_p - grid_origin) / cell).astype(jnp.int32)
    h = jnp.where(ph_ok, _hash_cells(ic, m), m)  # invalid -> sentinel m
    order = jnp.argsort(h)
    h_sorted = jnp.take(h, order)
    p_s = jnp.take(ph_p, order, axis=0)
    pow_s = jnp.take(ph_pow, order, axis=0)
    wi_s = jnp.take(ph_wi, order, axis=0)

    N = vp["p"].shape[0]
    t_f, b_f, ns = vp["frame"]
    wo_l = vm.to_local(vp["wo"], t_f, b_f, ns)
    r2 = radius * radius
    lo_c = jnp.floor((vp["p"] - radius[:, None]) / cell
                     - grid_origin / cell).astype(jnp.int32)
    hi_c = jnp.floor((vp["p"] + radius[:, None]) / cell
                     - grid_origin / cell).astype(jnp.int32)

    Phi = jnp.zeros((N, 3), jnp.float32)
    M = jnp.zeros(N, jnp.float32)
    dropped = jnp.zeros(N, jnp.int32)

    seen = []   # (hash, mask) of previously visited offsets, for dedupe:
    # two distinct neighbor cells can hash to one bucket — visiting it
    # twice would double-count its photons
    for ox in range(2):
        for oy in range(2):
            for oz in range(2):
                off = jnp.array([ox, oy, oz], jnp.int32)
                cc = lo_c + off
                in_range = jnp.all(cc <= hi_c, axis=-1) & vp["valid"]
                hc = _hash_cells(cc, m)
                for h_prev, m_prev in seen:
                    in_range = in_range & ~(m_prev & (hc == h_prev))
                seen.append((hc, in_range))
                lo = jnp.searchsorted(h_sorted, hc)
                hi = jnp.searchsorted(h_sorted, hc, side="right")
                hi_cap = jnp.minimum(hi, lo + K_CAP)
                dropped = dropped + jnp.where(in_range, hi - hi_cap, 0)

                def body(k, acc):
                    Phi, M = acc
                    idx = jnp.clip(lo + k, 0, Pn - 1)
                    ok = in_range & (lo + k < hi_cap)
                    pp = jnp.take(p_s, idx, axis=0)
                    d2 = vm.length_sq(pp - vp["p"])
                    near = ok & (d2 <= r2)
                    wi_w = jnp.take(wi_s, idx, axis=0)
                    wi_l = vm.to_local(wi_w, t_f, b_f, ns)
                    f, _ = bsdflib.evaluate(vp["params"], wo_l, wi_l)
                    contrib = vp["beta"] * f * jnp.take(pow_s, idx, axis=0)
                    Phi = Phi + jnp.where(near[:, None], contrib, 0.0)
                    M = M + jnp.where(near, 1.0, 0.0)
                    return (Phi, M)

                Phi, M = jax.lax.fori_loop(0, K_CAP, body, (Phi, M))
    return Phi, M, jnp.sum(dropped)


def render_sppm(sd, n_iterations: int = 64, seed: int = 0, report=None):
    """Full SPPM render; returns (image (H,W,3) np.ndarray, stats)."""
    import time
    from . import render as renderlib
    from ..scene import device as devlib

    t0 = time.time()
    H, W = sd.film.y_resolution, sd.film.x_resolution
    N = H * W
    max_depth = sd.integrator.max_depth
    n_photons = sd.integrator.photons_per_iteration
    if n_photons <= 0:
        n_photons = N          # (ref: sppm.cpp default photonsPerIteration)
    base = renderlib.make_integrator_config(sd)
    scene = devlib.build_device_scene(sd)
    cam = camlib.make_camera(sd.camera, sd.film)
    cam_kind = camlib.KIND.get(sd.camera.kind, 0)
    key = jax.random.PRNGKey(seed)

    grid_origin = 0.5 * (scene.world_min + scene.world_max) \
        - scene.world_radius

    @jax.jit
    def iteration(it_key, radius, Nacc, tau, Ld_acc):
        px = jnp.arange(W, dtype=jnp.float32)
        py = jnp.arange(H, dtype=jnp.float32)
        gx, gy = jnp.meshgrid(px, py)
        pix = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)
        kj = smplr.wave_key(it_key, 0, 0, smplr.DIM_PIXEL_JITTER)
        o0, d0 = camlib.generate_rays(
            cam, pix + smplr.uniform(kj, (N, 2)), kind=cam_kind)
        Ld, vp = _camera_pass(scene, o0, d0, it_key, max_depth)
        ph = _photon_pass(scene, it_key, n_photons, max_depth)
        cell = 2.0 * jnp.maximum(jnp.max(radius), 1e-6)
        Phi, M, dropped = _gather(vp, *ph, radius, grid_origin, cell)
        # SPPM statistics update (ref: sppm.cpp 'Update pixel values from
        # this pass's photons')
        has = M > 0.0
        N_new = Nacc + ALPHA * M
        r_new = jnp.where(has, radius * jnp.sqrt(
            N_new / jnp.maximum(Nacc + M, 1e-6)), radius)
        ratio2 = jnp.where(has, (r_new / jnp.maximum(radius, 1e-9)) ** 2, 1.0)
        tau = (tau + Phi) * ratio2[:, None]
        return r_new, jnp.where(has, N_new, Nacc), tau, Ld_acc + Ld, dropped

    radius = jnp.full(N, float(sd.integrator.initial_radius), jnp.float32)
    Nacc = jnp.zeros(N, jnp.float32)
    tau = jnp.zeros((N, 3), jnp.float32)
    Ld_acc = jnp.zeros((N, 3), jnp.float32)
    total_dropped = 0
    for i in range(n_iterations):
        radius, Nacc, tau, Ld_acc, dropped = iteration(
            jax.random.fold_in(key, i), radius, Nacc, tau, Ld_acc)
        total_dropped += int(dropped)
        if report is not None:
            report(i + 1, n_iterations, None)

    Np = n_iterations * n_photons
    L = Ld_acc / n_iterations + tau / (
        Np * jnp.pi * jnp.maximum(radius, 1e-9)[:, None] ** 2)
    img = np.asarray(L).reshape(H, W, 3)
    dt = time.time() - t0
    rays = n_iterations * (N + n_photons) * max_depth
    if total_dropped:
        log.warning(f"sppm: {total_dropped} photon-cell overflows "
              f"(K_CAP={K_CAP}) — slight energy loss", flush=True)
    return img, dict(seconds=dt, rays=rays,
                     mrays_per_s=rays / max(dt, 1e-9) / 1e6,
                     dropped=total_dropped)
