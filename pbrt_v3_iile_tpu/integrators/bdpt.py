"""Bidirectional path tracing.

Parity target: the reference's `bdpt` integrator (ref:
src/integrators/bdpt.cpp — GenerateCameraSubpath / GenerateLightSubpath,
ConnectBDPT over all (s,t) strategies, and the MISWeight product-of-
ratios formula with remap0 + delta-flag handling, bdpt.cpp:MISWeight).

Wavefront restructuring, tuned for XLA compile cost as much as runtime:

- Subpaths are random-walked by ONE `lax.scan` each (camera + light), so
  the BVH traversal and BSDF machinery are instantiated once per walk
  instead of once per bounce; vertices come out as stacked SoA arrays
  and are sliced per-bounce for the strategy loop.
- The (s,t) strategy double-loop is static, but per camera-vertex t ALL
  of the iteration's BSDF evaluations are concatenated into one
  `bsdf.evaluate` call and ALL of its connection shadow rays into one
  `occluded` call — a handful of heavy instantiations total, where the
  naive form had ~4 per strategy (the difference between minutes and
  seconds of XLA compile at maxdepth 5).

**t=1 (light tracing)** uses a pure-functional splat film: each pass
returns a dense (H*W+1, 3) scatter-added splat image (aux["splat"]) that
the driver accumulates and adds at resolve time with the 1/spp splat
scale (ref: bdpt.cpp ConnectBDPT t==1 branch + film.cpp:160 AddSplat +
WriteImage(1/spp)).  Camera importance terms come from ops/camera.py
sample_wi/pdf_we_dir (perspective pinhole; other camera kinds fall back
to the no-light-tracing strategy set, with the t'=1 term consistently
excluded from every MIS weight so the partition of unity is preserved
either way).

One deliberate design deviation (unbiased): **infinite lights are
handled pairwise** (escape vs NEE power heuristic exactly as the
wavefront path integrator) instead of through the vertex machinery;
light subpaths start from finite lights only.  Weights for env paths
still sum to one because those are the only two strategies that can
produce them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import vecmath as vm
from ..ops import bsdf as bsdflib
from ..ops import intersect as isect
from ..ops import lights as lightlib
from ..ops import samplers as smplr
from ..ops import sampling as smp


def _remap0(x):
    """(ref: bdpt.cpp remap0) treat 0-density as 1 in MIS ratios."""
    return jnp.where(x > 0.0, x, 1.0)


def _convert(pdf_sa, p_from, p_to, ns_to):
    """Solid-angle pdf at p_from -> area density at p_to
    (ref: bdpt.h Vertex::ConvertDensity)."""
    w = p_to - p_from
    d2 = vm.length_sq(w)
    inv_d2 = jnp.where(d2 > 0.0, 1.0 / jnp.maximum(d2, 1e-20), 0.0)
    cos_t = jnp.abs(vm.dot(ns_to, w)) * jnp.sqrt(inv_d2)
    return pdf_sa * cos_t * inv_d2


def _new_vertex(N):
    z3 = jnp.zeros((N, 3), jnp.float32)
    z1 = jnp.zeros(N, jnp.float32)
    return dict(valid=jnp.zeros(N, bool), p=z3, ng=z3, ns=z3, wo=z3,
                beta=jnp.ones((N, 3), jnp.float32), pdf_fwd=z1, pdf_rev=z1,
                delta=jnp.zeros(N, bool), light=jnp.full(N, -1, jnp.int32),
                params=None, t_f=z3, b_f=z3)


def _local(v, w):
    return vm.to_local(w, v["t_f"], v["b_f"], v["ns"])


class _EvalBatch:
    """Deferred-batched BSDF evaluations: enqueue (vertex, wo_w, wi_w)
    world-space requests, run ONE bsdf.evaluate on the concatenation,
    read back (f, pdf) slices.  Exists purely to keep the XLA graph
    small — semantics identical to per-request evaluate calls."""

    def __init__(self, enable_hair=True):
        self.reqs = []
        self.out = None
        self.enable_hair = enable_hair

    def add(self, v, wo_w, wi_w) -> int:
        self.reqs.append((v["params"], _local(v, wo_w), _local(v, wi_w)))
        return len(self.reqs) - 1

    def run(self):
        if not self.reqs:
            self.out = []
            return
        params = jax.tree.map(lambda *xs: jnp.concatenate(xs),
                              *[r[0] for r in self.reqs])
        wo = jnp.concatenate([r[1] for r in self.reqs])
        wi = jnp.concatenate([r[2] for r in self.reqs])
        f, pdf = bsdflib.evaluate(params, wo, wi,
                                  enable_hair=self.enable_hair)
        n = self.reqs[0][1].shape[0]
        self.out = [(f[i * n:(i + 1) * n], pdf[i * n:(i + 1) * n])
                    for i in range(len(self.reqs))]

    def f(self, i):
        return self.out[i][0]

    def pdf(self, i):
        return self.out[i][1]


class _ShadowBatch:
    """Deferred-batched occlusion tests: one `occluded` call for all of a
    t-iteration's connection rays (ref: every ConnectBDPT strategy's
    VisibilityTester, batched)."""

    def __init__(self):
        self.reqs = []
        self.out = None

    def add(self, o, d, tmax) -> int:
        self.reqs.append((o, d, tmax))
        return len(self.reqs) - 1

    def run(self, scene):
        if not self.reqs:
            self.out = []
            return
        o = jnp.concatenate([r[0] for r in self.reqs])
        d = jnp.concatenate([r[1] for r in self.reqs])
        tm = jnp.concatenate([r[2] for r in self.reqs])
        occ = isect.occluded(scene, o, d, tm)
        n = self.reqs[0][0].shape[0]
        self.out = [occ[i * n:(i + 1) * n] for i in range(len(self.reqs))]

    def occ(self, i):
        return self.out[i]


def _subpath(scene, o0, d0, beta0, pdf_dir0, key, n_verts, stream, root_delta, collect_env=False, inf_sel_pdf=None,
             root=None, u_vert=None, sel_esc=None):
    """Random-walk a subpath of up to n_verts surface vertices with one
    lax.scan (ref: bdpt.cpp RandomWalk).  Returns (verts list, L_escape);
    verts[i] is the i-th SURFACE vertex as a dict of (N, ...) arrays
    (sliced views of the scan's stacked outputs).  The root camera/light
    vertex is handled by the caller; its pdf_rev (set by the first
    surface vertex's reverse scatter in the reference) is written into
    `root` when given."""
    N = o0.shape[0]
    if inf_sel_pdf is None:
        inf_sel_pdf = jnp.zeros(())

    def body(carry, b):
        (o, d, beta, alive, pdf_dir, prev_delta, prev_p, prev_ns,
         L_esc) = carry
        t_max = jnp.where(alive, 1e30, -1.0)
        hit = isect.intersect(scene, o, d, t_max)
        it = isect.make_interaction(scene, o, d, hit)
        found = hit.valid & alive

        if collect_env:
            esc = alive & (~hit.valid)
            if sel_esc is not None:
                # single-strategy mode: the escape at segment b is the
                # (s=0, t=b+2) strategy (mlt.cpp depth-stratified eval)
                esc = esc & sel_esc[0] & (sel_esc[1] == b + 2)
            env = lightlib.environment_le(scene, d)
            env_pdf = jnp.where(
                scene.has_env_map > 0,
                lightlib._env_dir_pdf(scene, d), smp.INV_4PI) * inf_sel_pdf
            w = jnp.where((b == 0) | prev_delta, 1.0,
                          smp.power_heuristic(1.0, pdf_dir, 1.0, env_pdf))
            L_esc = L_esc + jnp.where(esc[:, None],
                                      beta * env * w[:, None], 0.0)

        ns = vm.face_forward(it.ns, it.ng)
        t_f, b_f = vm.coordinate_system(ns)
        params = bsdflib.gather_params(scene, jnp.maximum(it.mat, 0),
                                       uv=it.uv, p=it.p)
        v = dict(valid=found, p=it.p, ng=it.ng, ns=ns, wo=it.wo,
                 beta=beta, light=jnp.where(found, it.light, -1),
                 t_f=t_f, b_f=b_f, params=params,
                 pdf_fwd=jnp.where(found,
                                   _convert(pdf_dir, prev_p, it.p, ns),
                                   0.0))

        # continuation sample (u_vert: explicit primary samples for
        # Metropolis determinism — integrators/mlt.py bdpt mode)
        wo_l = vm.to_local(it.wo, t_f, b_f, ns)
        if u_vert is not None:
            uv = jnp.take(u_vert, b, axis=1)      # (N, 3)
            u_lobe = uv[:, 0]
            u_dir = uv[:, 1:3]
        else:
            k_lobe = smplr.wave_key(key, stream, b, smplr.DIM_BSDF_LOBE)
            k_dir = smplr.wave_key(key, stream, b, smplr.DIM_BSDF_DIR)
            u_lobe = smplr.uniform(k_lobe, (N,))
            u_dir = smplr.uniform(k_dir, (N, 2))
        bs = bsdflib.sample(params, wo_l, u_lobe, u_dir)
        v["delta"] = bs.is_specular
        wi_w = vm.to_world(bs.wi, t_f, b_f, ns)
        # reverse density onto the previous vertex (area measure there)
        _, rev_sa = bsdflib.evaluate(params, vm.to_local(wi_w, t_f, b_f, ns),
                                     wo_l)
        rev_sa = jnp.where(bs.is_specular, 0.0, rev_sa)
        rev_prev = jnp.where(found,
                             _convert(rev_sa, it.p, prev_p, prev_ns), 0.0)

        cos_w = vm.absdot(wi_w, ns)
        beta_new = beta * bs.f * (cos_w / jnp.maximum(bs.pdf,
                                                      1e-12))[:, None]
        black = bsdflib.is_black(params)
        ok = found & bs.valid & (~black) & \
            (vm.luminance(jnp.abs(beta_new)) > 0.0)
        beta_o = jnp.where(ok[:, None], beta_new, beta)
        pdf_dir_o = jnp.where(bs.is_specular, 1.0, bs.pdf)
        ng_f = vm.face_forward(it.ng, it.wo)
        o_o = jnp.where(ok[:, None],
                        vm.offset_ray_origin(it.p, ng_f, wi_w), o)
        d_o = jnp.where(ok[:, None], wi_w, d)
        carry_o = (o_o, d_o, beta_o, ok, pdf_dir_o, bs.is_specular,
                   it.p, ns, L_esc)
        ys = dict(v=v, rev_prev=rev_prev)
        return carry_o, ys

    L0 = jnp.zeros((N, 3), jnp.float32)
    carry0 = (o0, d0, beta0, jnp.ones(N, bool), pdf_dir0, root_delta,
              o0, jnp.zeros((N, 3), jnp.float32), L0)
    carry, ys = jax.lax.scan(body, carry0, jnp.arange(n_verts))
    L_esc = carry[8]

    stacked, rev_prev = ys["v"], ys["rev_prev"]  # leaves (B, N, ...)
    verts = []
    for i in range(n_verts):
        v = jax.tree.map(lambda a: a[i], stacked)
        # vertex i's pdf_rev was emitted by vertex i+1's reverse scatter
        v["pdf_rev"] = (rev_prev[i + 1] if i + 1 < n_verts
                        else jnp.zeros(N, jnp.float32))
        verts.append(v)
    if root is not None and n_verts > 0:
        root["pdf_rev"] = rev_prev[0]
    return verts, L_esc


def _mis_weight(cam, lit, s, t, rev_over, delta_over, lit0_delta_pos,
                with_t1: bool = False):
    """(ref: bdpt.cpp MISWeight) product-of-ratios over alternate
    strategies with the same path length.  with_t1 includes the t'=1
    (light-tracing) alternative — only valid when the camera importance
    densities are real (perspective pinhole; cam[1].pdf_fwd from
    pdf_we_dir) AND the t=1 strategies are actually evaluated, so the
    weights partition unity either way.  rev_over/delta_over:
    {('c'|'l', idx): array} junction overrides."""
    def rev(side, i):
        if (side, i) in rev_over:
            return rev_over[(side, i)]
        vs = cam if side == "c" else lit
        return vs[i]["pdf_rev"]

    def delta(side, i):
        if (side, i) in delta_over:
            return delta_over[(side, i)]
        vs = cam if side == "c" else lit
        return vs[i]["delta"]

    N = cam[0]["p"].shape[0]
    sum_ri = jnp.zeros(N, jnp.float32)
    ri = 1.0
    t_lo = 0 if with_t1 else 1  # camera loop floor: i=1 is the t'=1 term
    for i in range(t - 1, t_lo, -1):
        ri = ri * _remap0(rev("c", i)) / _remap0(cam[i]["pdf_fwd"])
        nd = (~delta("c", i)) & (~delta("c", i - 1))
        sum_ri = sum_ri + jnp.where(nd, ri, 0.0)
    ri = 1.0
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(rev("l", i)) / _remap0(lit[i]["pdf_fwd"])
        prev_d = delta("l", i - 1) if i > 0 else lit0_delta_pos
        nd = (~delta("l", i)) & (~prev_d)
        sum_ri = sum_ri + jnp.where(nd, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


def trace_bdpt(scene, o0, d0, key, max_depth: int, cam=None, film_hw=None, u_ext=None, sel_st=None):
    """BDPT estimate for N camera rays; returns (L (N,3), aux).

    cam + film_hw (static (H, W)) enable the t=1 light-tracing
    strategies: aux["splat"] is a dense (H*W+1, 3) splat image for this
    pass (flat index H*W collects discarded splats), to be accumulated by
    the driver and added at resolve time with a 1/spp scale (ref:
    bdpt.cpp ConnectBDPT t==1 + film.cpp:160 AddSplat)."""
    from ..ops import camera as camlib

    N = o0.shape[0]
    with_t1 = cam is not None and film_hw is not None
    T = max_depth + 1          # camera surface vertices (t = index+2)
    S = max_depth              # light surface vertices beyond the root

    Ls = scene.light_kind.shape[0]
    live = jnp.arange(Ls) < scene.n_lights
    inf_sel_pdf = jnp.sum(jnp.where(
        (scene.light_kind == lightlib.LIGHT_INFINITE) & live,
        scene.light_pdf, 0.0))

    # ---- camera subpath (root = pinhole camera at o0) ----
    cam_root = _new_vertex(N)
    cam_root["valid"] = jnp.ones(N, bool)
    cam_root["p"] = o0
    pdf_dir_cam0 = (camlib.pdf_we_dir(cam, d0) if with_t1
                    else jnp.ones(N))
    def _sel(s_, t_):
        if sel_st is None:
            return jnp.ones(N, bool)
        return (sel_st[0] == s_) & (sel_st[1] == t_)

    # the escape (env) radiance is the s=0 term of its path length; when
    # a single strategy is selected it still flows through L below, so
    # selection masks it by construction only via the t-loop terms — the
    # env escape term corresponds to s=0 at EVERY t, masked separately
    cam_surf, L = _subpath(
        scene, o0, d0, jnp.ones((N, 3), jnp.float32), pdf_dir_cam0, key, T,
        stream=11, root_delta=jnp.zeros(N, bool),
        collect_env=True, inf_sel_pdf=inf_sel_pdf,
        u_vert=None if u_ext is None else u_ext["cam"],
        sel_esc=None if sel_st is None else (sel_st[0] == 0, sel_st[1]))
    cam_vs = [cam_root] + cam_surf  # cam_vs[i] = vertex i (0 = camera)

    # ---- light subpath (root sampled from finite lights) ----
    fin_pdf, fin_cdf = lightlib.finite_light_distribution(scene)
    if u_ext is not None:
        u_sel = u_ext["root"][:, 0]
        u_le = u_ext["root"][:, 1:7]
    else:
        k_sel = smplr.wave_key(key, 12, 0, smplr.DIM_LIGHT_SELECT)
        k_le = smplr.wave_key(key, 12, 0, smplr.DIM_LIGHT_SAMPLE)
        u_sel = smplr.uniform(k_sel, (N,))
        u_le = smplr.uniform(k_le, (N, 6))
    lid = jnp.clip(jnp.searchsorted(fin_cdf, u_sel), 0,
                   jnp.maximum(scene.n_lights - 1, 0)).astype(jnp.int32)
    sel_fin = jnp.take(fin_pdf, lid)
    sel_full = jnp.take(scene.light_pdf, lid)
    em = lightlib.sample_le(scene, lid, u_le)
    any_finite = jnp.any(fin_pdf > 0.0)
    em_ok = em.valid & (sel_fin > 0.0) & any_finite

    lit_root = _new_vertex(N)
    lit_root["valid"] = em_ok
    lit_root["p"] = em.o
    lit_root["ng"] = em.n_l
    lit_root["ns"] = em.n_l
    lit_root["beta"] = em.le
    lit_root["light"] = lid
    # origin density under the FULL light distribution (single measure
    # shared by every strategy's weight; see module docstring)
    lit_root["pdf_fwd"] = em.pdf_pos * sel_full
    # (ref: IsDeltaLight — position OR direction delta kills the s'=0 term)
    lit0_delta_pos = em.delta_pos | em.delta_dir

    beta1 = em.le * (vm.absdot(em.n_l, em.d) / jnp.maximum(
        sel_fin * em.pdf_pos * em.pdf_dir, 1e-20))[:, None]
    beta1 = jnp.where(em_ok[:, None], beta1, 0.0)
    o1 = vm.offset_ray_origin(em.o, em.n_l, em.d)
    lit_surf, _ = _subpath(scene, o1, em.d, beta1, em.pdf_dir, key, S,
                           stream=13, root_delta=em.delta_dir,
                           root=lit_root,
                           u_vert=None if u_ext is None else u_ext["lit"])
    # invalidate light vertices whose emission failed
    for v in lit_surf:
        v["valid"] = v["valid"] & em_ok
    lit = [lit_root] + lit_surf

    # ---- strategy connections (s >= 0, t >= 2) ----
    # per t-iteration: phase 1 collects geometry + enqueues every BSDF
    # eval and shadow ray; the batches run once; phase 2 assembles
    # contributions and MIS weights from the batched results.
    kx = smplr.wave_key(key, 14, 0, smplr.DIM_LIGHT_SAMPLE)

    for t in range(2, T + 2):
        if t - 1 > len(cam_vs) - 1:
            break
        pt = cam_vs[t - 1]
        pt_minus = cam_vs[t - 2]
        eb = _EvalBatch()
        sb = _ShadowBatch()
        # the reference bounds every strategy by the requested path depth
        # (bdpt.cpp render loop: depth = s + t - 2 <= maxDepth)
        do_s1 = (1 + t - 2) <= max_depth
        s_max = max_depth + 2 - t  # largest s with s + t - 2 <= maxDepth

        # ---------- phase 1: s = 1 geometry ----------
        if u_ext is not None:
            u_sel1 = u_ext["nee"][:, t - 2, 0]
            u_l1 = u_ext["nee"][:, t - 2, 1:4]
        else:
            k_s1 = jax.random.fold_in(kx, t)
            u_sel1 = smplr.uniform(jax.random.fold_in(k_s1, 0), (N,))
            u_l1 = smplr.uniform(jax.random.fold_in(k_s1, 1), (N, 3))
        lid1, sel1 = lightlib.choose_light(scene, u_sel1)
        ls = lightlib.sample_li(scene, lid1, pt["p"], u_l1)
        can1 = pt["valid"] & bsdflib.has_nonspecular(pt["params"]) & \
            (ls.pdf > 0.0) & (vm.luminance(ls.li) > 0.0) & \
            (scene.n_lights > 0)
        e_f_pt = eb.add(pt, pt["wo"], ls.wi)       # f + forward pdf at pt
        e_rev_pm = eb.add(pt, ls.wi, pt["wo"])     # pt scatters backwards
        ng_f1 = vm.face_forward(pt["ng"], pt["wo"])
        o_sh1 = vm.offset_ray_origin(pt["p"], ng_f1, ls.wi)
        # shadow length from the OFFSET origin (see path.py nee_once)
        sh1 = sb.add(o_sh1, ls.wi,
                     jnp.where(can1, (ls.dist - vm.dot(
                         o_sh1 - pt["p"], ls.wi)) * 0.999, -1.0))

        # ---------- phase 1: s >= 2 geometry ----------
        s_meta = []
        for s in range(2, min(S + 2, s_max + 1)):
            if s - 1 > len(lit) - 1:
                break
            qs = lit[s - 1]
            both = pt["valid"] & qs["valid"] & \
                bsdflib.has_nonspecular(pt["params"]) & \
                bsdflib.has_nonspecular(qs["params"])
            w_pq = pt["p"] - qs["p"]
            d2 = jnp.maximum(vm.length_sq(w_pq), 1e-20)
            dist = jnp.sqrt(d2)
            dir_qp = w_pq / dist[:, None]          # qs -> pt
            e_fq = eb.add(qs, qs["wo"], dir_qp)
            e_fp = eb.add(pt, pt["wo"], -dir_qp)
            e_rpm = eb.add(pt, -dir_qp, pt["wo"])
            e_rqm = eb.add(qs, dir_qp, qs["wo"])
            ng_q = vm.face_forward(qs["ng"], qs["wo"])
            o_sh2 = vm.offset_ray_origin(qs["p"], ng_q, dir_qp)
            # connection length from the OFFSET origin (see path.py)
            sh2 = sb.add(o_sh2, dir_qp,
                         jnp.where(both, (dist - vm.dot(
                             o_sh2 - qs["p"], dir_qp)) * 0.997, -1.0))
            s_meta.append(dict(s=s, qs=qs, both=both, d2=d2, dist=dist,
                               dir_qp=dir_qp, e=(e_fq, e_fp, e_rpm, e_rqm),
                               sh=sh2))

        eb.run()
        sb.run(scene)

        # ---------- phase 2: s = 0 (pt itself is emissive) ----------
        emissive = pt["valid"] & (pt["light"] >= 0)
        plid = jnp.maximum(pt["light"], 0)
        le = lightlib.area_light_le(scene, plid, pt["ng"], pt["wo"])
        C0 = pt["beta"] * le
        rev_over = {
            ("c", t - 1): lightlib.pdf_light_origin(scene, plid),
        }
        if t - 2 >= 1:
            dir_pm = vm.normalize(pt_minus["p"] - pt["p"])
            rev_over[("c", t - 2)] = _convert(
                lightlib.pdf_le_dir(scene, plid, pt["ns"], dir_pm),
                pt["p"], pt_minus["p"], pt_minus["ns"])
        delta_over = {("c", t - 1): jnp.zeros(N, bool)}
        w0 = _mis_weight(cam_vs, lit, 0, t, rev_over, delta_over,
                         lit0_delta_pos, with_t1=with_t1)
        L = L + jnp.where((emissive & _sel(0, t))[:, None],
                          C0 * w0[:, None], 0.0)

        # ---------- phase 2: s = 1 ----------
        if not do_s1:
            continue
        f_pt = eb.f(e_f_pt)
        bsdf_pdf_pt = jnp.where(pt["delta"], 0.0, eb.pdf(e_f_pt))
        cos_pt = vm.absdot(ls.wi, pt["ns"])
        vis1 = can1 & (~sb.occ(sh1))
        C1 = pt["beta"] * f_pt * ls.li * (cos_pt / jnp.maximum(
            ls.pdf * sel1, 1e-20))[:, None]

        is_inf1 = jnp.take(scene.light_kind, lid1) == lightlib.LIGHT_INFINITE
        # env paths: pairwise heuristic vs the escape strategy
        w_env = smp.power_heuristic(1.0, ls.pdf * sel1, 1.0, bsdf_pdf_pt)

        # finite lights: full vertex machinery with a resampled qs
        p_qs = pt["p"] + ls.wi * ls.dist[:, None]
        dir_qp1 = -ls.wi                          # qs -> pt
        rev_over = {
            # pt.pdfRev: light emits towards pt
            ("c", t - 1): _convert(
                lightlib.pdf_le_dir(scene, lid1, ls.n_l, dir_qp1),
                p_qs, pt["p"], pt["ns"]),
            # qs.pdfRev: pt samples towards qs
            ("l", 0): _convert(bsdf_pdf_pt, pt["p"], p_qs, ls.n_l),
        }
        if t - 2 >= 1:
            rev_sa_pm = jnp.where(pt["delta"], 0.0, eb.pdf(e_rev_pm))
            rev_over[("c", t - 2)] = _convert(
                rev_sa_pm, pt["p"], pt_minus["p"], pt_minus["ns"])
        qs1 = dict(_new_vertex(N),
                   pdf_fwd=lightlib.pdf_light_origin(scene, lid1),
                   delta=ls.is_delta)
        lit1 = [qs1] + lit[1:]
        delta_over = {("c", t - 1): jnp.zeros(N, bool),
                      ("l", 0): ls.is_delta}
        w1 = _mis_weight(cam_vs, lit1, 1, t, rev_over, delta_over,
                         ls.is_delta, with_t1=with_t1)
        w = jnp.where(is_inf1, w_env, w1)
        L = L + jnp.where((vis1 & _sel(1, t))[:, None],
                          C1 * w[:, None], 0.0)

        # ---------- phase 2: s >= 2 ----------
        for m in s_meta:
            s, qs = m["s"], m["qs"]
            qs_minus = lit[s - 2]
            e_fq, e_fp, e_rpm, e_rqm = m["e"]
            f_q, f_p = eb.f(e_fq), eb.f(e_fp)
            g = vm.absdot(qs["ns"], m["dir_qp"]) * \
                vm.absdot(pt["ns"], m["dir_qp"]) / m["d2"]
            cval = qs["beta"] * f_q * f_p * pt["beta"] * g[:, None]
            can2 = m["both"] & (vm.luminance(jnp.abs(cval)) > 0.0)
            vis2 = can2 & (~sb.occ(m["sh"]))

            pdf_q_fwd = jnp.where(qs["delta"], 0.0, eb.pdf(e_fq))
            pdf_p_fwd = jnp.where(pt["delta"], 0.0, eb.pdf(e_fp))
            rev_over = {
                ("c", t - 1): _convert(pdf_q_fwd, qs["p"], pt["p"],
                                       pt["ns"]),
                ("l", s - 1): _convert(pdf_p_fwd, pt["p"], qs["p"],
                                       qs["ns"]),
            }
            if t - 2 >= 1:
                rev_sa_pm = jnp.where(pt["delta"], 0.0, eb.pdf(e_rpm))
                rev_over[("c", t - 2)] = _convert(
                    rev_sa_pm, pt["p"], pt_minus["p"], pt_minus["ns"])
            # qs_minus.pdfRev: qs scatters back towards qs_minus
            rev_sa_qm = jnp.where(qs["delta"], 0.0, eb.pdf(e_rqm))
            rev_over[("l", s - 2)] = _convert(
                rev_sa_qm, qs["p"], qs_minus["p"], qs_minus["ns"])
            delta_over = {("c", t - 1): jnp.zeros(N, bool),
                          ("l", s - 1): jnp.zeros(N, bool)}
            w2 = _mis_weight(cam_vs, lit, s, t, rev_over, delta_over,
                             lit0_delta_pos, with_t1=with_t1)
            L = L + jnp.where((vis2 & _sel(s, t))[:, None],
                              cval * w2[:, None], 0.0)

    # ----- t = 1: light tracing, splatted to the film -----
    # (ref: bdpt.cpp ConnectBDPT t==1 — connect every light subpath
    # vertex to the camera; contributions land at the projected raster
    # position, not this wavefront's own pixel).  Evals + shadows batched
    # across the S strategies exactly like the t-loop above.
    aux = {}
    if with_t1:
        Hf, Wf = film_hw
        splat = jnp.zeros((Hf * Wf + 1, 3), jnp.float32)
        cam_p = camlib.camera_position(cam)
        eb = _EvalBatch()
        sb = _ShadowBatch()
        t1_meta = []
        for s_ in range(2, S + 2):
            if s_ - 1 > len(lit) - 1:
                break
            qs = lit[s_ - 1]
            sw = camlib.sample_wi(cam, qs["p"])
            can = qs["valid"] & bsdflib.has_nonspecular(qs["params"]) & \
                sw["valid"]
            e_fq = eb.add(qs, qs["wo"], sw["wi"])
            e_rqm = eb.add(qs, sw["wi"], qs["wo"])
            ng_q = vm.face_forward(qs["ng"], qs["wo"])
            o_sh = vm.offset_ray_origin(qs["p"], ng_q, sw["wi"])
            sh = sb.add(o_sh, sw["wi"],
                        jnp.where(can, (sw["dist"] - vm.dot(
                            o_sh - qs["p"], sw["wi"])) * 0.999, -1.0))
            t1_meta.append(dict(s=s_, qs=qs, sw=sw, can=can,
                                e=(e_fq, e_rqm), sh=sh))
        eb.run()
        sb.run(scene)
        for m in t1_meta:
            s_, qs, sw, can = m["s"], m["qs"], m["sw"], m["can"]
            qs_minus = lit[s_ - 2]
            e_fq, e_rqm = m["e"]
            cos_q = vm.absdot(sw["wi"], qs["ns"])
            Ct1 = qs["beta"] * eb.f(e_fq) * (sw["we_over_pdf"]
                                             * cos_q)[:, None]
            can = can & (vm.luminance(jnp.abs(Ct1)) > 0.0)
            vis = can & (~sb.occ(m["sh"]))

            # MIS: camera side is just the camera vertex; light side uses
            # the camera's direction density onto qs and qs's reverse
            # scatter onto qs_minus (ref: MISWeight ScopedAssignments)
            pdf_cam_dir = camlib.pdf_we_dir(cam, -sw["wi"])
            rev_over = {
                ("l", s_ - 1): _convert(pdf_cam_dir, cam_p[None, :],
                                        qs["p"], qs["ns"]),
            }
            rev_sa_qm = jnp.where(qs["delta"], 0.0, eb.pdf(e_rqm))
            rev_over[("l", s_ - 2)] = _convert(
                rev_sa_qm, qs["p"], qs_minus["p"], qs_minus["ns"])
            delta_over = {("l", s_ - 1): jnp.zeros(N, bool)}
            wt1 = _mis_weight(cam_vs, lit, s_, 1, rev_over, delta_over,
                              lit0_delta_pos, with_t1=True)
            val = jnp.where(vis[:, None], Ct1 * wt1[:, None], 0.0)
            val = jnp.where(jnp.isfinite(val), val, 0.0)
            px = jnp.clip(sw["raster"][:, 0].astype(jnp.int32), 0, Wf - 1)
            py = jnp.clip(sw["raster"][:, 1].astype(jnp.int32), 0, Hf - 1)
            flat = jnp.where(vis, py * Wf + px, Hf * Wf)
            splat = splat.at[flat].add(val)
        aux["splat"] = splat

    L = jnp.where(jnp.isfinite(L), L, 0.0)
    rays = jnp.int32(N * (2 * max_depth + 1))
    aux["rays"] = rays
    return L, aux
