"""Camera ray generation (perspective, orthographic, environment,
hemispheric) for ray wavefronts.

Semantics: perspective/ortho follow the reference's projective cameras
(ref: src/cameras/perspective.cpp:GenerateRay, orthographic.cpp; screen
window + raster mapping from src/core/camera.h ProjectiveCamera).  The
hemispheric probe camera reproduces the IILE mapping exactly
(ref: src/cameras/hemispheric.cpp:15-41: theta = pi*y/h over film rows,
phi = pi*x/w over columns, camera-space dir = (sin t cos p, cos t,
sin t sin p) so the hemisphere pole is the camera z / surface normal).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import transforms as xf
from ..utils import vecmath as vm
from . import sampling as smp

HIGHEST = jax.lax.Precision.HIGHEST  # no TF32 in geometry transforms


class Camera(NamedTuple):
    cam_to_world: jnp.ndarray    # (4,4)
    raster_to_camera: jnp.ndarray  # (4,4)
    lens_radius: jnp.ndarray     # ()
    focal_distance: jnp.ndarray  # ()
    resolution: jnp.ndarray      # (2,) i32 (x, y)
    # realistic lens system (E=0 for other camera kinds)
    # (ref: src/cameras/realistic.cpp LensElementInterface)
    lens_curv: jnp.ndarray = jnp.zeros(0)    # (E,) curvature radius (m)
    lens_thick: jnp.ndarray = jnp.zeros(0)   # (E,) vertex->next distance
    lens_eta: jnp.ndarray = jnp.zeros(0)     # (E,) index of refraction
    lens_ap: jnp.ndarray = jnp.zeros(0)      # (E,) aperture radius (m)
    film_half: jnp.ndarray = jnp.zeros(2)    # (2,) physical half extent
    # AnimatedTransform camera motion blur (ref: core/transform.h
    # AnimatedTransform; perspective.cpp ray.time = Lerp(sample.time,
    # shutterOpen, shutterClose)): start/end decompositions of
    # camera-to-world, interpolated per ray in generate_rays
    anim_t0: jnp.ndarray = jnp.zeros(3)      # translation @ t0
    anim_t1: jnp.ndarray = jnp.zeros(3)
    anim_q0: jnp.ndarray = jnp.zeros(4)      # rotation quat (w,x,y,z)
    anim_q1: jnp.ndarray = jnp.zeros(4)
    anim_s0: jnp.ndarray = jnp.eye(3)        # scale/shear residual
    anim_s1: jnp.ndarray = jnp.eye(3)
    shutter: jnp.ndarray = jnp.zeros(2)      # (open, close)
    anim_times: jnp.ndarray = jnp.asarray([0.0, 1.0])  # TransformTimes


KIND = {"perspective": 0, "orthographic": 1, "environment": 2,
        "realistic": 3}


def load_lens_file(path: str):
    """Parse a pbrt lens .dat table: rows of (curvature radius, thickness,
    eta, aperture diameter) in mm, front-to-rear (ref: realistic.cpp:35-49
    RealisticCamera ctor — values /1000 to meters, aperture /2 to radius).
    Lines starting with # are comments."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 4:
                rows.append(vals[:4])
    a = np.asarray(rows, np.float64)
    return (a[:, 0] * 1e-3, a[:, 1] * 1e-3, a[:, 2], a[:, 3] * 1e-3 / 2.0)


def _trace_lens_np(o, d, curv, thick, eta, ap_r, from_scene=False):
    """Host (numpy, single ray) lens trace in pbrt LENS space (film at
    z=0, elements at negative z, scene toward -inf), used for focusing
    (ref: realistic.cpp TraceLensesFromFilm/TraceLensesFromScene,
    IntersectSphericalElement)."""
    o = np.asarray(o, np.float64).copy()
    d = np.asarray(d, np.float64).copy()
    E = len(curv)
    # z of vertex of element i (lens space) = -sum(thick[i:])
    zv = -np.cumsum(thick[::-1])[::-1]
    order = range(E) if from_scene else range(E - 1, -1, -1)
    prev_eta = 1.0
    for i in order:
        z = zv[i]
        R = curv[i]
        if R == 0.0:
            if abs(d[2]) < 1e-15:
                return None
            t = (z - o[2]) / d[2]
        else:
            zc = z + R
            oc = o - np.array([0.0, 0.0, zc])
            A = d @ d
            B = 2 * (d @ oc)
            C = oc @ oc - R * R
            disc = B * B - 4 * A * C
            if disc < 0:
                return None
            sq = np.sqrt(disc)
            t0, t1 = (-B - sq) / (2 * A), (-B + sq) / (2 * A)
            use_closer = (d[2] > 0) != (R < 0)
            t = min(t0, t1) if use_closer else max(t0, t1)
        if t < 0:
            return None
        p = o + t * d
        if p[0] ** 2 + p[1] ** 2 > ap_r[i] ** 2:
            return None
        o = p
        if R != 0.0:
            n = (p - np.array([0.0, 0.0, z + R]))
            n = n / np.linalg.norm(n)
            if n @ d > 0:
                n = -n
            if from_scene:
                eta_i = prev_eta
                eta_t = eta[i] if eta[i] != 0 else 1.0
                prev_eta = eta_t
            else:
                eta_i = eta[i] if eta[i] != 0 else 1.0
                eta_t = 1.0 if i == 0 else (eta[i - 1]
                                            if eta[i - 1] != 0 else 1.0)
            r = eta_i / eta_t
            wi = -d / np.linalg.norm(d)
            cos_i = n @ wi
            sin2_t = r * r * max(0.0, 1.0 - cos_i * cos_i)
            if sin2_t >= 1.0:
                return None
            cos_t = np.sqrt(1.0 - sin2_t)
            d = r * (-wi) + (r * cos_i - cos_t) * n
    return o, d


def focus_lens(curv, thick, eta, ap_r, focus_distance: float):
    """Adjust the rear (film-side) thickness so a point at
    focus_distance images onto the film (ref: realistic.cpp
    FocusThickLens — here: iterative axial marginal-ray focusing)."""
    thick = np.asarray(thick, np.float64).copy()
    for _ in range(4):
        front_z = -float(np.sum(thick))     # lens space front vertex
        h = max(ap_r[0] * 0.05, 1e-5)
        src = np.array([h, 0.0, front_z - min(focus_distance, 1e5)])
        dvec = np.array([0.0, 0.0, 1.0])    # parallel... no: from point
        # aim from the axial focus point through the front vertex edge
        src = np.array([0.0, 0.0, front_z - min(focus_distance, 1e5)])
        aim = np.array([h, 0.0, front_z])
        dvec = aim - src
        dvec = dvec / np.linalg.norm(dvec)
        res = _trace_lens_np(src, dvec, curv, thick, eta, ap_r,
                             from_scene=True)
        if res is None:
            break
        o, d = res
        if abs(d[0]) < 1e-12:
            break
        t_cross = -o[0] / d[0]
        z_f = o[2] + t_cross * d[2]     # axis crossing (want z=0 = film)
        thick[-1] += z_f                # move lens away/toward the film
        if abs(z_f) < 1e-7:
            break
        thick[-1] = max(thick[-1], 1e-4)
    return thick


def realistic_generate_rays(cam: Camera, p_film: jnp.ndarray,
                            u_lens: jnp.ndarray):
    """Trace film->rear-element->scene through the spherical lens stack
    (ref: realistic.cpp GenerateRay + TraceLensesFromFilm).  Instead of
    the precomputed exit-pupil tables we sample the full rear aperture
    and zero out vignetted rays — unbiased, simpler, vector-friendly (the
    loop over elements is unrolled; everything stays vectorized).
    Returns (o_world, d_world, weight)."""
    N = p_film.shape[0]
    res = cam.resolution.astype(jnp.float32)
    E = cam.lens_curv.shape[0]
    # raster -> physical film point (film at z=0; x mirrored as in
    # realistic.cpp:634 Point3f pFilm(-pFilm2.x, pFilm2.y, 0))
    s = p_film / res[None, :]
    fx = -(2.0 * s[:, 0] - 1.0) * cam.film_half[0]
    fy = (2.0 * s[:, 1] - 1.0) * cam.film_half[1]
    # LENS space (as in realistic.cpp CameraToLens = Scale(1,1,-1)):
    # film at z=0, elements at negative z, scene toward -inf
    o = jnp.stack([fx, fy, jnp.zeros(N, fx.dtype)], axis=-1)
    rear_z = -cam.lens_thick[E - 1]
    rear_r = cam.lens_ap[E - 1]
    p_disk = rear_r * smp.concentric_sample_disk(u_lens)
    p_rear = jnp.concatenate(
        [p_disk, jnp.broadcast_to(rear_z, (N, 1)).astype(p_disk.dtype)],
        axis=-1)
    d = vm.normalize(p_rear - o)
    cos0 = jnp.abs(d[:, 2])
    ok = jnp.ones(N, bool)
    # vertex z of element i (lens space) = -sum(thick[i:])
    zv = -jnp.cumsum(cam.lens_thick[::-1])[::-1]
    for i in range(E - 1, -1, -1):
        z = zv[i]
        R = cam.lens_curv[i]
        is_stop = R == 0.0
        dz_safe = jnp.where(jnp.abs(d[:, 2]) < 1e-12, 1e-12, d[:, 2])
        t_plane = (z - o[:, 2]) / dz_safe
        zc = z + R
        oc = o - jnp.array([0.0, 0.0, 1.0]) * zc
        A = vm.dot(d, d)
        B = 2.0 * vm.dot(d, oc)
        C = vm.dot(oc, oc) - R * R
        disc = B * B - 4.0 * A * C
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = (-B - sq) / (2.0 * A)
        t1 = (-B + sq) / (2.0 * A)
        use_closer = (d[:, 2] > 0) != (R < 0)
        t_sph = jnp.where(use_closer, jnp.minimum(t0, t1),
                          jnp.maximum(t0, t1))
        sph_ok = (disc >= 0.0) & (t_sph > 0.0)
        t = jnp.where(is_stop, t_plane, t_sph)
        ok = ok & jnp.where(is_stop, t_plane > 0.0, sph_ok)
        p = o + t[:, None] * d
        ok = ok & (p[:, 0] ** 2 + p[:, 1] ** 2 <= cam.lens_ap[i] ** 2)
        # refract at curved interfaces (ref: core/reflection.h Refract;
        # eta pairing as in TraceLensesFromFilm: from element i's glass
        # into element i-1's, vacuum past the front)
        n = vm.normalize(p - jnp.array([0.0, 0.0, 1.0]) * zc)
        n = jnp.where((vm.dot(n, d) > 0.0)[:, None], -n, n)
        eta_i = jnp.where(cam.lens_eta[i] == 0.0, 1.0, cam.lens_eta[i])
        if i > 0:
            eta_t = jnp.where(cam.lens_eta[i - 1] == 0.0, 1.0,
                              cam.lens_eta[i - 1])
        else:
            eta_t = jnp.float32(1.0)
        r = eta_i / eta_t
        wi = -vm.normalize(d)
        cos_i = vm.dot(n, wi)
        sin2_t = r * r * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
        tir = sin2_t >= 1.0
        cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 0.0))
        d_ref = r * (-wi) + (r * cos_i - cos_t)[:, None] * n
        ok = ok & (is_stop | ~tir)
        o = p
        d = jnp.where(is_stop, d, d_ref)
    # cos^4 weighting (ref: realistic.cpp:649 simpleWeighting)
    w = jnp.where(ok, cos0 ** 4, 0.0)
    # back to camera space (z toward the scene), then to world
    flip = jnp.array([1.0, 1.0, -1.0])
    o_w = _apply44_point(cam.cam_to_world, o * flip)
    d_w = vm.normalize(_apply44_vector(cam.cam_to_world,
                                       vm.normalize(d * flip)))
    return o_w, d_w, w


def make_camera(desc, film) -> Camera:
    cam = _make_camera_static(desc, film)
    if getattr(desc, "cam_to_world_end", None) is not None:
        T0, q0, S0 = xf.decompose(desc.cam_to_world)
        T1, q1, S1 = xf.decompose(desc.cam_to_world_end)
        if float(np.dot(q0, q1)) < 0.0:
            q1 = -q1  # shortest arc (ref: quaternion.cpp Slerp neg-dot)
        t0, t1 = getattr(desc, "transform_times", (0.0, 1.0))
        cam = cam._replace(
            anim_t0=jnp.asarray(T0, jnp.float32),
            anim_t1=jnp.asarray(T1, jnp.float32),
            anim_q0=jnp.asarray(q0, jnp.float32),
            anim_q1=jnp.asarray(q1, jnp.float32),
            anim_s0=jnp.asarray(S0, jnp.float32),
            anim_s1=jnp.asarray(S1, jnp.float32),
            shutter=jnp.asarray([desc.shutter_open, desc.shutter_close],
                                jnp.float32),
            anim_times=jnp.asarray([t0, max(t1, t0 + 1e-9)], jnp.float32),
        )
    return cam


def _make_camera_static(desc, film) -> Camera:
    xres, yres = film.x_resolution, film.y_resolution
    aspect = xres / yres
    if desc.kind == "realistic" and getattr(desc, "lens_file", ""):
        curv, thick, eta, ap_r = load_lens_file(desc.lens_file)
        ap_d = getattr(desc, "aperture_diameter", 0.0)
        if ap_d > 0:
            # the stop row (curvature 0) is capped by aperturediameter
            # (ref: realistic.cpp:43-49, diameter given in mm)
            stop = curv == 0.0
            ap_r = np.where(stop, np.minimum(ap_r, ap_d * 1e-3 / 2), ap_r)
        if desc.focal_distance < 1e5:
            thick = focus_lens(curv, thick, eta, ap_r, desc.focal_distance)
        diag = getattr(film, "diagonal", 35.0) * 1e-3
        hx = 0.5 * np.sqrt(diag * diag / (1.0 + (yres / xres) ** 2))
        hy = hx * yres / xres
        return Camera(
            cam_to_world=jnp.asarray(desc.cam_to_world, jnp.float32),
            raster_to_camera=jnp.eye(4, dtype=jnp.float32),
            lens_radius=jnp.float32(ap_r[-1]),
            focal_distance=jnp.float32(desc.focal_distance),
            resolution=jnp.asarray([xres, yres], jnp.int32),
            lens_curv=jnp.asarray(curv, jnp.float32),
            lens_thick=jnp.asarray(thick, jnp.float32),
            lens_eta=jnp.asarray(eta, jnp.float32),
            lens_ap=jnp.asarray(ap_r, jnp.float32),
            film_half=jnp.asarray([hx, hy], jnp.float32),
        )
    if desc.screen_window is not None:
        x0, x1, y0, y1 = desc.screen_window
    elif aspect > 1.0:
        x0, x1, y0, y1 = -aspect, aspect, -1.0, 1.0
    else:
        x0, x1, y0, y1 = -1.0, 1.0, -1.0 / aspect, 1.0 / aspect
    # ScreenToRaster (ref: camera.h:216): note the y flip
    s2r = (
        xf.scale(xres, yres, 1.0)
        @ xf.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
        @ xf.translate(-x0, -y1, 0.0)
    )
    if desc.kind == "orthographic":
        c2s = np.eye(4)  # orthographic: z in [0,1] irrelevant for rays
    else:
        c2s = xf.perspective(desc.fov, 1e-2, 1000.0)
    r2c = xf.inverse(c2s) @ xf.inverse(s2r)
    return Camera(
        cam_to_world=jnp.asarray(desc.cam_to_world, jnp.float32),
        raster_to_camera=jnp.asarray(r2c, jnp.float32),
        lens_radius=jnp.float32(desc.lens_radius),
        focal_distance=jnp.float32(desc.focal_distance),
        resolution=jnp.asarray([xres, yres], jnp.int32),
    )


def _apply44_point(m, p):
    ph = jnp.dot(p, m[:3, :3].T, precision=HIGHEST) + m[:3, 3]
    w = jnp.dot(p, m[3, :3].T, precision=HIGHEST) + m[3, 3]
    return ph / w[..., None]


def _apply44_vector(m, v):
    return jnp.dot(v, m[:3, :3].T, precision=HIGHEST)


def generate_rays(cam: Camera, p_film: jnp.ndarray, u_lens=None,
                  kind: int = 0, u_time=None):
    """p_film: (N,2) raster-space sample positions (x, y).

    kind is STATIC (0 perspective, 1 ortho, 2 environment) — pass it from
    the scene description, not from the (traced) camera pytree.
    Returns (o, d) world-space rays. (ref: perspective.cpp:GenerateRay)
    """
    N = p_film.shape[0]
    p_cam = _apply44_point(
        cam.raster_to_camera,
        jnp.concatenate([p_film, jnp.zeros((N, 1), p_film.dtype)], axis=-1),
    )
    if kind == 1:  # orthographic
        o_cam = p_cam
        d_cam = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (N, 3))
    elif kind == 2:  # environment (equirect full sphere)
        res = cam.resolution.astype(jnp.float32)
        theta = jnp.pi * p_film[:, 1] / res[1]
        phi = 2.0 * jnp.pi * p_film[:, 0] / res[0]
        d_cam = jnp.stack(
            [jnp.sin(theta) * jnp.cos(phi), jnp.cos(theta),
             jnp.sin(theta) * jnp.sin(phi)], axis=-1)
        o_cam = jnp.zeros((N, 3))
    else:
        o_cam = jnp.zeros((N, 3))
        d_cam = vm.normalize(p_cam)

    if u_lens is not None:
        # thin lens depth of field (ref: perspective.cpp:244)
        p_lens = cam.lens_radius * smp.concentric_sample_disk(u_lens)
        ft = cam.focal_distance / jnp.maximum(d_cam[:, 2], 1e-6)
        p_focus = o_cam + ft[:, None] * d_cam
        o_lens = jnp.concatenate(
            [p_lens, jnp.zeros((N, 1), p_lens.dtype)], axis=-1)
        use = cam.lens_radius > 0.0
        o_cam = jnp.where(use, o_lens, o_cam)
        d_cam = jnp.where(use, vm.normalize(p_focus - o_lens), d_cam)

    if u_time is not None:
        # camera motion blur: per-ray shutter time -> interpolated
        # camera-to-world = T(t) R(t) S(t) (ref: transform.cpp
        # AnimatedTransform::Interpolate; time clamped to TransformTimes)
        time = cam.shutter[0] + u_time * (cam.shutter[1] - cam.shutter[0])
        dt = jnp.clip((time - cam.anim_times[0])
                      / (cam.anim_times[1] - cam.anim_times[0]), 0.0, 1.0)
        T = cam.anim_t0[None, :] \
            + dt[:, None] * (cam.anim_t1 - cam.anim_t0)[None, :]
        q = _quat_slerp(dt, cam.anim_q0, cam.anim_q1)       # (N,4)
        R = _quat_to_matrix(q)                              # (N,3,3)
        S = cam.anim_s0[None] \
            + dt[:, None, None] * (cam.anim_s1 - cam.anim_s0)[None]
        M = jnp.einsum("nij,njk->nik", R, S, precision=HIGHEST)              # (N,3,3)
        o = jnp.einsum("nij,nj->ni", M, o_cam, precision=HIGHEST) + T
        d = vm.normalize(jnp.einsum("nij,nj->ni", M, d_cam,
                                       precision=HIGHEST))
        return o, d
    o = _apply44_point(cam.cam_to_world, o_cam)
    d = vm.normalize(_apply44_vector(cam.cam_to_world, d_cam))
    return o, d


def _quat_slerp(t, q0, q1):
    """Vectorized slerp, t (N,), q0/q1 (4,) -> (N,4)
    (ref: quaternion.cpp Slerp)."""
    d = jnp.dot(q0, q1, precision=HIGHEST)
    theta = jnp.arccos(jnp.clip(d, -1.0, 1.0))
    small = jnp.abs(d) > 0.9995
    sin_th = jnp.sin(theta)
    w0 = jnp.where(small, 1.0 - t,
                   jnp.sin((1.0 - t) * theta) / jnp.maximum(sin_th, 1e-9))
    w1 = jnp.where(small, t,
                   jnp.sin(t * theta) / jnp.maximum(sin_th, 1e-9))
    q = w0[:, None] * q0[None, :] + w1[:, None] * q1[None, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def _quat_to_matrix(q):
    """(N,4) wxyz -> (N,3,3) rotation matrices."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                   2 * (x * z + y * w)], axis=-1),
        jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                   2 * (y * z - x * w)], axis=-1),
        jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                   1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)


def camera_position(cam: Camera):
    """(ref: camera.cpp getCameraWorldPosition — IILE addition)."""
    return cam.cam_to_world[:3, 3]


# ---------------------------------------------------------------------------
# Camera importance (perspective pinhole): light-tracing support
# ---------------------------------------------------------------------------

def _persp_film_area(cam: Camera):
    """Film area on the camera-space z=1 plane (the A in pbrt's
    perspective importance; ref: perspective.cpp ctor pMin/pMax via
    RasterToCamera)."""
    res = cam.resolution.astype(jnp.float32)
    corners = jnp.stack([jnp.array([0.0, 0.0, 0.0]),
                         jnp.stack([res[0], res[1], jnp.float32(0.0)])])
    pc = _apply44_point(cam.raster_to_camera, corners)
    pc = pc / pc[:, 2:3]
    return jnp.abs((pc[1, 0] - pc[0, 0]) * (pc[1, 1] - pc[0, 1]))


def camera_forward(cam: Camera):
    fwd = cam.cam_to_world[:3, 2]
    return fwd / jnp.maximum(jnp.linalg.norm(fwd), 1e-12)


def pdf_we_dir(cam: Camera, d_world):
    """Directional density of the perspective camera's ray sampling
    (ref: perspective.cpp Pdf_We: pdfDir = 1/(A cos^3 theta), zero
    outside the frustum — frustum check done via raster projection)."""
    A = _persp_film_area(cam)
    cos_t = jnp.einsum("nc,c->n", d_world, camera_forward(cam),
                       precision=HIGHEST)
    raster, on_film = project_to_raster(
        cam, camera_position(cam)[None, :] + d_world)
    ok = (cos_t > 1e-6) & on_film
    return jnp.where(ok, 1.0 / jnp.maximum(A * cos_t ** 3, 1e-12), 0.0)


def project_to_raster(cam: Camera, p_world):
    """World point -> raster coordinates + on-film mask (the pinhole
    WorldToRaster projection; ref: perspective.cpp Sample_Wi pRaster)."""
    w2c = jnp.linalg.inv(cam.cam_to_world)
    c2r = jnp.linalg.inv(cam.raster_to_camera)
    p_cam = _apply44_point(w2c, p_world)
    behind = p_cam[:, 2] <= 1e-6
    raster = _apply44_point(c2r, p_cam)[:, :2]
    res = cam.resolution.astype(jnp.float32)
    on = ((~behind) & (raster[:, 0] >= 0.0) & (raster[:, 0] < res[0])
          & (raster[:, 1] >= 0.0) & (raster[:, 1] < res[1]))
    return raster, on


def sample_wi(cam: Camera, p_ref):
    """Sample the direction from p_ref to the (pinhole) camera
    (ref: perspective.cpp PerspectiveCamera::Sample_Wi with
    lensRadius = 0: position is a delta; pdf = dist^2 / cos theta;
    importance We = 1/(A cos^4 theta)).

    Returns dict(wi (N,3), we_over_pdf (N,) = We/pdf =
    1/(A cos^3 theta dist^2), raster (N,2), valid (N,), dist (N,))."""
    cam_p = camera_position(cam)
    to_cam = cam_p[None, :] - p_ref
    dist = jnp.sqrt(jnp.maximum(jnp.sum(to_cam * to_cam, axis=-1), 1e-20))
    wi = to_cam / dist[:, None]
    cos_t = jnp.einsum("nc,c->n", -wi, camera_forward(cam),
                       precision=HIGHEST)
    raster, on_film = project_to_raster(cam, p_ref)
    A = _persp_film_area(cam)
    valid = (cos_t > 1e-6) & on_film
    we_over_pdf = jnp.where(
        valid, 1.0 / jnp.maximum(A * cos_t ** 3 * dist ** 2, 1e-20), 0.0)
    return dict(wi=wi, we_over_pdf=we_over_pdf, raster=raster,
                valid=valid, dist=dist)


# ---------------------------------------------------------------------------
# Hemispheric probe cameras (batched)
# ---------------------------------------------------------------------------

def hemi_frames(pos: jnp.ndarray, normal: jnp.ndarray):
    """LookAt frames for P probes (ref: hemispheric.cpp:108-158).

    Up = (0,0,1) unless the normal is the z axis, then (0,1,0).
    Returns (right, up, look) each (P,3): camera x, y, z axes in world.
    """
    d = vm.normalize(normal)
    pole = (jnp.abs(d[..., 0]) < 1e-9) & (jnp.abs(d[..., 1]) < 1e-9)
    up = jnp.where(
        pole[..., None],
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), d.shape),
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), d.shape),
    )
    # pbrt LookAt: right = normalize(cross(normalize(up), dir))
    right = vm.normalize(jnp.cross(up, d))
    new_up = jnp.cross(d, right)
    return right, new_up, d


def hemi_directions(hemi_size: int, dtype=jnp.float32):
    """Camera-space direction for each probe pixel center, (H,W,3), plus
    sin(theta) weights (H,W).  theta over rows, phi over cols
    (ref: hemispheric.cpp:15-41; pixel centers at +0.5)."""
    ys = (jnp.arange(hemi_size, dtype=dtype) + 0.5) / hemi_size
    xs = (jnp.arange(hemi_size, dtype=dtype) + 0.5) / hemi_size
    theta = jnp.pi * ys[:, None]    # (H,1)
    phi = jnp.pi * xs[None, :]      # (1,W)
    sin_t = jnp.sin(theta)
    d = jnp.stack(
        [
            jnp.broadcast_to(sin_t * jnp.cos(phi), (hemi_size, hemi_size)),
            jnp.broadcast_to(jnp.cos(theta) * jnp.ones_like(phi),
                             (hemi_size, hemi_size)),
            jnp.broadcast_to(sin_t * jnp.sin(phi), (hemi_size, hemi_size)),
        ],
        axis=-1,
    )
    return d, jnp.broadcast_to(sin_t, (hemi_size, hemi_size))


def hemi_generate_rays(pos, normal, hemi_size: int, jitter=None):
    """Batched probe ray-gen: pos, normal (P,3) -> o, d (P,H,W,3).

    jitter: optional (P,H,W,2) in [0,1) for sub-pixel jitter.
    """
    P = pos.shape[0]
    right, up, look = hemi_frames(pos, normal)
    if jitter is None:
        d_cam, _ = hemi_directions(hemi_size, pos.dtype)
        d_cam = jnp.broadcast_to(d_cam[None], (P, hemi_size, hemi_size, 3))
    else:
        ys = (jnp.arange(hemi_size, dtype=pos.dtype)[None, :, None]
              + jitter[..., 1]) / hemi_size
        xs = (jnp.arange(hemi_size, dtype=pos.dtype)[None, None, :]
              + jitter[..., 0]) / hemi_size
        theta = jnp.pi * ys
        phi = jnp.pi * xs
        sin_t = jnp.sin(theta)
        d_cam = jnp.stack(
            [sin_t * jnp.cos(phi), jnp.cos(theta), sin_t * jnp.sin(phi)],
            axis=-1)
    d = (
        d_cam[..., 0:1] * right[:, None, None, :]
        + d_cam[..., 1:2] * up[:, None, None, :]
        + d_cam[..., 2:3] * look[:, None, None, :]
    )
    o = jnp.broadcast_to(pos[:, None, None, :], d.shape)
    return o, d


def hemi_dir_to_pixel(wi_world, right, up, look, hemi_size: int):
    """Inverse mapping: world direction -> probe pixel (x, y) + in-range
    mask (ref: hemispheric.cpp getLightSampleNn: theta = acos(y_cam),
    phi = atan2(z_cam, x_cam))."""
    x_c = vm.dot(wi_world, right)
    y_c = vm.dot(wi_world, up)
    z_c = vm.dot(wi_world, look)
    theta = jnp.arccos(jnp.clip(y_c, -1.0, 1.0))
    phi = jnp.arctan2(z_c, x_c)
    fx = hemi_size * phi / jnp.pi
    fy = hemi_size * theta / jnp.pi
    x = jnp.floor(fx).astype(jnp.int32)
    y = jnp.floor(fy).astype(jnp.int32)
    ok = (x >= 0) & (x < hemi_size) & (y >= 0) & (y < hemi_size)
    return x, y, ok
