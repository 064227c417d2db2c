"""FourierBSDF: pbrt .bsdf table loader + evaluation + lobe projection.

The reference evaluates measured/layered BSDFs stored as Fourier series
in the azimuth-difference angle over a (mu_i, mu_o) grid
(ref: src/core/reflection.cpp FourierBSDFTable::Read + FourierBSDF::f,
src/core/interpolation.cpp Fourier/CatmullRomWeights,
src/materials/fourier.cpp).

Design: the table is loaded and evaluated EXACTLY on the host
(numpy) — used for tests and for fitting — while the render hot path
projects the table onto the wavefront lobe system (diffuse albedo +
Trowbridge-Reitz glossy lobe) at scene-build time via least squares.
The projection avoids per-ray variable-length coefficient gathers inside
the traced BSDF kernel (ragged gathers defeat XLA tiling); layered-table
renders remain plausible and energy-calibrated, and the fit residual is
reported so scenes that need the exact table can flag it.
"""

from __future__ import annotations

import struct

import numpy as np


class FourierTable:
    """In-memory .bsdf table (ref: reflection.h FourierBSDFTable)."""

    def __init__(self):
        self.eta = 1.0
        self.m_max = 0
        self.n_channels = 1
        self.mu = np.zeros(0)          # (nMu,)
        self.cdf = np.zeros((0, 0))    # (nMu, nMu)
        self.m = np.zeros((0, 0), np.int32)        # orders per pair
        self.a_offset = np.zeros((0, 0), np.int64)  # offsets into a
        self.a = np.zeros(0)           # coefficient pool


_HEADER = b"SCATFUN\x01"


def read_bsdf(path: str) -> FourierTable:
    """Parse the binary .bsdf layout (ref: reflection.cpp
    FourierBSDFTable::Read: 8-byte magic, 9 int32 header words, float
    eta, 4 reserved int32, then mu / cdf / offset+length / coefficient
    arrays)."""
    with open(path, "rb") as f:
        if f.read(8) != _HEADER:
            raise ValueError(f"{path}: not a SCATFUN v1 .bsdf file")
        flags, n_mu, n_coeffs, m_max, n_channels, n_bases = struct.unpack(
            "<6i", f.read(24))
        f.read(12)                       # reserved
        (eta,) = struct.unpack("<f", f.read(4))
        f.read(16)                       # reserved
        if flags != 1 or n_bases != 1 or n_channels not in (1, 3):
            raise ValueError(f"{path}: unsupported .bsdf variant "
                             f"(flags={flags} bases={n_bases} "
                             f"channels={n_channels})")
        t = FourierTable()
        t.eta = float(eta)
        t.m_max = m_max
        t.n_channels = n_channels
        t.mu = np.frombuffer(f.read(4 * n_mu), "<f4").astype(np.float64)
        t.cdf = np.frombuffer(f.read(4 * n_mu * n_mu),
                              "<f4").reshape(n_mu, n_mu).astype(np.float64)
        ol = np.frombuffer(f.read(8 * n_mu * n_mu),
                           "<i4").reshape(n_mu, n_mu, 2)
        t.a_offset = ol[..., 0].astype(np.int64)
        t.m = ol[..., 1].astype(np.int32)
        t.a = np.frombuffer(f.read(4 * n_coeffs), "<f4").astype(np.float64)
    return t


def write_bsdf(path: str, table: FourierTable):
    """Inverse of read_bsdf (test fixture generator)."""
    n_mu = len(table.mu)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(struct.pack("<6i", 1, n_mu, len(table.a), table.m_max,
                            table.n_channels, 1))
        f.write(b"\0" * 12)
        f.write(struct.pack("<f", table.eta))
        f.write(b"\0" * 16)
        f.write(table.mu.astype("<f4").tobytes())
        f.write(table.cdf.astype("<f4").tobytes())
        ol = np.stack([table.a_offset, table.m], axis=-1).astype("<i4")
        f.write(ol.tobytes())
        f.write(table.a.astype("<f4").tobytes())


def _catmull_rom_weights(nodes: np.ndarray, x: float):
    """4-point Catmull-Rom interpolation weights (ref:
    interpolation.cpp CatmullRomWeights)."""
    n = len(nodes)
    if not (x >= nodes[0] and x <= nodes[-1]):
        return None
    i = int(np.searchsorted(nodes, x, side="right") - 1)
    i = min(max(i, 0), n - 2)
    x0, x1 = nodes[i], nodes[i + 1]
    t = (x - x0) / (x1 - x0) if x1 > x0 else 0.0
    t2, t3 = t * t, t * t * t
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if i > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[i - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if i + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[i + 2] - x0)
        w[3] = w3
        w[1] -= w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
    return i - 1, w


def evaluate(table: FourierTable, mu_i: float, mu_o: float,
             cos_phi: float) -> np.ndarray:
    """Exact table evaluation -> RGB (ref: reflection.cpp
    FourierBSDF::f).  mu_i is measured on the incident side as pbrt does
    (muI = CosTheta(-wi)); the returned value includes the 1/|mu_i|
    factor."""
    r_i = _catmull_rom_weights(table.mu, mu_i)
    r_o = _catmull_rom_weights(table.mu, mu_o)
    if r_i is None or r_o is None:
        return np.zeros(3)
    oi, wi = r_i
    oo, wo = r_o
    m_max = 0
    ak = np.zeros((table.n_channels, table.m_max))
    n_mu = len(table.mu)
    for a in range(4):
        ia = oi + a
        if not (0 <= ia < n_mu) or wi[a] == 0.0:
            continue
        for b in range(4):
            ib = oo + b
            if not (0 <= ib < n_mu) or wo[b] == 0.0:
                continue
            w = wi[a] * wo[b]
            m = int(table.m[ia, ib])
            off = int(table.a_offset[ia, ib])
            if m == 0:
                continue
            m_max = max(m_max, m)
            for c in range(table.n_channels):
                ak[c, :m] += w * table.a[off + c * m: off + c * m + m]
    if m_max == 0:
        return np.zeros(3)
    # cosine series (ref: interpolation.cpp Fourier — double-angle
    # recurrence for cos(k*phi))
    cos_k_minus = cos_phi
    cos_k = 1.0
    vals = np.zeros(table.n_channels)
    for k in range(m_max):
        vals += ak[:, k] * cos_k
        cos_k, cos_k_minus = 2 * cos_phi * cos_k - cos_k_minus, cos_k
    scale = 1.0 / abs(mu_i) if mu_i != 0 else 0.0
    # refraction radiance scaling (reflection.cpp FourierBSDF::f:
    # transport==radiance and transmission -> 1/eta^2)
    if mu_i * mu_o > 0:
        eta = 1.0 / table.eta if mu_i > 0 else table.eta
        scale *= eta * eta
    y = max(0.0, vals[0] * scale)
    if table.n_channels == 1:
        return np.array([y, y, y])
    r = vals[1] * scale
    b = vals[2] * scale
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    return np.maximum(np.array([r, g, b]), 0.0)


def make_lambertian_table(albedo=0.5, n_mu: int = 16) -> FourierTable:
    """Analytic Lambertian reflection table: f = albedo/pi, i.e. the
    order-0 coefficient a0(mu_i, mu_o) = albedo/pi * |mu_i| (the table
    stores f * |mu_i|).  Test fixture."""
    t = FourierTable()
    t.eta = 1.0
    t.m_max = 1
    t.n_channels = 1
    # pbrt tables span mu in [-1,1] (muI = CosTheta(-wi) is negative for
    # reflection); constant-albedo in both hemispheres for simplicity
    t.mu = np.linspace(-1.0, 1.0, n_mu)
    t.m = np.ones((n_mu, n_mu), np.int32)
    t.a_offset = np.arange(n_mu * n_mu, dtype=np.int64).reshape(n_mu, n_mu)
    a = np.zeros(n_mu * n_mu)
    for i in range(n_mu):
        for o in range(n_mu):
            a[i * n_mu + o] = albedo / np.pi * abs(t.mu[i])
    t.a = a
    t.cdf = np.zeros((n_mu, n_mu))
    return t


def fit_lobes(table: FourierTable, n_dirs: int = 24):
    """Project the table onto (diffuse rgb, glossy rgb, alpha, eta) for
    the wavefront lobe system.  Least squares over a cosine-weighted
    direction grid; returns (kd, ks, roughness_alpha, eta, residual)."""
    rng = np.random.default_rng(7)
    mu = np.sqrt(rng.uniform(0.02, 1.0, n_dirs))       # cos theta
    phi = rng.uniform(0.0, np.pi, n_dirs)
    rows = []
    targets = []
    alphas = [0.01, 0.05, 0.1, 0.2, 0.4]

    def tr_d(cos_h, alpha):
        c2 = cos_h * cos_h
        den = c2 * (alpha * alpha - 1.0) + 1.0
        return alpha * alpha / np.maximum(np.pi * den * den, 1e-9)

    feats = {a: [] for a in alphas}
    for ii in range(n_dirs):
        for oo in range(n_dirs):
            mi, mo = mu[ii], mu[oo]
            cp = np.cos(phi[ii] - phi[oo])
            val = evaluate(table, -mi, mo, cp)   # reflection: opposite signs
            if not np.isfinite(val).all():
                continue
            targets.append(val)
            rows.append(1.0 / np.pi)
            # half-vector cos for each candidate alpha
            si, so = np.sqrt(1 - mi * mi), np.sqrt(1 - mo * mo)
            wi = np.array([si * np.cos(phi[ii]), si * np.sin(phi[ii]), mi])
            wo = np.array([so * np.cos(phi[oo]), so * np.sin(phi[oo]), mo])
            h = wi + wo
            nh = np.linalg.norm(h)
            ch = h[2] / nh if nh > 0 else 1.0
            for a in alphas:
                feats[a].append(tr_d(ch, a) / max(4.0 * mi * mo, 1e-3))
    T = np.asarray(targets)                      # (S,3)
    diff = np.asarray(rows)                      # (S,)
    best = None
    for a in alphas:
        A = np.stack([diff, np.asarray(feats[a])], axis=-1)   # (S,2)
        coef, *_ = np.linalg.lstsq(A, T, rcond=None)
        coef = np.clip(coef, 0.0, None)
        resid = float(np.mean((A @ coef - T) ** 2))
        if best is None or resid < best[-1]:
            best = (coef[0], coef[1], a, resid)
    kd, ks, alpha, resid = best
    # the diffuse feature is 1/pi, so the coefficient IS the albedo
    return (np.clip(kd, 0.0, 1.0), np.clip(ks, 0.0, None), alpha,
            table.eta, resid)


# ---------------------------------------------------------------------------
# In-graph exact evaluation (device path)
#
# The variable-length per-(muI,muO) coefficient lists are densified at
# scene build into a (T, nMu, nMu, m_cap, 3) array (orders above m_cap
# truncated — high-frequency azimuthal detail only; a0, i.e. the energy,
# is always exact).  evaluate_device() then mirrors FourierBSDF::f
# (ref: reflection.cpp) with vectorized Catmull-Rom weights and a
# Chebyshev cosine series, fully jittable over the wavefront.
# ---------------------------------------------------------------------------

from typing import NamedTuple


class FourierDev(NamedTuple):
    """Device-resident dense fourier tables (all tables of the scene)."""
    mu: object        # (T, P) f32, padded by repeating the last node
    n_mu: object      # (T,) i32 valid node counts
    a: object         # (T, P, P, m_cap, 3) f32 dense coefficients (Y,R,B)
    eta: object       # (T,) f32


def densify(tables, m_cap: int = 128) -> FourierDev:
    """Pack host FourierTables into one dense device structure."""
    import jax.numpy as jnp

    P = max(len(t.mu) for t in tables)
    cap = min(max(t.m_max for t in tables), m_cap)
    cap = max(cap, 1)
    T = len(tables)
    mu = np.zeros((T, P), np.float32)
    n_mu = np.zeros(T, np.int32)
    a = np.zeros((T, P, P, cap, 3), np.float32)
    eta = np.ones(T, np.float32)
    for ti, t in enumerate(tables):
        n = len(t.mu)
        mu[ti, :n] = t.mu
        mu[ti, n:] = t.mu[-1]
        n_mu[ti] = n
        eta[ti] = t.eta
        for i in range(n):
            for j in range(n):
                m = int(t.m[i, j])
                if m == 0:
                    continue
                mm = min(m, cap)
                off = int(t.a_offset[i, j])
                if t.n_channels == 1:
                    y = t.a[off:off + mm]
                    a[ti, i, j, :mm, 0] = y
                    a[ti, i, j, :mm, 1] = y
                    a[ti, i, j, :mm, 2] = y
                else:
                    for c in range(3):
                        a[ti, i, j, :mm, c] = t.a[off + c * m:
                                                  off + c * m + mm]
    return FourierDev(mu=jnp.asarray(mu), n_mu=jnp.asarray(n_mu),
                      a=jnp.asarray(a), eta=jnp.asarray(eta))


def _crw_device(mu, n_mu, x):
    """Vectorized Catmull-Rom weights over per-ray node arrays
    (ref: interpolation.cpp CatmullRomWeights; host twin
    _catmull_rom_weights above).  mu (N,P), n_mu (N,), x (N,) ->
    (offset (N,), weights (N,4), valid (N,))."""
    import jax.numpy as jnp

    N, P = mu.shape
    cols = jnp.arange(P)[None, :]
    in_range = cols < n_mu[:, None]
    last = jnp.take_along_axis(mu, (n_mu - 1)[:, None], axis=1)[:, 0]
    valid = (x >= mu[:, 0]) & (x <= last)
    idx = jnp.sum(((mu <= x[:, None]) & in_range).astype(jnp.int32),
                  axis=1) - 1
    i = jnp.clip(idx, 0, n_mu - 2)

    def node(k):
        return jnp.take_along_axis(mu, jnp.clip(k, 0, P - 1)[:, None],
                                   axis=1)[:, 0]

    x0, x1 = node(i), node(i + 1)
    xm, xp = node(i - 1), node(i + 2)
    t = jnp.where(x1 > x0, (x - x0) / jnp.where(x1 > x0, x1 - x0, 1.0), 0.0)
    t2, t3 = t * t, t * t * t
    w0 = jnp.zeros_like(t)
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    w3 = jnp.zeros_like(t)
    has_prev = i > 0
    wp = (t3 - 2 * t2 + t) * jnp.where(has_prev, (x1 - x0)
                                       / jnp.maximum(x1 - xm, 1e-12), 1.0)
    w0 = jnp.where(has_prev, -wp, w0)
    w2 = w2 + wp                       # both branches (host twin above)
    w1 = jnp.where(has_prev, w1, w1 - wp)
    has_next = (i + 2) < n_mu
    wn = (t3 - t2) * jnp.where(has_next, (x1 - x0)
                               / jnp.maximum(xp - x0, 1e-12), 1.0)
    w3 = jnp.where(has_next, wn, w3)
    w1 = w1 - wn
    w2 = jnp.where(has_next, w2, w2 + wn)
    w = jnp.stack([w0, w1, w2, w3], axis=-1)
    return i - 1, jnp.where(valid[:, None], w, 0.0), valid


def evaluate_device(ftab: FourierDev, fid, wo, wi):
    """Exact FourierBSDF::f for the wavefront (ref: reflection.cpp
    FourierBSDF::f).  fid (N,) table ids (clamped; callers mask by
    material kind); wo/wi (N,3) in the shading frame.  Returns f (N,3)
    including the 1/|muI| and radiance-transport eta^2 factors."""
    import jax.numpy as jnp

    fid = jnp.clip(fid, 0, ftab.mu.shape[0] - 1)
    mu_i = -wi[..., 2]          # CosTheta(-wi)
    mu_o = wo[..., 2]
    # CosDPhi(-wi, wo) on the xy projections
    ax, ay = -wi[..., 0], -wi[..., 1]
    bx, by = wo[..., 0], wo[..., 1]
    den = jnp.sqrt(jnp.maximum((ax * ax + ay * ay) * (bx * bx + by * by),
                               1e-20))
    cos_phi = jnp.clip((ax * bx + ay * by) / den, -1.0, 1.0)

    mu_r = jnp.take(ftab.mu, fid, axis=0)         # (N,P)
    n_r = jnp.take(ftab.n_mu, fid, axis=0)        # (N,)
    oi, w_i, ok_i = _crw_device(mu_r, n_r, mu_i)
    oo, w_o, ok_o = _crw_device(mu_r, n_r, mu_o)

    m_cap = ftab.a.shape[3]
    ak = jnp.zeros(wo.shape[:-1] + (m_cap, 3), jnp.float32)
    P = ftab.mu.shape[1]
    for a_ in range(4):
        ia = oi + a_
        va = (ia >= 0) & (ia < n_r)
        for b_ in range(4):
            ib = oo + b_
            vb = (ib >= 0) & (ib < n_r)
            w = w_i[..., a_] * w_o[..., b_]
            use = va & vb & (w != 0.0)
            coef = ftab.a[fid, jnp.clip(ia, 0, P - 1),
                          jnp.clip(ib, 0, P - 1)]     # (N, m_cap, 3)
            ak = ak + jnp.where(use[..., None, None], w[..., None, None]
                                * coef, 0.0)

    # cosine series: cos(k*phi) = T_k(cos_phi) via arccos (exact)
    phi = jnp.arccos(cos_phi)
    k = jnp.arange(m_cap, dtype=jnp.float32)
    cos_k = jnp.cos(k[None, :] * phi[..., None])      # (N, m_cap)
    vals = jnp.sum(ak * cos_k[..., None], axis=-2)    # (N,3) Y,R,B

    scale = jnp.where(jnp.abs(mu_i) > 1e-9, 1.0 / jnp.maximum(
        jnp.abs(mu_i), 1e-9), 0.0)
    eta_t = jnp.take(ftab.eta, fid, axis=0)
    # radiance transport: transmission (muI*muO > 0 in pbrt's signs)
    eta_s = jnp.where(mu_i > 0, 1.0 / eta_t, eta_t)
    scale = scale * jnp.where(mu_i * mu_o > 0, eta_s * eta_s, 1.0)

    y = jnp.maximum(vals[..., 0] * scale, 0.0)
    r = vals[..., 1] * scale
    b = vals[..., 2] * scale
    g = 1.39829 * y - 0.100913 * b - 0.297375 * r
    f = jnp.stack([r, g, b], axis=-1)
    f = jnp.where((ok_i & ok_o)[..., None], jnp.maximum(f, 0.0), 0.0)
    return f
