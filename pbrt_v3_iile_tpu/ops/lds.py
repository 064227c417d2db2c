"""Low-discrepancy sequences, computed on device (no tables).

Replaces the reference's table-driven samplers (ref:
src/core/lowdiscrepancy.{h,cpp} + sobolmatrices.cpp [32 kLoC of tables],
samplers/halton.cpp, sobol.cpp, zerotwosequence.cpp): on the device the
radical inverses and base-2 Sobol points are cheaper to recompute with
bit math than to gather from tables.

- halton(i, dim): radical inverse in the dim-th prime base with
  per-dimension Cranley-Patterson-free digit scrambling.
- sobol02(i, scramble): the (0,2)-sequence (van der Corput + Sobol')
  used by zerotwosequence/sobol for 2D decisions.
- owen-style scrambling via hash, matching the decorrelation role of the
  reference's random digit scrambling (lowdiscrepancy.h:ComputeRadical
  InversePermutations).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53)


def radical_inverse(base: int, i: jnp.ndarray) -> jnp.ndarray:
    """Radical inverse of i (uint32) in the given base (static)."""
    i = i.astype(jnp.uint32)
    inv_base = 1.0 / base
    # max digits for 32-bit index
    ndig = 1
    cap = base
    while cap < (1 << 32):
        cap *= base
        ndig += 1

    def body(k, carry):
        val, rem, scale = carry
        digit = rem % base
        return (val + digit.astype(jnp.float32) * scale,
                rem // base, scale * inv_base)

    val, _, _ = jax.lax.fori_loop(
        0, ndig, body,
        (jnp.zeros(i.shape, jnp.float32), i,
         jnp.full(i.shape, inv_base, jnp.float32)))
    return jnp.minimum(val, 1.0 - 1e-7)


def halton(i: jnp.ndarray, dim: int) -> jnp.ndarray:
    """dim-th Halton dimension of sample index i."""
    return radical_inverse(PRIMES[dim % len(PRIMES)], i)


def _reverse_bits32(v):
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return (v >> 16) | (v << 16)


def sobol02_bits(i: jnp.ndarray):
    """(0,2)-sequence point i as u32 bit patterns (x = van der Corput
    bit reversal; y = Sobol' second dimension via the direction-number
    recurrence)."""
    i = i.astype(jnp.uint32)
    x = _reverse_bits32(i)

    def body(b, carry):
        v, rem, y = carry
        bit = rem & jnp.uint32(1)
        y = jnp.where(bit == 1, y ^ v, y)
        # next direction number: v ^= v >> 1 pattern for dim 2
        v = v ^ (v >> 1)
        return (v, rem >> 1, y)

    v0 = jnp.full(i.shape, 1 << 31, jnp.uint32)
    _, _, y = jax.lax.fori_loop(
        0, 32, body, (v0, i, jnp.zeros(i.shape, jnp.uint32)))
    return x, y


def sobol02(i: jnp.ndarray, scramble_x: jnp.ndarray = None,
            scramble_y: jnp.ndarray = None):
    """(0,2)-sequence point i (ref: lowdiscrepancy.h Sobol2D semantics).
    Returns (x, y) in [0,1)."""
    x, y = sobol02_bits(i)
    if scramble_x is not None:
        x = x ^ scramble_x.astype(jnp.uint32)
    if scramble_y is not None:
        y = y ^ scramble_y.astype(jnp.uint32)
    scale = jnp.float32(1.0 / (1 << 32))
    return (x.astype(jnp.float32) * scale, y.astype(jnp.float32) * scale)


def hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Integer mix (Wang hash) for per-pixel scrambles."""
    x = x.astype(jnp.uint32)
    x = (x ^ jnp.uint32(61)) ^ (x >> 16)
    x = x * jnp.uint32(9)
    x = x ^ (x >> 4)
    x = x * jnp.uint32(0x27D4EB2D)
    return x ^ (x >> 15)


def _laine_karras_permutation(x, seed):
    """Hash-based nested-uniform (Owen) permutation in the reversed-bit
    domain (Laine & Karras 2011 hash as refined by Burley 2020,
    'Practical Hash-based Owen Scrambling' — public-domain constants)."""
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def owen_scramble_u32(x, seed):
    """Owen-scramble a radical-inverse u32 (bit k permuted by a hash of
    bits above k).  Statistically equivalent to tree-based Owen
    scrambling; replaces the reference's random digit scrambles
    (ref: lowdiscrepancy.h:59-229 SobolSampleBits + scramble) with a
    variance-reducing scramble that keeps the (0,2)-net structure."""
    x = _reverse_bits32(x.astype(jnp.uint32))
    x = _laine_karras_permutation(x, seed.astype(jnp.uint32))
    return _reverse_bits32(x)


def sobol02_owen(i, seed_x, seed_y):
    """Owen-scrambled (0,2)-sequence point i.  seed_x/seed_y: per-element
    u32 scramble seeds (decorrelate pixels/dimension-pairs)."""
    xu, yu = sobol02_bits(i)
    xu = owen_scramble_u32(xu, seed_x)
    yu = owen_scramble_u32(yu, seed_y)
    scale = jnp.float32(1.0 / (1 << 32))
    return (jnp.minimum(xu.astype(jnp.float32) * scale, 1.0 - 1e-7),
            jnp.minimum(yu.astype(jnp.float32) * scale, 1.0 - 1e-7))


def scrambled_vdc(i, seed):
    """Owen-scrambled van der Corput 1D sequence (for 1D decisions:
    light select, lobe choice, russian roulette)."""
    v = _reverse_bits32(i.astype(jnp.uint32))
    v = owen_scramble_u32(v, seed)
    return jnp.minimum(v.astype(jnp.float32) * jnp.float32(1.0 / (1 << 32)),
                       1.0 - 1e-7)


# ---------------------------------------------------------------------------
# High-dimension scrambled Halton (ref: lowdiscrepancy.h
# ComputeRadicalInversePermutations + ScrambledRadicalInverse; the
# reference tables 1000 prime bases — here the first N_HALTON_DIMS are
# generated, covering ~21 bounces of 6 dims, and the per-base digit
# permutations are seeded-random like the reference's shuffle)
# ---------------------------------------------------------------------------

N_HALTON_DIMS = 128


def _first_primes(n):
    out = []
    c = 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return out


PRIMES_FULL = tuple(_first_primes(N_HALTON_DIMS))

_PERM_CACHE = {}


def _digit_perms(seed: int = 0):
    """Per-base random digit permutations (host, seeded — the
    ComputeRadicalInversePermutations role)."""
    if seed not in _PERM_CACHE:
        import numpy as _np
        rng = _np.random.default_rng(1879 + seed)
        perms = {}
        for b in PRIMES_FULL:
            # numpy storage: the cache must never capture tracers from
            # a jit trace that happens to build it first
            perms[b] = rng.permutation(b).astype(_np.int32)
        _PERM_CACHE[seed] = perms
    return _PERM_CACHE[seed]


def scrambled_radical_inverse(dim: int, i: jnp.ndarray,
                              seed: int = 0) -> jnp.ndarray:
    """Permuted radical inverse of i in the dim-th prime base
    (ref: lowdiscrepancy.h ScrambledRadicalInverse): every digit —
    including leading zeros — goes through the base's random
    permutation; the infinite tail of permuted zero digits contributes
    the analytic geometric-series term perm[0] * b^-ndig / (b - 1)."""
    base = PRIMES_FULL[dim % N_HALTON_DIMS]
    perm = jnp.asarray(_digit_perms(seed)[base])
    i = i.astype(jnp.uint32)
    inv_base = 1.0 / base
    ndig = 1
    cap = base
    while cap < (1 << 32):
        cap *= base
        ndig += 1

    def body(k, carry):
        val, rem, scale = carry
        digit = (rem % base).astype(jnp.int32)
        pd = jnp.take(perm, digit)
        return (val + pd.astype(jnp.float32) * scale,
                rem // base, scale * inv_base)

    val, _, scale_end = jax.lax.fori_loop(
        0, ndig, body,
        (jnp.zeros(i.shape, jnp.float32), i,
         jnp.full(i.shape, inv_base, jnp.float32)))
    tail = float(jnp.take(perm, 0)) * (inv_base ** ndig) / (1.0 - inv_base)
    return jnp.minimum(val + tail, 1.0 - 1e-7)


def halton_dim(i: jnp.ndarray, dim: int, scrambled: bool = True,
               seed: int = 0) -> jnp.ndarray:
    """Halton dimension with reference-style digit permutation for
    dims >= 2 (the first two dims stay unpermuted as in halton.cpp's
    pixel-decomposition dims)."""
    if scrambled and dim >= 2:
        return scrambled_radical_inverse(dim, i, seed)
    return radical_inverse(PRIMES_FULL[dim % N_HALTON_DIMS], i)


# ---------------------------------------------------------------------------
# MaxMinDist (0,2) patterns (ref: samplers/maxmin.cpp + the CMaxMinDist
# generator matrices of Grünschloß & Keller).  The reference ships
# searched tables; here equivalent matrices are FOUND at first use by a
# seeded randomized search maximizing the toroidal min distance of the
# resulting (0,2)-style point set — computed, not copied.
# ---------------------------------------------------------------------------

_MAXMIN_CACHE = {}


def _maxmin_matrix(m: int):
    """Generator matrix (m u32 columns) for 2^m points: y_i = C * i in
    GF(2), x_i = van der Corput.  Seeded search keeps it deterministic."""
    if m in _MAXMIN_CACHE:
        return _MAXMIN_CACHE[m]
    import numpy as _np
    n = 1 << m
    rng = _np.random.default_rng(977 + m)
    idx = _np.arange(n, dtype=_np.uint32)
    xs = _np.zeros(n, _np.float64)
    for b in range(m):
        xs += ((idx >> b) & 1) * (0.5 ** (b + 1))  # van der Corput

    def score(cols):
        y = _np.zeros(n, _np.uint32)
        for b in range(m):
            bit = ((idx >> b) & 1).astype(bool)
            y = _np.where(bit, y ^ cols[b], y)
        ys = y.astype(_np.float64) / (1 << 32)
        dx = _np.abs(xs[:, None] - xs[None, :])
        dy = _np.abs(ys[:, None] - ys[None, :])
        dx = _np.minimum(dx, 1 - dx)
        dy = _np.minimum(dy, 1 - dy)
        d2 = dx * dx + dy * dy
        _np.fill_diagonal(d2, 1e9)
        return d2.min()

    # candidate 0: Sobol' dim-2 columns (a known-good baseline)
    v = _np.uint32(1 << 31)
    sob = []
    for _ in range(m):
        sob.append(v)
        v = v ^ (v >> 1)
    best_cols = _np.asarray(sob, _np.uint32)
    best = score(best_cols)
    # hill-climb: flip single bits below each column's leading bit
    # (keeps the leading-bit stratification), restarting from random
    # matrices a few times
    if n <= 1024:
        for restart in range(4):
            if restart == 0:
                cols = best_cols.copy()
                cur = best
            else:
                cols = _np.asarray(
                    [_np.uint32(1 << (31 - b))
                     | (_np.uint32(rng.integers(0, 1 << 31))
                        >> _np.uint32(b + 1)) for b in range(m)],
                    _np.uint32)
                cur = score(cols)
            stale = 0
            for _ in range(600):
                b = int(rng.integers(0, m))
                bit = int(rng.integers(0, 31 - b))
                trial = cols.copy()
                trial[b] = trial[b] ^ _np.uint32(1 << bit)
                sc = score(trial)
                if sc > cur:
                    cols, cur, stale = trial, sc, 0
                else:
                    stale += 1
                    if stale > 150:
                        break
            if cur > best:
                best, best_cols = cur, cols
    _MAXMIN_CACHE[m] = (best_cols.astype(_np.uint32), float(best))
    return _MAXMIN_CACHE[m]


def maxmin02(i: jnp.ndarray, n_samples: int, scramble_x=None,
             scramble_y=None):
    """Max-min-distance (0,2) pattern point i of a 2^m set
    (ref: maxmin.cpp MaxMinDistSampler::StartPixel).  Falls back to
    sobol02 when n_samples exceeds the searched range."""
    m = max(1, int(np.ceil(np.log2(max(n_samples, 2)))))
    if m > 12:
        return sobol02(i, scramble_x, scramble_y)
    cols = jnp.asarray(_maxmin_matrix(m)[0])
    i = i.astype(jnp.uint32)
    x = _reverse_bits32(i)

    def body(b, carry):
        y, rem = carry
        bit = rem & jnp.uint32(1)
        y = jnp.where(bit == 1, y ^ cols[b], y)
        return (y, rem >> 1)

    y, _ = jax.lax.fori_loop(0, m, body,
                             (jnp.zeros(i.shape, jnp.uint32), i))
    if scramble_x is not None:
        x = x ^ scramble_x.astype(jnp.uint32)
    if scramble_y is not None:
        y = y ^ scramble_y.astype(jnp.uint32)
    scale = jnp.float32(1.0 / (1 << 32))
    return (jnp.minimum(x.astype(jnp.float32) * scale, 1.0 - 1e-7),
            jnp.minimum(y.astype(jnp.float32) * scale, 1.0 - 1e-7))


import numpy as np  # noqa: E402  (host-side helpers above)


_DYN_TABLES = None


def _dyn_tables(seed: int = 0):
    """Flattened per-base digit permutations + offsets for
    traced-dimension lookup (scrambled_radical_inverse_dyn)."""
    global _DYN_TABLES
    if _DYN_TABLES is None:
        import numpy as _np
        perms = _digit_perms(seed)
        bases = _np.asarray(PRIMES_FULL, _np.int32)
        offs = _np.zeros(N_HALTON_DIMS, _np.int32)
        flat = []
        acc = 0
        for k, b in enumerate(PRIMES_FULL):
            offs[k] = acc
            flat.append(_np.asarray(perms[b], _np.int32))
            acc += b
        # numpy storage (no tracer capture); converted at use sites
        _DYN_TABLES = (bases, offs, _np.concatenate(flat))
    return _DYN_TABLES


def scrambled_radical_inverse_dyn(dim, i, seed: int = 0):
    """Permuted radical inverse with a TRACED dimension index (the
    GlobalSampler needs dims computed from the traced bounce counter).
    Fixed 32 digit iterations; trailing zero digits map through perm[0]
    automatically, which realizes the reference's scrambled-tail
    semantics (lowdiscrepancy.h ScrambledRadicalInverse)."""
    bases_np, offs_np, flat_np = _dyn_tables(seed)
    bases, offs, flat = (jnp.asarray(bases_np), jnp.asarray(offs_np),
                         jnp.asarray(flat_np))
    dim = jnp.asarray(dim) % N_HALTON_DIMS
    base = jnp.take(bases, dim).astype(jnp.uint32)
    off = jnp.take(offs, dim)
    i = i.astype(jnp.uint32)
    base_f = base.astype(jnp.float32)
    inv_base = 1.0 / base_f

    def body(k, carry):
        val, rem, scale = carry
        digit = (rem % base).astype(jnp.int32)
        pd = jnp.take(flat, off + digit)
        return (val + pd.astype(jnp.float32) * scale,
                rem // base, scale * inv_base)

    val, _, _ = jax.lax.fori_loop(
        0, 32, body,
        (jnp.zeros(i.shape, jnp.float32), i,
         jnp.broadcast_to(inv_base, i.shape).astype(jnp.float32)))
    return jnp.minimum(val, 1.0 - 1e-7)
