"""Counter-based per-ray random streams.

Port of the reference's device RNG design
(/root/reference/src/core/shared/pcg_shared.h:190-330): a stateless hash
``pcg_hash(seed ^ pcg_hash(global_idx * 1000003 + slot))`` gives every
(ray, draw-slot) pair an independent uniform without any sequential state —
exactly what a vectorized / multi-chip sampler needs. Distinct sampling
purposes live in distinct seed domains via XOR nonces (the reference's
wl-pool / geom-shape stream lesson), and a 64-bit ray index is folded in via
the hi-epoch mix (pcg_shared.h:237-263 — the 2^32 stream-collision bug fix).

Everything here is pure jnp on uint32/float32 and traces under jit / vmap
alike.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ice_halo_sim_jax.config.schema import DistType

# Seed-domain nonces. Values are arbitrary but fixed; each sampling purpose
# draws from its own domain so streams can never collide across purposes.
NONCE_WL = np.uint32(0x9E3779B9)
NONCE_GEOM_SHAPE = np.uint32(0x85EBCA6B)
NONCE_ORIENT = np.uint32(0xC2B2AE35)
NONCE_SUN = np.uint32(0x27D4EB2F)
NONCE_ENTRY = np.uint32(0x165667B1)
NONCE_GATE = np.uint32(0xD3A2646C)
NONCE_SHUFFLE = np.uint32(0xFD7046C5)
NONCE_EMIT = np.uint32(0x94D049BB)   # emit-floor Russian-roulette draws

_U32 = jnp.uint32
TWO_PI = 2.0 * np.pi


def pcg_hash(x):
    """pcg_shared.h:192-196."""
    x = x.astype(jnp.uint32)
    x = x * _U32(747796405) + _U32(2891336453)
    x = ((x >> ((x >> _U32(28)) + _U32(4))) ^ x) * _U32(277803737)
    return (x >> _U32(22)) ^ x


def u01(h):
    """Uniform in [0, 1) from a 32-bit hash (pcg_shared.h:198-200).

    The u32 value is < 2^24 after the shift, so routing the float convert
    through int32 is value-identical; the streams depend on this exact
    form, so it stays."""
    return (h >> _U32(8)).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        1.0 / 16777216.0
    )


def hi_epoch_seed(seed, base_hi):
    """Mix the high half of a 64-bit ray base into the seed.

    pcg_shared.h:257-263: identity when hi == 0 so in-range sessions keep
    bit-identical streams; diverges per hi epoch past 2^32 rays.
    """
    seed = jnp.uint32(seed)
    base_hi = jnp.uint32(base_hi)
    return jnp.where(base_hi == 0, seed, seed ^ pcg_hash(base_hi))


def epoch_seed(seed, base_lo, base_hi, idx):
    """Per-ray effective seed for a 64-bit global ray index.

    `idx` is the (wrapping) u32 low half `base_lo + offset`; a wrap past
    2^32 promotes the ray into the next hi epoch (the per-thread
    carry-detect of pcg_advance_hi, pcg_shared.h:257-261) and the epoch is
    mixed into the seed via pcg_seed_with_high — identity when hi == 0, so
    every in-range session keeps bit-identical streams. This is the fix for
    the reference's documented 2^32 stream-collision silent-undersampling
    bug (trace_backend.hpp:160-190).
    """
    carry = (idx.astype(jnp.uint32) < jnp.uint32(base_lo)).astype(jnp.uint32)
    hi = jnp.uint32(base_hi) + carry
    seed = jnp.uint32(seed)
    return jnp.where(hi == 0, seed, seed ^ pcg_hash(hi))


def mul_u32_split(c, s: int):
    """(c * s) for traced u32 `c` and static int `s` < 2^32, as (lo, hi)
    u32 words — 32x32 -> 64 without relying on x64 mode (disabled by
    default under JAX; u32 arithmetic wraps silently otherwise)."""
    s = int(s) & 0xFFFFFFFF
    c = c.astype(jnp.uint32) if hasattr(c, "astype") else jnp.uint32(c)
    s_lo, s_hi = _U32(s & 0xFFFF), _U32(s >> 16)
    c_lo, c_hi = c & _U32(0xFFFF), c >> _U32(16)
    p_ll = c_lo * s_lo
    p_lh = c_lo * s_hi
    p_hl = c_hi * s_lo
    p_hh = c_hi * s_hi
    mid = p_lh + p_hl
    mid_carry = (mid < p_lh).astype(jnp.uint32)     # sum of two u32 wrapped
    lo = p_ll + (mid << _U32(16))
    lo_carry = (lo < p_ll).astype(jnp.uint32)
    hi = p_hh + (mid >> _U32(16)) + (mid_carry << _U32(16)) + lo_carry
    return lo, hi


def uniform(seed, idx, slot):
    """One u01 draw for stream (seed, idx) at draw-slot `slot`.

    Stateless mirror of pcg_uniform (pcg_shared.h:266-270); `slot` replaces
    the mutable stream counter.
    """
    idx = idx.astype(jnp.uint32)
    h = pcg_hash(jnp.uint32(seed) ^ pcg_hash(idx * _U32(1000003) + jnp.uint32(slot)))
    return u01(h)


def gaussian(seed, idx, slot):
    """Box-Muller standard normal; consumes slots [slot, slot+1]
    (pcg_shared.h:273-278)."""
    u1 = jnp.maximum(uniform(seed, idx, slot), jnp.float32(1e-7))
    u2 = uniform(seed, idx, slot + 1)
    return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(jnp.float32(TWO_PI) * u2)


# Max PCG slots any single distribution draw consumes (gaussian = 2).
SLOTS_PER_DIST = 2


def sample_dist(seed, idx, slot, dtype, center, spread):
    """Draw from one Distribution; all six types, vectorized over idx.

    Mirrors pcg_get_dist (pcg_shared.h:287-310) == RandomNumberGenerator::Get
    (math.cpp:420-446). `dtype`/`center`/`spread` may be scalars or arrays
    broadcastable against idx. Units are the caller's (the transforms are
    scale-equivariant, so degree and radian parameters behave identically).

    A STATIC Python-int dtype dispatches to just that family's transform
    (identical draws/slots — the value is what the dynamic path's `where`
    would have selected). Every engine call site has a static type; the
    dynamic all-branches path evaluates every family's transcendentals and
    discards all but one.
    """
    if isinstance(dtype, (int, np.integer)):
        dtype = int(dtype)
        center = jnp.asarray(center, jnp.float32)
        spread = jnp.asarray(spread, jnp.float32)
        if dtype == DistType.NO_RANDOM:
            return jnp.broadcast_to(center, jnp.shape(idx))
        if dtype == DistType.UNIFORM:
            return (uniform(seed, idx, slot) - 0.5) * spread + center
        if dtype in (DistType.GAUSS, DistType.GAUSS_LEGACY):
            return gaussian(seed, idx, slot) * spread + center
        if dtype == DistType.ZIGZAG:
            u = uniform(seed, idx, slot)
            return jnp.abs(spread * jnp.sin(u * jnp.float32(TWO_PI)) + center)
        if dtype == DistType.LAPLACIAN:
            u = uniform(seed, idx, slot)
            sgn = jnp.where(u < 0.5, -1.0, 1.0).astype(jnp.float32)
            arg = jnp.maximum(1.0 - 2.0 * jnp.abs(u - 0.5), jnp.float32(1e-30))
            return center - spread * sgn * jnp.log(arg)
        raise ValueError(f"unknown DistType {dtype}")

    u = uniform(seed, idx, slot)
    g = gaussian(seed, idx, slot)  # reuses slot, slot+1 — disjoint draws per type

    dtype = jnp.asarray(dtype)
    center = jnp.asarray(center, jnp.float32)
    spread = jnp.asarray(spread, jnp.float32)

    uniform_v = (u - 0.5) * spread + center
    gauss_v = g * spread + center
    zigzag_v = jnp.abs(spread * jnp.sin(u * jnp.float32(TWO_PI)) + center)
    sgn = jnp.where(u < 0.5, -1.0, 1.0).astype(jnp.float32)
    arg = jnp.maximum(1.0 - 2.0 * jnp.abs(u - 0.5), jnp.float32(1e-30))
    laplace_v = center - spread * sgn * jnp.log(arg)

    out = jnp.where(dtype == DistType.UNIFORM, uniform_v, center)
    out = jnp.where((dtype == DistType.GAUSS) | (dtype == DistType.GAUSS_LEGACY), gauss_v, out)
    out = jnp.where(dtype == DistType.ZIGZAG, zigzag_v, out)
    out = jnp.where(dtype == DistType.LAPLACIAN, laplace_v, out)
    return out


@functools.partial(jax.jit, static_argnums=(1,))
def feistel_bijection(i, n, seed):
    """Seeded bijection on [0, n) — 4-round balanced Feistel + cycle-walk.

    Vectorized mirror of pcg_shared.h:550-605; used to decorrelate the
    continuation-ray -> crystal pairing between MS layers (the reference's
    Recombine shuffle). `n` must be a static Python int.
    """
    n = int(n)
    if n <= 1:
        return i
    if n == 2:
        return i ^ 1

    bits = 0
    while bits < 30 and (1 << bits) < n:
        bits += 1
    if bits & 1:
        bits += 1
    half_bits = bits >> 1
    hm = _U32((1 << half_bits) - 1)
    round_const = [_U32(0x9E3779B9), _U32(0x85EBCA6B), _U32(0xC2B2AE35), _U32(0x27D4EB2F)]
    seed = jnp.uint32(seed)

    def one_pass(cur):
        left = (cur >> _U32(half_bits)) & hm
        right = cur & hm
        for rc in round_const:
            f = pcg_hash(seed ^ right ^ rc) & hm
            left, right = right, left ^ f
        return (left << _U32(half_bits)) | right

    cur = one_pass(i.astype(jnp.uint32))
    if (1 << bits) == n:
        return cur  # power-of-4^k domain: always in range after one pass

    # Cycle-walk out-of-range elements until they land in [0, n). Expected
    # depth < 2 for n in (p/2, p]; 64 matches the reference's guard. A
    # while_loop keeps the compiled graph one-pass-sized.
    def cond(state):
        cur, k = state
        return jnp.logical_and(jnp.any(cur >= _U32(n)), k < 64)

    def body(state):
        cur, k = state
        nxt = one_pass(cur)
        return jnp.where(cur >= _U32(n), nxt, cur), k + 1

    cur, _ = jax.lax.while_loop(cond, body, (cur, jnp.int32(0)))
    return jnp.where(cur < _U32(n), cur, cur % _U32(n)).astype(jnp.uint32)
