"""Image accumulation strategies.

The hot sink of the renderer is scatter-adding per-exit XYZ contributions
into the image (the reference uses CPU stores / GPU atomics,
accum_shared.h:29-75). Two folds compute the same image:

  * ``scatter_accumulate``: XLA scatter-add, which the GPU runs with
    float atomics (summation order varies from run to run).
  * ``sort_accumulate`` / ``fold_spectral``: a scatter-free formulation
    built on ``jax.lax.sort``:

  1. Sort the contributions TOGETHER with one marker row per pixel
     (key = pixel * 2 + is_marker, so a pixel's marker lands directly
     after all its contributions). Marker-ness is the key's parity — it
     needs no payload column.
  2. Segmented inclusive scan over the sorted values (chunked two-level
     formulation: in-chunk cumsum/cummax + a tiny cross-chunk carry scan),
     so each marker row holds its pixel's total.
  3. Block-local compaction of the P marker rows, IN PIXEL ORDER — that
     prefix IS the dense image.

Requires vals >= 0 (radiance contributions are), because the in-chunk
"latest group start" is recovered with a running max over the monotone
cumsum. Accuracy: per-pixel absolute error is bounded by ~ulp(chunk
prefix sum) — chunk-local, never grand-total, cancellation — which sits
well below Monte-Carlo noise for any realistic ray budget.

``fold_spectral`` is the sort fold's production variant: instead of
sorting (pixel, X, Y, Z, lane...) rows it packs the wavelength-POOL index
into the sort key's low bits and carries only the scalar weight; the CMF
basis is recomputed AFTER the sort from the key itself. Per-class Y lanes
ride as one u32 mask column instead of one f32 column per class.
Wavelength pooling mirrors the reference's per-ray wl pool
(trace_backend.hpp:521, LUMICE_WL_POOL_SIZE).

``AUTO_METHOD`` is the fold ``"auto"`` resolves to: the one that measured
faster on the H100 (see PERF.md, "Bring-up findings").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_NEG = -3.0e38  # effectively -inf for f32 cummax

# Row-block size for the block-local sorts (compaction + marker extraction).
# Inherited from the earlier accelerator; not yet measured on the H100.
BLOCK = 4096

# The fold accumulate(method="auto") and Engine(accum_method="auto") run.
AUTO_METHOD = "scatter"


def _varying_zeros(shape, dtype, tag):
    """Zeros carrying `tag`'s varying-manual-axes type.

    Under shard_map, a fori_loop whose init carry is a replicated constant
    but whose body writes shard-varying data fails to trace ("varying manual
    axes do not match"). ``jax.lax.pcast`` would need the
    mesh axis name, which this library-level code does not know; adding a
    zero derived from an already-varying integer scalar transfers the vma
    type without one. tag: a finite integer scalar derived from the data.
    """
    return jnp.zeros(shape, dtype) + (tag * 0).astype(dtype)


def scatter_accumulate(acc, pix, vals):
    """Baseline: XLA scatter-add. pix < 0 or >= P rows are dropped."""
    P = acc.shape[0]
    safe = jnp.where((pix >= 0) & (pix < P), pix, P)
    return acc.at[safe].add(vals, mode="drop")


def sort_accumulate(acc, pix, vals, chunk: int = 2048):
    """Scatter-free accumulate: acc + bincount-by-pixel of vals.

    acc: [P, C] float32. pix: [N] int32 (invalid rows: any value outside
    [0, P)). vals: [N, C] float32, vals >= 0.
    """
    P, C = acc.shape
    N = pix.shape[0]
    # Invalid rows get a key beyond every marker; their values must be
    # zeroed (they still participate in the sort, then fall off the end).
    valid = (pix >= 0) & (pix < P)
    key_contrib = jnp.where(valid, pix * 2, 2 * P)
    vals = jnp.where(valid[:, None], vals, 0.0)

    keys = jnp.concatenate([key_contrib, jnp.arange(P, dtype=pix.dtype) * 2 + 1])
    M = N + P
    # Pad to an extraction-block multiple with beyond-everything keys.
    block = chunk if chunk > BLOCK else BLOCK
    pad = -(-M // block) * block - M
    if pad:
        keys = jnp.concatenate([keys, jnp.full(pad, 2 * P + 2, keys.dtype)])
    chans = [
        jnp.concatenate([vals[:, c], jnp.zeros(P + pad)]) for c in range(C)
    ]

    s = jax.lax.sort(tuple([keys] + chans), num_keys=1, is_stable=False)
    sk = s[0]

    seg = _segmented_totals(sk, list(s[1 : 1 + C]), lambda k: k >> 1, chunk)

    # Marker for pixel p carries its total; key2 = p for markers, past-the-
    # end otherwise; block-local compaction materializes the dense image.
    is_marker = (sk & 1) == 1
    key2 = jnp.where(is_marker, sk >> 1, jnp.int32(0x7FFFFFFF))
    return acc + _marker_extract(key2, seg, P, block)


def _segmented_totals(sk, chans, pix_of, chunk):
    """Shared core: segmented per-pixel sums over sorted rows.

    sk: [M] sorted keys; chans: list of [M] f32 (>= 0); pix_of(sk) -> pixel
    id per row. Returns list of [M] arrays where the LAST row of each
    pixel's run holds that pixel's total (chunked two-level scan — see
    module docstring for the error bound).
    """
    M = sk.shape[0]
    G = M // chunk
    pix_ids = pix_of(sk)
    first = jnp.concatenate([jnp.ones(1, bool), pix_ids[1:] != pix_ids[:-1]])
    fg = first.reshape(G, chunk)
    started = jnp.cumsum(fg, axis=1) > 0
    has_start = jnp.any(fg, axis=1)

    sv = jnp.stack(chans, axis=-1)                        # [M, C]
    C = sv.shape[-1]
    svg = sv.reshape(G, chunk, C)
    cs = jnp.cumsum(svg, axis=1)
    cs_prev = cs - svg
    base = jax.lax.cummax(jnp.where(fg[..., None], cs_prev, _NEG), axis=1)
    wseg = jnp.where(started[..., None], cs - base, cs)

    tail = wseg[:, -1, :]                                 # [G, C]
    a = jnp.broadcast_to((~has_start).astype(sv.dtype)[:, None], tail.shape)

    def compose(p, q):
        pa, pb = p
        qa, qb = q
        return (pa * qa, qa * pb + qb)

    _, carry_incl = jax.lax.associative_scan(compose, (a, tail), axis=0)
    carry_in = jnp.concatenate([jnp.zeros((1, C), sv.dtype), carry_incl[:-1]], axis=0)
    seg = wseg + jnp.where(started[..., None], 0.0, carry_in[:, None, :])
    seg = seg.reshape(M, C)
    return [seg[:, c] for c in range(C)]


def _marker_extract(key2, seg_cols, P: int, block: int = BLOCK):
    """Dense [P, C] from scanned rows, WITHOUT a second global sort.

    key2: [M] = pixel id for marker rows, >= P for every other row, where
    the rows are still in sort1's GLOBAL key order (so markers appear in
    pixel order and all >= P rows trail them), so:

      1. Row-sort [M/block, block] blocks by key2 — compacts each block's
         markers to its front in pixel order.
      2. Because every pixel has exactly one marker and markers are in
         global pixel order, block g's markers are exactly the dense rows
         [start_g, start_g + m_g) with start = exclusive-cumsum of per-block
         marker counts.
      3. The block writes: each block's full `block` rows land at start_g —
         garbage rows past a block's markers land in LATER blocks' ranges
         and are overwritten by them (a later block never writes below its
         own start, so valid rows are never clobbered): a fori_loop of
         dynamic_update_slice with a one-block pad.
    """
    M = key2.shape[0]
    G = M // block
    assert G * block == M, "caller pads M to a block multiple"
    key2 = key2.astype(jnp.uint32)  # sort_accumulate passes int32 key2
    k2 = key2.reshape(G, block)
    is_m = k2 < P
    m_cnt = jnp.sum(is_m.astype(jnp.int32), axis=1)
    start = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(m_cnt)[:-1]]
    )
    s = jax.lax.sort(
        tuple([k2] + [c.reshape(G, block) for c in seg_cols]),
        dimension=1,
        num_keys=1,
        is_stable=False,
    )
    vals = jnp.stack(s[1:], axis=-1)                      # [G, block, C]
    dense = _varying_zeros((P + block, vals.shape[-1]), vals.dtype, m_cnt[0])

    def body(g, d):
        return jax.lax.dynamic_update_slice(d, vals[g], (start[g], 0))

    return jax.lax.fori_loop(0, G, body, dense)[:P]


def compact_rows(valid, cols, keep: int, block: int = BLOCK):
    """Compact rows flagged `valid` into a static-length prefix.

    cols: list of [N] 1-D arrays (mixed dtypes). Returns (sliced_cols,
    n_valid): each sliced col is [keep] holding all valid rows first (in
    original order by block) when n_valid <= keep — the caller must fall
    back to the uncompacted arrays otherwise (rows past `keep` are simply
    cut off by the slice).

    Same block-rowsort + forward-overwrite pattern as _marker_extract:
    block g's sorted rows are written whole at start_g = cumsum of valid
    counts; a block's valid prefix occupies exactly [start_g, start_{g+1})
    which no later block touches, its invalid suffix lands in later blocks'
    ranges and is overwritten — EXCEPT the LAST block's invalid suffix,
    which no later block exists to overwrite: it survives at positions
    [n_valid, n_valid + block - cnt_last). Invalid rows' payloads are
    therefore zeroed here before the block sort, so every output row is
    either a unique valid row or an all-zero row (zero weight folds to
    nothing); a caller whose "invalid" rows carry w > 0 would otherwise
    double-count the surviving tail.

    Purpose: fold cost is dominated by sort rows, and scenes with filters,
    probability gates, or dual-fisheye overlap bands leave most contribution
    rows dead (weight 0). The reference's GPU kernel skips those via thread
    divergence (cuda_trace_backend.cu filter gate); this compaction is the
    fixed-shape equivalent.
    """
    N = valid.shape[0]
    G = -(-N // block)
    pad = G * block - N
    key = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))
    cols = [jnp.where(valid, c, jnp.zeros_like(c)) for c in cols]
    if pad:
        key = jnp.concatenate([key, jnp.ones(pad, jnp.uint32)])
        cols = [
            jnp.concatenate([c, jnp.zeros(pad, c.dtype)]) for c in cols
        ]
    kb = key.reshape(G, block)
    cnt = jnp.sum((kb == 0).astype(jnp.int32), axis=1)
    start = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(cnt)[:-1]])
    s = jax.lax.sort(
        tuple([kb] + [c.reshape(G, block) for c in cols]),
        dimension=1,
        num_keys=1,
        is_stable=False,
    )
    outs = tuple(
        _varying_zeros((G * block + block,), c.dtype, cnt[0]) for c in cols
    )

    def body(g, outs):
        return tuple(
            jax.lax.dynamic_update_slice(o, s[i + 1][g], (start[g],))
            for i, o in enumerate(outs)
        )

    outs = jax.lax.fori_loop(0, G, body, outs)
    return [o[:keep] for o in outs], jnp.sum(cnt)


def compact_by_key(key, cols, keep: int, block: int = BLOCK):
    """Compact rows whose packed sort key != 0xFFFFFFFF into a static-length
    prefix, carrying `cols` along (prefix order ARBITRARY — all sorts here
    run is_stable=False; every consumer is order-invariant). The slim fold
    prepass: the key doubles as the validity flag (pack_spectral_keys sends dead rows to 0xFFFFFFFF), so
    the block sort carries len(cols) + 1 operands total instead of
    compact_rows' separate 0/1 key + pixel + wl columns.

    Returns ((key', cols'...), n_valid): each output is [keep]; exact when
    n_valid <= keep (caller guards). Rows past the last valid row are
    either real dead rows (key 0xFFFFFFFF) or zero-filled (key 0 with w 0 —
    a zero-weight contribution to pixel 0, which folds to nothing).
    """
    N = key.shape[0]
    G = -(-N // block)
    pad = G * block - N
    if pad:
        key = jnp.concatenate([key, jnp.full(pad, 0xFFFFFFFF, key.dtype)])
        cols = [jnp.concatenate([c, jnp.zeros(pad, c.dtype)]) for c in cols]
    kb = key.reshape(G, block)
    cnt = jnp.sum((kb != jnp.uint32(0xFFFFFFFF)).astype(jnp.int32), axis=1)
    start = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(cnt)[:-1]])
    s = jax.lax.sort(
        tuple([kb] + [c.reshape(G, block) for c in cols]),
        dimension=1,
        num_keys=1,
        is_stable=False,
    )
    dense = tuple(
        _varying_zeros((G * block + block,), x.dtype, cnt[0]) for x in s
    )

    def body(g, outs):
        return tuple(
            jax.lax.dynamic_update_slice(o, s[i][g], (start[g],))
            for i, o in enumerate(outs)
        )

    dense = jax.lax.fori_loop(0, G, body, dense)
    return tuple(o[:keep] for o in dense), jnp.sum(cnt)


def spectral_key_bits(n_pixels: int, k_pool: int) -> bool:
    """True iff (pixel, wl-idx, marker) packs into a u32 sort key.

    Strictly: the invalid/pad key 0xFFFFFFFF must decode to a pixel id
    >= n_pixels so dropped rows can never masquerade as the last real
    pixel's marker — hence (P+1)*2K, not P*2K.
    """
    return (n_pixels + 1) * 2 * k_pool <= (1 << 32)


def pack_spectral_keys(pix, w, wl_idx, n_pixels: int, k_pool: int):
    """Pack (pixel, wl-pool idx) contribution rows into the fold's u32 sort
    key: pixel * 2K | wl_idx * 2 (even = contribution). Invalid rows
    (out-of-range pixel or zero weight) key to 0xFFFFFFFF, which sorts past
    every marker AND decodes to a pixel >= n_pixels (spectral_key_bits).
    Returns (key [N] u32, w [N] with invalid rows zeroed)."""
    assert k_pool & (k_pool - 1) == 0, "k_pool must be a power of two"
    assert spectral_key_bits(n_pixels, k_pool), "pixel*wl key exceeds u32"
    shift = (2 * k_pool).bit_length() - 1  # log2(2K)
    valid = (pix >= 0) & (pix < n_pixels) & (w > 0.0)
    upix = jnp.where(valid, pix, 0).astype(jnp.uint32)
    key = jnp.where(
        valid,
        (upix << shift) | ((wl_idx.astype(jnp.uint32) & jnp.uint32(k_pool - 1)) << 1),
        jnp.uint32(0xFFFFFFFF),
    )
    return key, jnp.where(valid, w, 0.0)


def fold_spectral_keys(
    acc, key, w, k_pool: int, basis_fn, lane_specs=(), mask=None,
    prefix_len=None, chunk: int = 2048,
):
    """Scatter-free spectral fold over PRE-PACKED keys (pack_spectral_keys).

    ONE global sort carries everything: dead rows (key 0xFFFFFFFF) sort past
    all P markers, so the sort doubles as the dead-row compaction — no
    separate compaction prepass exists. When `prefix_len` (static, multiple
    of the 16384 extraction block) is given, the scan + extraction stages run
    on only the first prefix_len sorted rows; this is EXACT iff
    live_rows + P <= prefix_len (the caller guards with lax.cond on the
    measured live count and falls back to the full length).

    acc: [P, 3 + L]; key/w/mask: [N]; basis_fn: (wl_idx [M] u32) -> [M, 3].
    """
    P = acc.shape[0]
    L = len(lane_specs)
    N = key.shape[0]
    shift = (2 * k_pool).bit_length() - 1
    marker_keys = (
        (jnp.arange(P, dtype=jnp.uint32) << shift) | jnp.uint32(2 * k_pool - 1)
    )

    keys = jnp.concatenate([key, marker_keys])
    w_all = jnp.concatenate([w, jnp.zeros(P, w.dtype)])
    M = N + P
    block = chunk if chunk > BLOCK else BLOCK
    pad = -(-M // block) * block - M
    if pad:
        keys = jnp.concatenate([keys, jnp.full(pad, 0xFFFFFFFF, jnp.uint32)])
        w_all = jnp.concatenate([w_all, jnp.zeros(pad, w.dtype)])

    operands = [keys, w_all]
    if L:
        mask_all = jnp.concatenate(
            [mask.astype(jnp.uint32), jnp.zeros(P + pad, jnp.uint32)]
        )
        operands.append(mask_all)
    s = jax.lax.sort(tuple(operands), num_keys=1, is_stable=False)
    if prefix_len is not None and prefix_len < M + pad:
        assert prefix_len % block == 0, prefix_len
        s = tuple(x[:prefix_len] for x in s)
    sk, sw = s[0], s[1]

    basis = basis_fn((sk >> 1) & jnp.uint32(k_pool - 1))       # [M', 3]
    chans = [basis[:, c] * sw for c in range(3)]
    if L:
        smask = s[2]
        y = chans[1]
        for bits, combine_all in lane_specs:
            b = jnp.uint32(bits)
            member = (smask & b) == b if combine_all else (smask & b) != 0
            chans.append(jnp.where(member, y, 0.0))
    seg = _segmented_totals(sk, chans, lambda k: k >> shift, chunk)

    is_marker = (sk & jnp.uint32(2 * k_pool - 1)) == jnp.uint32(2 * k_pool - 1)
    key2 = jnp.where(is_marker, sk >> shift, jnp.uint32(0xFFFFFFFF))
    return acc + _marker_extract(key2, seg, P, block)


def fold_spectral(
    acc, pix, w, wl_idx, k_pool: int, basis_fn, lane_specs=(), mask=None,
    chunk: int = 2048,
):
    """Scatter-free accumulate of spectral contributions.

    acc:     [P, 3 + L] f32 — XYZ channels + one Y lane per class.
    pix:     [N] int32 pixel ids (out-of-range rows are dropped).
    w:       [N] f32 >= 0 contribution weights.
    wl_idx:  [N] uint32 wavelength-pool indices in [0, k_pool).
    k_pool:  static power of two; requires spectral_key_bits(P, k_pool).
    basis_fn: (idx [M] u32) -> [M, 3] f32, the CIE XYZ basis per unit
             weight for pool entry idx (recomputed post-sort — this is the
             whole trick: the sort carries ONE f32 payload instead of C).
    lane_specs: tuple of (mask_bits, combine_all) per class lane.
    mask:    [N] uint32 per-row component masks (required if lane_specs).

    Key layout (u32): pixel * 2K | wl_idx * 2 | is_marker, so one pixel's
    contributions (any wl order — addition commutes) land directly before
    its marker row; invalid/pad rows key to 0xFFFFFFFF past every marker.
    """
    P = acc.shape[0]
    key, w = pack_spectral_keys(pix, w, wl_idx, P, k_pool)
    if mask is not None:
        mask = jnp.where(key != jnp.uint32(0xFFFFFFFF), mask, 0)
    return fold_spectral_keys(
        acc, key, w, k_pool, basis_fn, lane_specs=lane_specs, mask=mask,
        chunk=chunk,
    )


def accumulate(acc, pix, vals, method: str = "auto"):
    """Dispatch: 'scatter' | 'sort' | 'auto' (= AUTO_METHOD)."""
    if method == "auto":
        method = AUTO_METHOD
    if method == "sort":
        return sort_accumulate(acc, pix, vals)
    return scatter_accumulate(acc, pix, vals)
