"""Self-/cross-similarity matrix image.

JAX re-implementation of impl/SelfSimilarityImpl.scala.  The
reference's O(n²/2) per-cell loop re-reads both half-windows from disk for
every cell (:127-165, its own "XXX inefficient" comment); here the whole
gram matrix is computed in matmul blocks: windows are gathered once, per-window
sums precomputed, and each (row-block × col-block) pair is one matmul
(kernels/corr.py::gram_similarity_block).

Parity notes:
* decimation subsamples window starts (stride ``decim``), exactly like the
  reference — it does not average (:162-164);
* auto-decimation raises ``decim`` so the image extent stays ≤ 0xB504
  (:81-91), with the same warning print;
* cell (i, j) correlates file-1's window i (first half) against file-2's
  window j (second half) with joint statistics; only i ≤ j is computed and
  both symmetric pixels are written y-flipped (:152-155);
* pixel color = palette(pow(max(0, sim), colorWarp) / colorCeil) (:150).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ColorScheme, ExtractionConfig, SelfSimilarityConfig
from ..kernels import corr as K
from ..runtime.processor import Processor, ProcessorFactory
from ..util.palette import apply_palette
from ..util.png import write_png, write_png_rows
from .common import full_to_feat, load_norm, normalized, read_features

__all__ = ["SelfSimilarity", "self_similarity_matrix",
           "self_similarity_image", "self_similarity_to_png"]

_MAX_EXTENT = 0xB504
_BLOCK = 512
_PAIR_GROUP = 8
#: Above this extent the [n, n] float32 matrix would pass ~0.5 GB — switch
#: to the stripe-streaming PNG path (identical pixels, bounded memory).
_STREAM_EXTENT = 11000
#: Above this extent the factory's streaming path defaults to deflate
#: level 1 (raw scanlines pass ~1.2 GB; level 6 costs minutes of extra
#: single-threaded deflate at the 46340 ceiling for a modestly smaller
#: file).  Override per process via ``SelfSimilarity.png_level``.
_FAST_DEFLATE_EXTENT = 20000


def _gram_group_core(wi_s, wj_s, stats_i, stats_j, temp_weight,
                     num_temporal: int = 1):
    """vmap of gram_similarity_block over a stacked group of block pairs —
    amortizes dispatch overhead across ``_PAIR_GROUP`` matmuls."""
    def one(a, b, sa, sb):
        return K.gram_similarity_block(a, b, sa, sb, temp_weight,
                                       num_temporal=num_temporal)

    return jax.vmap(one)(wi_s, wj_s, stats_i, stats_j)


_gram_pair_group = partial(jax.jit, static_argnames=("num_temporal",))(
    _gram_group_core)


# --- device colorization (colorWarp == 1 fast path) -------------------------
# Replicates the host quantization (``_colorize`` + ``apply_palette``) with
# the identical float32 op sequence — IEEE mul/add/clip/truncate, no pow —
# so the produced gray bytes / palette indices are bit-equal to the host
# path (which itself mirrors the reference's Java float math,
# SelfSimilarityImpl.scala:98-110).  Shipping uint8/uint16 instead of
# float32 sims cuts the device→host bytes 4×/2×.
#
# The three stages are SEPARATE dispatches on purpose.  Inside one compiled
# kernel XLA:CPU lets LLVM contract a multiply feeding an add/sub into an
# FMA — one rounding where the host/Java sequence rounds twice — which
# flips the quantized index for sims whose product lands exactly on a
# rounding tie (observed on ~2% of random rasters at colorInv+colorCeil
# 1.3: 1 − s·(1/1.3) hit a round-to-even tie).  Every value-preserving
# in-graph fence is elided before LLVM sees it (optimization_barrier and
# identity reduce_precision are dropped, bitcast pairs and min(x, +inf)
# folded by the algebraic simplifier) — a kernel boundary is the only
# fence the compiler cannot remove.  Within each stage no multiply feeds
# an add/sub, so every op is individually IEEE-rounded:
#   s1: max, ×inv_ceil              (mul, no add)
#   s2: [1−·], nan→0, [clip], ×k    (sub/muls never chained into an add)
#   s3: +0.5, [clip], truncate-cast (adds, no mul)
# Cost: two extra tiny elementwise dispatches per chunk.  XLA:GPU
# contracts FMAs as well; chip_smoke.py checks the fence on the GPU (its
# -x PNG against the host colorization of the same sims).

@jax.jit
def _pix_s1(sims, inv_ceil):
    return jnp.maximum(sims, 0.0) * inv_ceil


@partial(jax.jit, static_argnames=("gray", "inv"))
def _pix_s2(v, k, gray: bool = False, inv: bool = False):
    if inv:
        v = 1.0 - v
    # np.nan_to_num semantics: NaN → 0 (Java's (int)NaN == 0 — same pixel
    # the reference produces), ±inf → ±huge (the clips resolve them to the
    # same endpoints either way)
    v = jnp.nan_to_num(v, nan=0.0)
    if gray:
        return v * k          # host clips after the +0.5 (``_colorize``)
    return jnp.clip(v, 0.0, 1.0) * k      # host clips first (apply_palette)


@partial(jax.jit, static_argnames=("gray",))
def _pix_s3(t, gray: bool = False):
    if gray:
        return jnp.clip(t + np.float32(0.5), 0.0, 255.0).astype(jnp.uint8)
    return (t + np.float32(0.5)).astype(jnp.uint16)


def _apply_pix_stages(sims_dev, pix):
    """Quantize device sims (async — three chained dispatches)."""
    inv_ceil, k, gray, inv = pix
    v = _pix_s1(sims_dev, inv_ceil)
    return _pix_s3(_pix_s2(v, k, gray=gray, inv=inv), gray=gray)


def _device_pix(colors: str, color_warp: float, color_ceil: float,
                color_inv: bool):
    """``(inv_ceil, k, gray, inv)`` for the fused device colorization —
    ``k`` the device-resident quantization factor (255 for gray,
    ``NUM_COLORS − 1`` for palette indices; built once per render so the
    per-chunk dispatches reuse one committed buffer instead of an upload
    each) — or None when the bit-exact
    fast path does not apply: ``colorWarp != 1`` (pow on device is not
    ulp-identical to host pow) or a custom palette too large for uint16
    indices.  Callers fall back to fetching float32 sims and colorizing
    on host."""
    if float(color_warp) != 1.0:
        return None
    gray = colors == ColorScheme.GRAY_SCALE
    from ..util import palette as P
    if not gray and P.NUM_COLORS > 0xFFFF:
        return None
    k = 255 if gray else P.NUM_COLORS - 1
    return (jnp.float32(1.0 / color_ceil), jnp.float32(k), gray,
            bool(color_inv))


# --- fast engine (single-device and mesh) -----------------------------------
# The per-group engine below issues ~10 eager stack ops + 1 jit call per
# 8-pair group, each dispatch a host round-trip.  The fast engine removes
# the per-group traffic: every window
# block is stacked ONCE into two resident arrays and each dispatch fetches
# _PAIRS_PER_CALL pairs through a single jitted call that gathers its
# operand blocks in-program (one tiny [2, P] index upload per call).
# The per-pair math is the same jitted kernels on the same operands, but
# the two engines are DIFFERENT compiled programs: XLA chooses FMA
# contractions per program, so cross-engine sims agree within the plan-
# invariance budget (≤2e-5; ≤2e-7 over a 60-config soak), bitwise at most
# shapes (tests pin the budget).
#
# Under a ``mesh`` the SAME engine runs SPMD: the window/stat stacks are
# replicated over the devices (315 MB at the 46340 ceiling — trivial vs
# device memory, and replication means the per-pair block gather needs no
# collectives at all), the tiny per-call ``[2, P]`` index upload is
# sharded over the pairs axis, and the jitted program's output sharding
# pins one pair slice per device — each device computes its own
# ``_PAIRS_PER_CALL`` pairs of the chunk.  The older per-group engine
# (eager host stacks + per-dispatch device_put) is kept below only as the
# dispatch-cost A/B baseline for tools/ and the cross-engine parity tests.

_PAIRS_PER_CALL = 32


def _extent(x1: np.ndarray, x2: np.ndarray, half_win: int,
            decim: int) -> int:
    """Image extent ``n`` (decimated window-pair count) — the one formula
    both engines' preps share (SelfSimilarityImpl.scala:75-91)."""
    af_len = min(x1.shape[1], x2.shape[1])
    num_corrs = max(0, af_len - half_win * 2 + 1)
    return num_corrs // decim


def _prep_resident(x1: np.ndarray, x2: np.ndarray, half_win: int,
                   decim: int, num_temporal: int = 1, mesh=None):
    """Fast-engine prep: image extent, block count, and per-input
    ``(win_all [NSp, C, h], stats_all [4, NSp], num_temporal)`` resident
    stacks (``num_temporal`` rides with the stacks so the pair-call
    program can never blend with a different split than the stats were
    computed with).

    ``NSp`` pads the block count to a power of two (padded starts repeat
    the last window start — valid data, never indexed by a real pair) so
    the pair-call program keeps a handful of jit keys across extents; the
    input length never enters the jit key at all (windows are
    materialized).  Memory: ``NSp·_BLOCK·C·h`` floats per input — 315 MB
    at the reference's 46340 ceiling (doubled in cross mode, where the
    two inputs hold separate stacks), well under this chip's HBM."""
    n = _extent(x1, x2, half_win, decim)
    if n == 0:
        return 0, 0, None, None
    num_blocks = (n + _BLOCK - 1) // _BLOCK
    nbp = 1
    while nbp < num_blocks:
        nbp *= 2
    starts = np.minimum(np.arange(nbp * _BLOCK, dtype=np.int64),
                        n - 1) * decim
    starts_d = jnp.asarray(starts)

    def stacks_of(xj):
        win_all = K.extract_windows(jnp.asarray(xj), starts_d, half_win)
        stats_all = jnp.stack(K.window_stats(win_all,
                                             num_temporal=num_temporal))
        if mesh is not None:
            # replicate the stacks over the mesh so every device gathers
            # its pair blocks locally (no collectives in the gram program)
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(mesh, P())
            win_all = jax.device_put(win_all, rep)
            stats_all = jax.device_put(stats_all, rep)
        return win_all, stats_all, num_temporal

    res1 = stacks_of(x1)
    res2 = res1 if x2 is x1 else stacks_of(x2)
    return n, num_blocks, res1, res2


def _pair_block_gather(win_all, stats_all, block_ids):
    """Vmapped in-program gather of whole window blocks: ``[P]`` block ids
    → ``([P, _BLOCK, C, h]`` windows, 4× ``[P, _BLOCK]`` stats)."""
    c, h = win_all.shape[1], win_all.shape[2]

    def one(b):
        w = jax.lax.dynamic_slice(win_all, (b * _BLOCK, 0, 0),
                                  (_BLOCK, c, h))
        s = jax.lax.dynamic_slice(stats_all, (0, b * _BLOCK), (4, _BLOCK))
        return w, s

    w, s = jax.vmap(one)(block_ids)
    return w, (s[:, 0], s[:, 1], s[:, 2], s[:, 3])


def _gram_pairs_core(win1, stats1, win2, stats2, idx, tw,
                     num_temporal: int = 1):
    """``idx``: ``[2, P]`` (row-block ids, col-block ids).  Returns
    ``sims [P, _BLOCK, _BLOCK]`` — same per-pair kernels as the group
    engine, operands gathered in-program."""
    wi, sti = _pair_block_gather(win1, stats1, idx[0])
    wj, stj = _pair_block_gather(win2, stats2, idx[1])
    return _gram_group_core(wi, wj, sti, stj, tw, num_temporal=num_temporal)


_gram_pairs_fast = partial(jax.jit, static_argnames=("num_temporal",))(
    _gram_pairs_core)

#: last (mesh, jitted gram program) pair — out_shardings pins one pair
#: slice per device.  A single-entry cache: repeated renders on the one
#: process-wide mesh reuse the executable, while a process that cycles
#: through many distinct meshes doesn't pin every mesh's device handles
#: and compiled programs for its lifetime
_gram_pairs_mesh_cache: list = [None, None]


def _gram_pairs_for_mesh(mesh):
    """SPMD variant of :func:`_gram_pairs_fast`: sims ``[P, B, B]`` sharded
    over the pairs axis — each device computes the pairs its ``idx`` shard
    names, gathering blocks from its replicated stacks."""
    if _gram_pairs_mesh_cache[0] is not mesh:
        from jax.sharding import NamedSharding, PartitionSpec as P
        _gram_pairs_mesh_cache[0] = mesh
        _gram_pairs_mesh_cache[1] = jax.jit(
            _gram_pairs_core, static_argnames=("num_temporal",),
            out_shardings=NamedSharding(mesh, P("files")))
    return _gram_pairs_mesh_cache[1]


def _dispatch_pairs_fast(res1, res2, pairs, tw, pix=None, mesh=None):
    """One gram call (+ staged colorize) for one chunk of (bi, bj) pairs
    (async): ``_PAIRS_PER_CALL`` pairs per device."""
    idx = jnp.asarray(np.asarray(pairs, np.int32).T)
    if mesh is None:
        gram = _gram_pairs_fast
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P
        idx = jax.device_put(idx, NamedSharding(mesh, P(None, "files")))
        gram = _gram_pairs_for_mesh(mesh)
    win1, stats1, nt = res1
    win2, stats2, _ = res2
    sims = gram(win1, stats1, win2, stats2, idx, tw, num_temporal=nt)
    return sims if pix is None else _apply_pix_stages(sims, pix)


def _iter_pair_sims(pairs, dispatch_chunk, chunk_size,
                    check_aborted=lambda: None, lookahead: int = 2):
    """Yield ``((bi, bj), sims[_BLOCK, _BLOCK])`` per real pair, with
    ``lookahead`` chunks dispatched ahead of the fetch so device work and
    result transfers overlap the host write-back (the per-group engine
    previously fetched synchronously per dispatch)."""
    from collections import deque
    chunks = []
    for g0 in range(0, len(pairs), chunk_size):
        c = pairs[g0:g0 + chunk_size]
        chunks.append((c, c + [c[-1]] * (chunk_size - len(c))))
    pending: "deque" = deque()
    ci = 0
    while pending or ci < len(chunks):
        # checked every iteration — including the drain of the final
        # lookahead chunks, where an abort must still be honored
        check_aborted()
        while ci < len(chunks) and len(pending) < lookahead:
            c, padded = chunks[ci]
            ci += 1
            pending.append((c, dispatch_chunk(padded)))
        c, dev = pending.popleft()
        sims = np.asarray(dev)
        for p, s in zip(c, sims):
            yield p, s


def _dispatch_group(blocks1, blocks2, pairs, tw, pix=None):
    """Per-group engine: stack a group of (block-i, block-j)
    pairs eagerly and dispatch (async) — returns the device array.  With
    ``pix`` the result is the colorized uint8/uint16 raster; else float32
    sims.  Not used by any shipped path anymore (both the single-device
    and the mesh engines run the resident fast formulation); kept as the
    dispatch-cost A/B baseline (tools/selfsim_bench.py --group-engine)
    and the cross-engine parity
    oracle (tests/test_gram_fast_engine.py)."""
    wi_s = jnp.stack([blocks1[a][0] for a, _ in pairs])
    wj_s = jnp.stack([blocks2[b][0] for _, b in pairs])
    sti = tuple(jnp.stack([blocks1[a][1][t] for a, _ in pairs])
                for t in range(4))
    stj = tuple(jnp.stack([blocks2[b][1][t] for _, b in pairs])
                for t in range(4))
    sims = _gram_pair_group(wi_s, wj_s, sti, stj, tw)
    return sims if pix is None else _apply_pix_stages(sims, pix)


def _pix_to_rgb(pix_vals: np.ndarray, gray: bool) -> np.ndarray:
    """Device-colorized raster → RGB: gray bytes broadcast, palette indices
    gathered through the (possibly drop-in) host table."""
    if gray:
        return np.stack([pix_vals, pix_vals, pix_vals], axis=-1)
    from ..util.palette import lookup
    return lookup(pix_vals)


def _prep_window_blocks(x1: np.ndarray, x2: np.ndarray, half_win: int,
                        decim: int):
    """Group-engine prep (A/B baseline only — see :func:`_dispatch_group`):
    image extent ``n``, block count, and per-block device windows + stats
    for both inputs (starts padded so every block is full → one jit key
    for all pairs; padded rows/cols are sliced away on write-back)."""
    n = _extent(x1, x2, half_win, decim)
    if n == 0:
        return 0, 0, [], []
    num_blocks = (n + _BLOCK - 1) // _BLOCK
    starts = np.minimum(np.arange(num_blocks * _BLOCK, dtype=np.int64),
                        n - 1) * decim

    def blocks_of(xj):
        out = []
        for b in range(num_blocks):
            s = starts[b * _BLOCK:(b + 1) * _BLOCK]
            win = K.extract_windows(xj, jnp.asarray(s), half_win)
            out.append((win, K.window_stats(win)))
        return out

    blocks1 = blocks_of(jnp.asarray(x1))
    blocks2 = blocks1 if x2 is x1 else blocks_of(jnp.asarray(x2))
    return n, num_blocks, blocks1, blocks2


def _make_engine(x1, x2, half_win: int, decim: int, tw, pix, mesh):
    """Prep the gram fast engine: ``(n, num_blocks, dispatch, chunk)``
    where ``dispatch(padded_pairs)`` asynchronously computes one chunk of
    (bi, bj) block pairs — resident stacks + in-jit gather, with a
    ``mesh`` sharding ``_PAIRS_PER_CALL`` pairs per device (replicated
    stacks, sharded index — see the fast-engine note above)."""
    n, num_blocks, res1, res2 = _prep_resident(x1, x2, half_win, decim,
                                               mesh=mesh)
    chunk = _PAIRS_PER_CALL * (mesh.devices.size if mesh is not None else 1)
    return (n, num_blocks,
            lambda ps: _dispatch_pairs_fast(res1, res2, ps, tw, pix,
                                            mesh=mesh),
            chunk)


def _pixel_matrix(x1: np.ndarray, x2: np.ndarray, half_win: int,
                  decim: int, temp_weight: float,
                  check_aborted=lambda: None,
                  progress=lambda f: None, pix=None, mesh=None) -> np.ndarray:
    """Shared matrix builder: float32 sims (``pix=None``) or the
    device-colorized uint8/uint16 raster over the same block schedule."""
    dtype = np.float32 if pix is None else (
        np.uint8 if pix[2] else np.uint16)
    tw = jnp.float32(temp_weight)
    n, num_blocks, dispatch, chunk = _make_engine(
        x1, x2, half_win, decim, tw, pix, mesh)
    if n == 0:
        return np.zeros((0, 0), dtype)

    pairs = [(bi, bj) for bi in range(num_blocks)
             for bj in range(bi, num_blocks)]
    out = np.empty((n, n), dtype)
    done = 0
    for (bi, bj), sims in _iter_pair_sims(pairs, dispatch, chunk,
                                          check_aborted=check_aborted):
        r0 = bi * _BLOCK
        c0 = bj * _BLOCK
        r1 = min(r0 + _BLOCK, n)
        c1 = min(c0 + _BLOCK, n)
        s = sims[:r1 - r0, :c1 - c0]
        if bi == bj:
            # only i ≤ j cells are the reference's computed values
            # (SelfSimilarityImpl.scala:136); mirror the upper triangle —
            # in cross mode the i > j half of the block differs
            s = np.triu(s) + np.triu(s, 1).T
            out[r0:r1, c0:c1] = s
        else:
            out[r0:r1, c0:c1] = s
            out[c0:c1, r0:r1] = s.T
        done += 1
        progress(done / len(pairs))
    return out


def self_similarity_matrix(x1: np.ndarray, x2: np.ndarray, half_win: int,
                           decim: int, temp_weight: float,
                           check_aborted=lambda: None,
                           progress=lambda f: None, mesh=None) -> np.ndarray:
    """Similarity matrix ``[n, n]`` over decimated window starts of two
    prepared (normalized, *jointly* shifted) feature matrices.  With a
    ``mesh`` the pair chunks shard over the ``files`` axis (same fast
    engine run SPMD; a different compiled program than single-device, so
    plan-budget results — see the fast-engine note)."""
    return _pixel_matrix(x1, x2, half_win, decim, temp_weight,
                         check_aborted=check_aborted, progress=progress,
                         mesh=mesh)


def self_similarity_image(x1: np.ndarray, x2: np.ndarray, half_win: int,
                          decim: int, temp_weight: float,
                          colors: str = ColorScheme.PSYCHO_OPTICAL,
                          color_warp: float = 1.0, color_ceil: float = 1.0,
                          color_inv: bool = False,
                          check_aborted=lambda: None,
                          progress=lambda f: None, mesh=None) -> np.ndarray:
    """RGB image (reference pixel layout) for the similarity matrix.

    Uses the fused device colorization when ``colorWarp == 1`` (fetching
    uint8/uint16 rasters instead of float32 sims — bit-identical pixels,
    2-4× fewer link bytes); otherwise computes the float32 matrix and
    colorizes on host exactly like :func:`render_image`.
    """
    pix = _device_pix(colors, color_warp, color_ceil, color_inv)
    if pix is None:
        sims = _pixel_matrix(x1, x2, half_win, decim, temp_weight,
                             check_aborted=check_aborted, progress=progress,
                             mesh=mesh)
        return render_image(sims, colors, color_warp, color_ceil, color_inv)
    vals = _pixel_matrix(x1, x2, half_win, decim, temp_weight,
                         check_aborted=check_aborted, progress=progress,
                         pix=pix, mesh=mesh)
    rgb = _pix_to_rgb(vals, pix[2])
    # same layout rule as render_image: x = i, y = flipped j
    return rgb.transpose(1, 0, 2)[::-1]


def _colorize(v_sims: np.ndarray, colors: str, color_warp: float,
              color_ceil: float, color_inv: bool) -> np.ndarray:
    """sim values → RGB via the reference's color mapping
    ``colorFun(pow(max(0, sim), warp) / ceil)`` (SelfSimilarityImpl.scala:150)."""
    v = np.power(np.maximum(v_sims, 0.0), color_warp) * (1.0 / color_ceil)
    if color_inv:
        v = 1.0 - v
    if colors == ColorScheme.GRAY_SCALE:
        # NaN → 0 like Java's (int)NaN (the reference's (sim*255+0.5).toInt,
        # SelfSimilarityImpl.scala:100); apply_palette applies the same rule
        v = np.nan_to_num(v, nan=0.0)
        with np.errstate(over="ignore"):   # ±huge × 255 → ±inf → clip
            g = np.clip(v * np.float32(255) + np.float32(0.5),
                        0, 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)
    return apply_palette(v)


def render_image(sims: np.ndarray, colors: str, color_warp: float,
                 color_ceil: float, color_inv: bool) -> np.ndarray:
    """Similarity matrix → RGB image with the reference's pixel layout:
    x = i, y = flipped j (SelfSimilarityImpl.scala:152-155)."""
    rgb = _colorize(sims, colors, color_warp, color_ceil, color_inv)
    # image[y, x] with y = extent−1−j, x = i  → flip the j (column) axis and
    # transpose so rows become y
    return rgb.transpose(1, 0, 2)[::-1]


def self_similarity_to_png(x1: np.ndarray, x2: np.ndarray, half_win: int,
                           decim: int, temp_weight: float, path,
                           colors: str = ColorScheme.PSYCHO_OPTICAL,
                           color_warp: float = 1.0, color_ceil: float = 1.0,
                           color_inv: bool = False,
                           check_aborted=lambda: None,
                           progress=lambda f: None,
                           png_level: int = 6, mesh=None) -> int:
    """Stream the similarity image straight to a PNG without ever holding
    the ``[n, n]`` matrix (8.6 GB at the reference's 46340 extent ceiling)
    or its RGB raster: one ``[n, _BLOCK]`` column stripe at a time is
    computed on device, colorized, and fed to the banded PNG compressor.

    PNG row ``y`` is matrix column ``j = n−1−y`` (the reference's y-flip),
    so stripes are emitted in descending-``j`` order.  Cell values mirror
    the upper triangle exactly like :func:`self_similarity_matrix` (the
    reference computes i ≤ j and writes both symmetric pixels,
    SelfSimilarityImpl.scala:136,152-155); off-diagonal blocks are
    recomputed for their mirror stripe — a 2× compute trade for O(n·block)
    memory, the right exchange when the matmuls run on the accelerator.

    Returns the image extent ``n``.
    """
    import os as _os
    import sys as _sys
    import time as _time

    tw = jnp.float32(temp_weight)
    pix = _device_pix(colors, color_warp, color_ceil, color_inv)
    dtype = np.float32 if pix is None else (
        np.uint8 if pix[2] else np.uint16)
    n, num_blocks, dispatch, gsize = _make_engine(
        x1, x2, half_win, decim, tw, pix, mesh)
    if n == 0:
        write_png(path, np.zeros((0, 0, 3), np.uint8))
        return 0
    # STRUGATZKI_RENDER_TIMING=1: per-stage wall decomposition of the
    # giant render (the number that decides whether the ceiling is
    # device-, fetch-, or deflate-bound); "fetch" is
    # the np.asarray wait on device results (includes any device compute
    # not hidden by the stripe-ahead), "raster" the host flip+colorize,
    # "png" = total − the in-generator stages ≈ filter+deflate+write.
    timing = ({"dispatch": 0.0, "fetch": 0.0, "raster": 0.0}
              if _os.environ.get("STRUGATZKI_RENDER_TIMING") else None)
    t_start = _time.perf_counter()

    def dispatch_stripe(bj):
        """Launch every chunk of column-stripe ``bj`` asynchronously.
        Row-blocks go in chunks of ``gsize`` = ``_PAIRS_PER_CALL`` per
        device (one jitted call each); for bi > bj the cell is the
        mirrored upper-triangle value → compute (bj, bi), transpose."""
        t0 = _time.perf_counter() if timing else 0.0
        out = []
        for g0 in range(0, num_blocks, gsize):
            group = list(range(g0, min(g0 + gsize, num_blocks)))
            padded = group + [group[-1]] * (gsize - len(group))
            lo_hi = [(min(bi, bj), max(bi, bj)) for bi in padded]
            out.append((group, dispatch(lo_hi)))
        if timing:
            timing["dispatch"] += _time.perf_counter() - t0
        return out

    def collect_stripe(bj, dispatched):
        c0 = bj * _BLOCK
        c1 = min(c0 + _BLOCK, n)
        stripe = np.empty((n, c1 - c0), dtype)
        for group, dev in dispatched:
            t0 = _time.perf_counter() if timing else 0.0
            sims_g = np.asarray(dev)
            if timing:
                timing["fetch"] += _time.perf_counter() - t0
            for bi, sims in zip(group, sims_g):
                r0 = bi * _BLOCK
                r1 = min(r0 + _BLOCK, n)
                if bi == bj:
                    s = sims[:r1 - r0, :c1 - c0]
                    stripe[r0:r1] = np.triu(s) + np.triu(s, 1).T
                elif bi < bj:
                    stripe[r0:r1] = sims[:r1 - r0, :c1 - c0]
                else:  # mirrored: computed as (bj, bi) → transpose
                    stripe[r0:r1] = sims[:c1 - c0, :r1 - r0].T
        return stripe

    def stripes():
        # stripe-ahead double buffering: stripe bj−1's device work (and its
        # result transfers) overlap stripe bj's host colorize/PNG time
        done = 0
        pending = dispatch_stripe(num_blocks - 1)
        for bj in range(num_blocks - 1, -1, -1):
            check_aborted()
            current, pending = pending, (
                dispatch_stripe(bj - 1) if bj > 0 else None)
            stripe = collect_stripe(bj, current)
            # stripe columns j = c0..c1−1 → PNG rows y = n−1−j (descending)
            t0 = _time.perf_counter() if timing else 0.0
            flipped = stripe.T[::-1]
            rgb = _pix_to_rgb(flipped, pix[2]) if pix is not None else \
                _colorize(flipped, colors, color_warp, color_ceil, color_inv)
            if timing:
                timing["raster"] += _time.perf_counter() - t0
            done += 1
            progress(done / num_blocks)
            yield rgb

    write_png_rows(path, n, n, stripes(), level=png_level)
    if timing:
        total = _time.perf_counter() - t_start
        png_s = total - sum(timing.values())
        print(f"render timing (extent {n}, level {png_level}): "
              f"total {total:.1f}s = dispatch {timing['dispatch']:.1f}s "
              f"+ fetch-wait {timing['fetch']:.1f}s + raster "
              f"{timing['raster']:.1f}s + png(filter+deflate+io) "
              f"{png_s:.1f}s", file=_sys.stderr)
    return n


class SelfSimilarity(ProcessorFactory):
    """``SelfSimilarity.run(config, observer) -> Processor[None]`` (writes PNG).

    The classvar ``mesh`` (like the reference-shaped ``verbose``) shards
    the gram pair chunks over a ``files`` mesh axis — one stripe's
    row-blocks split across chips, each gathering from its replicated
    window stacks; sims within the plan-invariance budget of the
    single-device engine (the config stays XML-serializable; hardware
    topology is process state, not config).
    """

    name = "self similarity"
    Config = SelfSimilarityConfig
    mesh = None
    #: deflate level for the streaming (giant-extent) path: None = auto
    #: (6, dropping to 1 above ``_FAST_DEFLATE_EXTENT``); set an int to
    #: force a level.  Like ``mesh``/``verbose``: process state, not
    #: config — the XML schema stays reference-compatible.
    png_level = None

    @classmethod
    def _make_body(cls, config: SelfSimilarityConfig):
        cfg = config.build()

        def body(proc: Processor):
            extr1 = ExtractionConfig.from_xml_file(cfg.meta_input)
            extr2 = ExtractionConfig.from_xml_file(cfg.meta_input2) \
                if cfg.meta_input2 else extr1
            if (extr1.fft_size != extr2.fft_size
                    or extr1.fft_overlap != extr2.fft_overlap
                    or extr1.num_coeffs != extr2.num_coeffs):
                raise ValueError("analysis settings of the two inputs differ")
            step = extr1.step_size
            half_win = full_to_feat(cfg.corr_len, step)

            norm = load_norm(cfg.database_folder, extr1.num_coeffs) \
                if cfg.normalize else None

            f1 = read_features(extr1)
            f2 = f1 if extr2.feature_output == extr1.feature_output \
                else read_features(extr2)
            af_frames = min(f1.shape[1], f2.shape[1])

            af_start = max(0, full_to_feat(cfg.span.start, step)) \
                if cfg.span.has_start else 0
            af_stop = min(af_frames, full_to_feat(cfg.span.stop, step)) \
                if cfg.span.has_stop else af_frames
            af_len = af_stop - af_start

            win_len = half_win * 2
            num_corrs = max(0, af_len - win_len + 1)
            if num_corrs > 0x7FFFFFFF:
                raise ValueError("32-bit overflow")

            # reference requires (SelfSimilarityImpl.scala:112-114)
            if not cfg.color_warp > 0:
                raise ValueError(
                    f"Illegal colorWarp setting of {cfg.color_warp}")
            if not cfg.color_ceil > 0:
                raise ValueError(
                    f"Illegal colorCeil setting of {cfg.color_ceil}")
            decim = cfg.decimation
            if decim < 1:
                raise ValueError(f"Illegal decimation setting of {decim}")
            img_ext = num_corrs // decim
            if img_ext > _MAX_EXTENT:
                decim = (num_corrs + _MAX_EXTENT - 1) // _MAX_EXTENT
                print("Warning: Decimation is too small to produce a "
                      f"reasonable image size. Automatically adjusting to {decim}")
                img_ext = num_corrs // decim
            if cls.verbose:
                print(f"Image extent is {img_ext} (yielding a matrix of "
                      f"{img_ext * img_ext} pixels)")
            if img_ext == 0:
                raise ValueError("span too short for the correlation length")

            # normalize both, joint group shift (same constant on both sides
            # keeps correlateHalf exact — see kernels/corr.py)
            xn1 = normalized(f1[:, af_start:af_stop], norm)
            xn2 = xn1 if f2 is f1 else normalized(f2[:, af_start:af_stop], norm)
            joint = xn1 if xn2 is xn1 else np.concatenate([xn1, xn2], axis=1)
            _, sh_t, sh_s = K.shift_per_group(joint)
            def shift(x):
                out = x.copy()
                out[:1] -= np.float32(sh_t)
                out[1:] -= np.float32(sh_s)
                return out
            x1 = shift(xn1)
            x2 = x1 if xn2 is xn1 else shift(xn2)

            if img_ext > _STREAM_EXTENT:
                # giant image: stream column stripes straight into the PNG
                # compressor — never materializes [n, n] or the RGB raster.
                # deflate level: the classvar wins if set; the auto default
                # drops to level 1 only at truly giant extents (6.4 GB of
                # raw scanlines at the 46340 ceiling, where level 6 costs
                # minutes of extra single-threaded deflate for a modestly
                # smaller file) and keeps the standard level 6 for merely
                # stream-sized images; pixels are identical either way
                level = cls.png_level if cls.png_level is not None else (
                    1 if img_ext > _FAST_DEFLATE_EXTENT else 6)
                with proc.sub(0.98):
                    self_similarity_to_png(
                        x1, x2, half_win, decim, cfg.temporal_weight,
                        cfg.image_output, cfg.colors, cfg.color_warp,
                        cfg.color_ceil, cfg.color_inv,
                        check_aborted=proc.check_aborted,
                        progress=proc.set_progress, png_level=level,
                        mesh=cls.mesh)
            else:
                with proc.sub(0.95):
                    rgb = self_similarity_image(
                        x1, x2, half_win, decim, cfg.temporal_weight,
                        cfg.colors, cfg.color_warp, cfg.color_ceil,
                        cfg.color_inv, check_aborted=proc.check_aborted,
                        progress=proc.set_progress, mesh=cls.mesh)
                write_png(cfg.image_output, rgb)
            proc.set_progress(1.0)
            return None

        return body
