"""Device-resident feature database for high-throughput correlation serving.

The reference re-reads every feature file from disk for every search
(FeatureCorrelationImpl.scala:161-246).  The serving model here loads the
database once — normalized, group-shifted, padded and staged in device
memory (optionally sharded over a ``files`` mesh axis) — and answers each
punch query in a handful of chunked dispatches: batched FFT correlation
traces + masked device top-k.  A 10,000-file database of two-minute files
is 5.8 GB of float32 features, staged slab-wise (north star: a 10 s punch
against it in < 1 s, BASELINE.json; query time on the GPU: not measured).
``cache_spectra=True`` keeps each file's forward FFTs resident (~1.8× the
feature memory) so each query pays only its inverse FFTs.

Exact-semantics searches (``FeatureCorrelation``) can still replay their
host-side selection over the returned dense traces; :meth:`query` serves the
common best-matches case entirely on device.

Serving-path divergence: files shorter than the template (or, for
:meth:`query_punch`, shorter than ``min_punch`` + the punch-in template)
have no valid window and are excluded from results.  The reference instead
correlates one zero-tailed window for such files
(FeatureCorrelationImpl.scala:190-246 edge case) — ``FeatureCorrelation``
replicates that quirk; the serving kernels do not.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..analysis.common import feat_to_full
from ..analysis.correlation import InputTemplate
from ..config import ExtractionConfig, Match
from ..kernels import corr as K
from ..span import Span
from .sweep import pad_stack

__all__ = ["FeatureDatabase", "QueryResult", "PunchQueryResult"]

#: Files per query dispatch on a single device: bounds the per-dispatch FFT
#: intermediates (~1 MB HBM per 2-minute file) so 10k-file databases query
#: without OOM; chunks reuse one jit key (the files axis is padded to a
#: multiple at staging).  Mesh-sharded databases split across chips instead.
_QUERY_CHUNK = 2048

#: Files per spectra-cache *staging* dispatch (≤ _QUERY_CHUNK): bounds the
#: complex64 forward-FFT transient while the packed cache fills.
_SPECTRA_CHUNK = 1024


@partial(jax.jit, donate_argnums=(0,))
def _write_slab(buf, slab, offset):
    """Write a prepared slab into a resident buffer in place along the
    leading (files) axis (the buffer is donated, so staging never holds
    two full-size arrays; one jit key — ``offset`` is traced)."""
    idx = (offset,) + (jnp.int32(0),) * (buf.ndim - 1)
    return jax.lax.dynamic_update_slice(buf, slab, idx)


@partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(buf, idx, rows):
    """Donated row scatter for incremental :meth:`FeatureDatabase.add_files`:
    an undonated ``buf.at[idx].set(rows)`` would transiently hold TWO copies
    of a resident multi-GB buffer (2× the database — the same peak the
    donated staging path exists to avoid)."""
    return buf.at[idx].set(rows)


@dataclass
class QueryResult:
    """Top-k hits of one query: parallel arrays ``[num_files, k]``."""

    sims: np.ndarray
    frames: np.ndarray
    files: List[str]
    #: boost factor of each hit window (reference Match.boostIn); ones when
    #: the producing kernel predates boost gathering
    boosts: Optional[np.ndarray] = None
    #: per hit, True where the exact re-rank re-scored it; None when no
    #: re-rank ran (every sim is at the store's own precision)
    exact: Optional[np.ndarray] = None

    def matches(self, punch_len: int, step_size: int, k_total: int = 10,
                num_per_file: Optional[int] = None,
                min_spacing: int = 0) -> List[Match]:
        """Best ``k_total`` :class:`Match`es across files, carrying each
        window's boost (boostOut = 1 as in the reference's punch-in-only
        mode, FeatureCorrelationImpl.scala:236).

        With the defaults (``num_per_file=None``, ``min_spacing=0``) this is
        a plain flat top-k — the serving convenience.  Passing
        ``num_per_file`` (or a ``min_spacing``) switches to the *exact
        replay* of the reference's stateful selection
        (:func:`~strugatzki_tpu.analysis.topk.replay_selection`): candidates
        are offered per file in ascending window order through the same
        entry-queue / spacing-collapse / merge machinery FeatureCorrelation
        uses, so the result equals the full reference search whenever the
        device top-k contains every candidate that selection touches (raise
        the query ``k`` accordingly).  NaN sims (degenerate zero-variance
        windows) are dropped by the finite gate — ``skip_nan=True``
        semantics; the reference's default NaN-first ordering lives on the
        ``FeatureCorrelation`` path (docs/PARITY.md §6)."""
        def mk(i, j):
            t = int(self.frames[i, j])
            return Match(float(self.sims[i, j]), self.files[i],
                         Span(feat_to_full(t, step_size),
                              feat_to_full(t + punch_len, step_size)),
                         float(self.boosts[i, j])
                         if self.boosts is not None else 1.0, 1.0)

        if num_per_file is None and min_spacing == 0:
            flat = [(float(self.sims[i, j]), i, j)
                    for i in range(self.sims.shape[0])
                    for j in range(self.sims.shape[1])
                    if np.isfinite(self.sims[i, j])]
            flat.sort(key=lambda t: -t[0])
            return [mk(i, j) for _, i, j in flat[:k_total]]

        from ..analysis.topk import replay_selection
        per_file = []
        for i in range(self.sims.shape[0]):
            cands = [mk(i, j) for j in range(self.sims.shape[1])
                     if np.isfinite(self.sims[i, j])]
            cands.sort(key=lambda m: m.punch.start)
            per_file.append(cands)
        return replay_selection(per_file, k_total,
                                num_per_file if num_per_file is not None
                                else k_total, min_spacing)


@dataclass
class PunchQueryResult:
    """Top-k punch-in × punch-out hits: parallel arrays ``[num_files, k]``.

    ``frames``: punch-in window start (feature frames); ``punch_lens``:
    matched punch length − ``min_punch`` (feature frames); ``boosts_in`` /
    ``boosts_out``: the two boost factors of the reference's Match.
    """

    sims: np.ndarray
    frames: np.ndarray
    punch_lens: np.ndarray
    boosts_in: np.ndarray
    boosts_out: np.ndarray
    files: List[str]
    min_punch: int
    #: punch-in-only sim per candidate — drives the reference's
    #: ``inSim > low²`` scan gate in the exact selection replay
    #: (FeatureCorrelationImpl.scala:342); None for legacy producers
    in_sims: Optional[np.ndarray] = None
    #: per hit, True where the exact re-rank re-scored it (see
    #: :attr:`QueryResult.exact`)
    exact: Optional[np.ndarray] = None

    def matches(self, step_size: int, k_total: int = 10,
                num_per_file: Optional[int] = None,
                min_spacing: int = 0) -> List[Match]:
        """Best ``k_total`` :class:`Match`es across files with the
        reference's span convention ``[start, start + minPunch + k)``
        (FeatureCorrelationImpl.scala:370-374).

        With the defaults (``num_per_file=None``, ``min_spacing=0``) this
        is a plain flat top-k — the serving convenience.  Passing
        ``num_per_file`` (or a ``min_spacing``) runs the *exact replay* of
        the reference's stateful selection
        (:func:`~strugatzki_tpu.analysis.topk.replay_selection`) over the
        returned candidates, offered per file in ascending punch-in-offset
        order exactly like FeatureCorrelationImpl's combine pass — so the
        result equals the full reference search whenever the device top-k
        contains every candidate that selection touches (raise the query
        ``k`` when ``k_total·num_per_file`` approaches it).  The kernel
        already keeps only the best punch length per offset, which is what
        the reference's always-on overlap collapse reduces same-offset
        candidates to.  NaN sims are dropped by the finite gate
        (``skip_nan=True`` semantics — docs/PARITY.md §6)."""
        def mk(i, j):
            t = int(self.frames[i, j])
            kl = int(self.punch_lens[i, j])
            return Match(float(self.sims[i, j]), self.files[i],
                         Span(feat_to_full(t, step_size),
                              feat_to_full(t + self.min_punch + kl,
                                           step_size)),
                         float(self.boosts_in[i, j]),
                         float(self.boosts_out[i, j]))

        if num_per_file is None and min_spacing == 0:
            flat = [(float(self.sims[i, j]), i, j)
                    for i in range(self.sims.shape[0])
                    for j in range(self.sims.shape[1])
                    if np.isfinite(self.sims[i, j])]
            flat.sort(key=lambda t: -t[0])
            return [mk(i, j) for _, i, j in flat[:k_total]]

        from ..analysis.topk import _Candidate, replay_selection
        per_file = []
        for i in range(self.sims.shape[0]):
            cands = [_Candidate(mk(i, j),
                                None if self.in_sims is None
                                else float(self.in_sims[i, j]))
                     for j in range(self.sims.shape[1])
                     if np.isfinite(self.sims[i, j])]
            cands.sort(key=lambda c: c.punch.start)
            per_file.append(cands)
        kept = replay_selection(per_file, k_total,
                                num_per_file if num_per_file is not None
                                else k_total, min_spacing)
        return [c.match for c in kept]


def _multi_query_from_spectra(spectra, xs_b, t_padded, lens, tmpl_t, tmpl_s,
                              a_std_t, a_std_s, ln_avg, shifts_t,
                              temp_weight, max_boost,
                              num_temporal: int = 1, k: int = 4,
                              shards: int = 1):
    """Shared body of the batched query kernels: vmap templates outer,
    files inner, the files axis chunked to the hardware-validated batch
    (:data:`_VALIDATED_QB_BATCH`, the guard against a backend fault in
    the fused Q×B trace program; see the constant's definition).  ``spectra`` is the
    cache tuple (see :func:`_unpack_if_reduced`); the reduced→
    complex upcast happens INSIDE the per-file fn so the chunked
    ``lax.map`` carries bf16 operands, not a materialized full-database
    complex64 copy.  ``xs_b`` feeds the reduced path's on-the-fly
    window-sum tables (unused — and DCE'd — on the complex64 path).
    Returns ``(vals, idx, boosts)``, each ``[Q, B, k]``."""
    n_queries = tmpl_t.shape[0]

    def one_query(tt, ts, st_t, st_s, la):
        def one_file(*args):
            *sp, xs_row, shift_t = args
            X, aux, use_sums = _unpack_if_reduced(tuple(sp), xs_row,
                                                  num_temporal)
            return _trace_any(
                X, aux, use_sums, t_padded, tt, ts, st_t, st_s, la,
                shift_t, temp_weight, max_boost, num_temporal=num_temporal)

        sims, boosts = _chunked_files_vmap(
            one_file, tuple(spectra) + (xs_b, shifts_t), n_queries,
            shards=shards)                                      # [B, W]
        return _topk_epilogue(sims, boosts, lens, tt.shape[1], k)

    return jax.vmap(one_query)(tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg)


@partial(jax.jit, static_argnames=("num_temporal", "k", "shards"))
def _multi_query_kernel(xs_b, lens, tmpl_t, tmpl_s, a_std_t, a_std_s,
                        ln_avg, shifts_t, temp_weight, max_boost,
                        num_temporal: int = 1, k: int = 4,
                        shards: int = 1):
    """Q templates × B files in one dispatch; the per-file forward spectra
    are computed once (one files-vmap pass) and shared by every template.
    Returns ``(vals, idx, boosts)``, each ``[Q, B, k]``.  Files with no
    valid window (shorter than the template) are masked out — see the
    module docstring's serving-path divergence note."""
    X_b, Xsq_b = jax.vmap(partial(K.trace_spectra,
                                  num_temporal=num_temporal))(xs_b)
    return _multi_query_from_spectra(
        (X_b, Xsq_b), xs_b, xs_b.shape[2], lens, tmpl_t, tmpl_s, a_std_t,
        a_std_s, ln_avg, shifts_t, temp_weight, max_boost,
        num_temporal=num_temporal, k=k, shards=shards)


def _topk_epilogue(sims, boosts, lens, L: int, k: int):
    """Shared kernel tail: mask windows beyond ``lens − L + 1`` (which also
    silences zero-length tombstoned/padding rows) to −inf, take the
    per-file top-k, gather each hit's boost.  ``sims``/``boosts``:
    ``[B, ..., W]``; ``lens``: ``[B]``."""
    w_valid = (lens - (L - 1)).reshape(lens.shape + (1,) * (sims.ndim - 1))
    t_idx = jnp.arange(sims.shape[-1])
    masked = jnp.where(t_idx < w_valid, sims, -jnp.inf)
    vals, idx = jax.lax.top_k(masked, k)
    return vals, idx, jnp.take_along_axis(boosts, idx, axis=-1)


#: Largest fused (queries × files-chunk) batch the batched trace kernels
#: hand the backend in one vmap level.  It guards against a compiler fault
#: seen on the former accelerator, where the fused Q×B trace program
#: returned deflated sims for planted exact matches at some Q·B ≥ 2048
#: (docs/PARITY.md).  The planted-match canary (parallel/canary.py, run at
#: the 10k size by chip_smoke.py) decides on the GPU whether it is needed.
_VALIDATED_QB_BATCH = 1024

#: Per-dispatch cap on the queries axis of the batched kernels.  This is
#: compile-cost POLICY, not the correctness bound: files-chunking alone
#: keeps a fused step within :data:`_VALIDATED_QB_BATCH` up to Q = 1024
#: (query) / 512 (punch) — only beyond that does the chunk floor at one
#: file.  But Q is a jit-key shape dimension and every key is a fresh
#: compile, so oversized same-shape buckets split into
#: ≤64-query sub-dispatches, each ragged tail padded up to a power of
#: two by repeating the last query: possible Q keys are exactly
#: {1, 2, 4, 8, 16, 32, 64} per shape bucket.  Tradeoff, accepted: in
#: the non-cached-spectra mode each sub-dispatch recomputes the database
#: chunk's forward FFTs (Q > 64 same-shape batches are far beyond the
#: reference's one-query-per-run usage; `cache_spectra` removes the
#: recompute entirely).
_MAX_BATCH_QUERIES = 64


def _split_buckets(buckets: dict):
    """Yield each shape bucket's index list in sorted-key order, oversized
    buckets split into :data:`_MAX_BATCH_QUERIES`-sized sub-dispatches and
    every ragged tail padded to a power-of-two length by repeating its
    last index (the duplicate lane recomputes the same query on device;
    callers skip result slots already filled, so the host epilogue — in
    particular the exact re-rank — runs once per distinct query)."""
    for key, idxs in sorted(buckets.items()):
        for i0 in range(0, len(idxs), _MAX_BATCH_QUERIES):
            sub = idxs[i0:i0 + _MAX_BATCH_QUERIES]
            q = 1 << (len(sub) - 1).bit_length()    # next power of two
            yield key, sub + [sub[-1]] * (q - len(sub))


def _files_chunk(lanes_per_file: int, shards: int = 1) -> int:
    """Files-axis chunk size (a power of two) keeping every fused step at
    ≤ :data:`_VALIDATED_QB_BATCH` trace lanes PER CHIP.  Deliberately
    independent of ``shards`` — see :func:`_chunked_files_vmap`'s
    docstring for the GSPMD-tiling evidence that made the shard-scaled
    budget unsafe (tests pin this equality)."""
    del shards
    bc = max(1, _VALIDATED_QB_BATCH // max(1, lanes_per_file))
    return 1 << (bc.bit_length() - 1)        # round down to a power of two


def _chunked_files_vmap(fn, mapped, lanes_per_file: int, shards: int = 1):
    """``jax.vmap(fn)`` over the leading files axis of every leaf in
    ``mapped`` (a tuple pytree), chunking the axis with ``lax.map`` so the
    fused trace batch per step (``lanes_per_file × files-chunk``) stays
    within :data:`_VALIDATED_QB_BATCH`.  ``lanes_per_file`` counts the
    trace lanes each file contributes per step: callers invoke this inside
    their queries-axis vmap, so it is Q for the single-trace query kernel
    and 2·Q for the punch kernel (punch-in AND punch-out traces share each
    step — chunking punch at Q·Bc ≤ 1024 still diverged on hardware at
    [512 × 8] because the fused step held 2·Q·Bc = 2048 trace lanes, the
    same failing regime; halving the chunk fixed it).

    When the whole batch fits this IS ``jax.vmap(fn)(*mapped)`` —
    identical HLO, so small dispatches keep their existing compiled
    programs.  Chunks are a power of two (divides the shape-plan padded
    batches evenly); a ragged tail is zero-padded and the pad rows sliced
    off the outputs (callers mask padded files via ``lens`` anyway).

    ``shards``: under a mesh the files axis is sharded and the whole
    (global) axis arrives in one call.  The budget is NOT scaled by the
    shard count: an earlier round scaled it (``bc·shards``) assuming
    GSPMD would split each step's ``bc``-row slice evenly over the mesh,
    but inspecting the partitioned program (round 5, virtual 8-device
    mesh) showed GSPMD tiles the ``(nc, bc)`` reshape TWO-dimensionally
    — e.g. ``[2, 4]`` over 8 devices — putting ``bc/4`` files on a chip
    per fused step; at the scaled budget that is ``2·_VALIDATED_QB_BATCH
    = 2048`` trace lanes, exactly the silently-deflating power-of-two
    regime the chunking exists to avoid (round-4 advisor finding).  With
    the unscaled budget every chip sees at most the global ``bc`` rows
    per step under ANY partitioning choice (replication included), so
    the per-chip lane count is ≤ the validated budget by construction.
    Cost: ``shards×`` more (proportionally smaller) chunk steps in the
    mesh+chunked case — which today arises only on virtual-CPU meshes;
    a real multi-chip deployment can restore the scaled budget behind a
    planted-match hardware validation (tools/batch_canary.py --mesh N).
    The argument is retained for that calibration and for jit-key
    compatibility."""
    leaves = jax.tree_util.tree_leaves(mapped)
    B = leaves[0].shape[0]
    bc = _files_chunk(lanes_per_file, shards)
    if bc >= B:
        return jax.vmap(fn)(*mapped)
    nc = -(-B // bc)
    pad = nc * bc - B

    def pad_reshape(a):
        if pad:
            a = jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        return a.reshape((nc, bc) + a.shape[1:])

    stacked = jax.tree_util.tree_map(pad_reshape, mapped)
    out = jax.lax.map(lambda ch: jax.vmap(fn)(*ch), stacked)
    return jax.tree_util.tree_map(
        lambda o: o.reshape((nc * bc,) + o.shape[2:])[:B], out)


def _unpack_if_reduced(spectra, xs_row, num_temporal: int):
    """Per-file spectra cache entry → ``(X, aux, use_sums)``.

    Two layouts (distinguished by dtype, a trace-time constant):

    * ``(X, Xsq)`` complex64 — full-precision cache, FFT window sums
      (``use_sums=False``, ``aux=Xsq``).
    * ``(X_re, X_im)`` PLANAR reduced arrays — rebuilt inside the jit
      where the upcast fuses into the first consumer.  (Planar, not a
      trailing ``[..., 2]`` stack: consumers would read stride-2
      through a 2-wide minor axis — see kernels.corr.pack_spectra.)
      ``aux`` is then a float32 :func:`kernels.corr.window_sum_table`
      computed ON THE FLY from the file's resident f32 feature row:
      window statistics become two static prefix-table slices instead
      of 4 irffts per (file, template) — the 2-irfft trace serving the
      10k compact path.  The table is NOT stored (a stored [4, Tp+1]
      f32 table costs ~1.7 GiB at 10k files); recomputing is a per-file
      cumsum over data already in device memory, and because it carries no queries-axis dependence the
      batched kernels' queries-vmap computes it ONCE per file, shared
      by every template (vmap semantics: unbatched operands stay
      unbatched).
    """
    if jnp.iscomplexobj(spectra[0]):
        return spectra[0], spectra[1], False
    X = K.unpack_spectra(*spectra)
    return X, K.window_sum_table(xs_row, num_temporal), True


def _trace_any(X, aux, use_sums: bool, t_padded, *args, **kw):
    """Dispatch to the sums-based or FFT-based trace (see
    :func:`_unpack_if_reduced`; ``use_sums`` is a trace-time constant)."""
    fn = (K.correlation_trace_from_sums if use_sums
          else K.correlation_trace_from_spectra)
    return fn(X, aux, t_padded, *args, **kw)


@partial(jax.jit, static_argnames=("t_padded", "num_temporal", "k",
                                   "shards"))
def _multi_query_kernel_spectra(spectra, xs_b, t_padded, lens, tmpl_t,
                                tmpl_s, a_std_t, a_std_s, ln_avg, shifts_t,
                                temp_weight, max_boost,
                                num_temporal: int = 1, k: int = 4,
                                shards: int = 1):
    """:func:`_multi_query_kernel` continued from cached spectra."""
    return _multi_query_from_spectra(
        spectra, xs_b, t_padded, lens, tmpl_t, tmpl_s, a_std_t, a_std_s,
        ln_avg, shifts_t, temp_weight, max_boost,
        num_temporal=num_temporal, k=k, shards=shards)


@partial(jax.jit, static_argnames=("num_temporal", "pack_dtype"))
def _spectra_kernel(xs_b, num_temporal: int = 1, pack_dtype: str = ""):
    """Per-file forward spectra of the whole database (the shared half of
    every trace) — cached resident when ``cache_spectra`` is set.  With a
    ``pack_dtype`` (e.g. ``"bfloat16"``) only the forward spectra are
    cached, as reduced planar (re, im) pairs — half the cache, the mode
    with the smallest spectra cache; the ``Xsq`` window-sum spectra are
    replaced by on-the-fly window-sum tables from the resident f32
    features (see :func:`_unpack_if_reduced`)."""
    if pack_dtype:
        dt = jnp.dtype(pack_dtype)
        X = jax.vmap(K.forward_spectra)(xs_b)
        return K.pack_spectra(X, dt)
    X, Xsq = jax.vmap(partial(K.trace_spectra,
                              num_temporal=num_temporal))(xs_b)
    return X, Xsq


@partial(jax.jit, static_argnames=("t_padded", "num_temporal", "k"))
def _query_kernel_spectra(spectra, xs_b, t_padded, lens, tmpl_t, tmpl_s,
                          a_std_t, a_std_s, ln_avg, shifts_t, temp_weight,
                          max_boost, num_temporal: int = 1, k: int = 4):
    """:func:`_query_kernel` continued from cached spectra: a query costs
    only its template-dot inverse FFTs per file.  Files are chunked like
    the batched kernels (``_chunked_files_vmap``) so the reduced→complex
    upcast and the irfft workspaces peak at one 1024-file step, not the
    whole 2048-file dispatch."""
    def one_file(*args):
        *sp, xs_row, shift_t = args
        X, aux, use_sums = _unpack_if_reduced(tuple(sp), xs_row,
                                              num_temporal)
        return _trace_any(
            X, aux, use_sums, t_padded, tmpl_t, tmpl_s, a_std_t, a_std_s,
            ln_avg, shift_t, temp_weight, max_boost,
            num_temporal=num_temporal)

    sims, boosts = _chunked_files_vmap(
        one_file, tuple(spectra) + (xs_b, shifts_t), 1)
    vals, idx, boosts_k = _topk_epilogue(sims, boosts, lens,
                                         tmpl_t.shape[1], k)
    return vals, idx, boosts_k, sims, boosts


@partial(jax.jit, static_argnames=("num_temporal", "k"))
def _query_kernel(xs_b, lens, tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg,
                  shifts_t, temp_weight, max_boost,
                  num_temporal: int = 1, k: int = 4):
    def one(xs, shift_t):
        return K.correlation_trace(
            xs, tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg, shift_t,
            temp_weight, max_boost, num_temporal=num_temporal)

    sims, boosts = jax.vmap(one)(xs_b, shifts_t)
    vals, idx, boosts_k = _topk_epilogue(sims, boosts, lens,
                                         tmpl_t.shape[1], k)
    return vals, idx, boosts_k, sims, boosts


@partial(jax.jit, static_argnames=("num_temporal", "k"))
def _punch_query_kernel(xs_b, lens,
                        in_t, in_s, in_std_t, in_std_s, in_ln,
                        out_t, out_s, out_std_t, out_std_s, out_ln,
                        shifts_t, tw_in, tw_out, max_boost,
                        min_punch, scan_span,
                        num_temporal: int = 1, k: int = 4):
    """Full punch-in × punch-out combine on device, one dispatch.

    Per file: both sliding traces (reference hot loops 1+2,
    FeatureCorrelationImpl.scala:190-246, :281-315), then the banded
    combine over punch lengths ``minPunch..maxPunch`` (hot loop 3,
    :325-389): candidate (t, j) pairs a punch-in window at ``t`` with a
    punch-out window at ``t + minPunch + j``, scored
    ``√(inSim·outSim)`` (:370).  For each ``t`` the best length is kept
    (a running max over the band — no ``[W, S]`` materialization), then a
    masked top-k over ``t``.  Candidates with ``inSim ≤ 0`` are excluded,
    matching the reference's ``inSim > low²`` gate with ``low ≥ 0``
    (:342); negative products (the reference's NaN-√ poisoning) are
    excluded rather than replayed — exact-quirk searches go through
    ``FeatureCorrelation``.

    Deliberate divergence from the reference's *stateful* search: the
    reference only opens a file's punch-in trace when some in-similarity
    alone exceeds the current lowest kept match (``tInOpen ||
    entryHasSpace || sim > lowestSim``, FeatureCorrelationImpl.scala:213)
    — an order-dependent pruning that can silently drop a better
    ``√(inSim·outSim)`` candidate whose in-sim is below that bar.  This
    kernel searches the full candidate space (a superset; validated
    against the exact replay whenever the pruning is inert).  Use
    ``FeatureCorrelation`` for faithful stateful selection.

    ``min_punch``/``scan_span`` are traced (no jit key per punch config).
    Returns per-file ``(sims, t_idx, punch_len_k, boost_in, boost_out,
    in_sims)``, each ``[B, k]``.
    """
    def one(xs, shift_t, t_len):
        # forward spectra once per file, shared by both punch templates
        X, Xsq = K.trace_spectra(xs, num_temporal=num_temporal)
        return _punch_one_from_spectra(
            X, Xsq, False, xs_b.shape[2], in_t, in_s, in_std_t, in_std_s,
            in_ln, out_t, out_s, out_std_t, out_std_s, out_ln, shift_t,
            tw_in, tw_out, max_boost, min_punch, scan_span, t_len,
            num_temporal=num_temporal, k=k)

    return jax.vmap(one)(xs_b, shifts_t, lens)


@partial(jax.jit, static_argnames=("t_padded", "num_temporal", "k"))
def _punch_query_kernel_spectra(spectra, xs_b, t_padded, lens,
                                in_t, in_s, in_std_t, in_std_s, in_ln,
                                out_t, out_s, out_std_t, out_std_s, out_ln,
                                shifts_t, tw_in, tw_out, max_boost,
                                min_punch, scan_span,
                                num_temporal: int = 1, k: int = 4):
    """:func:`_punch_query_kernel` continued from cached spectra; files
    chunked at 2 trace lanes per file (in + out) like the batched punch —
    see :func:`_query_kernel_spectra` for the peak-memory rationale."""
    def one_file(*args):
        *sp, xs_row, shift_t, t_len = args
        X, aux, use_sums = _unpack_if_reduced(tuple(sp), xs_row,
                                              num_temporal)
        return _punch_one_from_spectra(
            X, aux, use_sums, t_padded, in_t, in_s, in_std_t, in_std_s,
            in_ln, out_t, out_s, out_std_t, out_std_s, out_ln, shift_t,
            tw_in, tw_out, max_boost, min_punch, scan_span, t_len,
            num_temporal=num_temporal, k=k)

    return _chunked_files_vmap(
        one_file, tuple(spectra) + (xs_b, shifts_t, lens), 2)


def _punch_one_from_spectra(X, aux, use_sums, t_padded,
                            in_t, in_s, in_std_t, in_std_s, in_ln,
                            out_t, out_s, out_std_t, out_std_s, out_ln,
                            shift_t, tw_in, tw_out, max_boost,
                            min_punch, scan_span, t_len,
                            num_temporal: int = 1, k: int = 4):
    """One file's punch-in × punch-out combine (see _punch_query_kernel).
    ``aux``/``use_sums`` as in :func:`_unpack_if_reduced` — on the sums
    path the window-sum table is shared by BOTH punch templates, so the
    pair costs 4 irffts per file instead of 12."""
    L_in = in_t.shape[1]
    L_out = out_t.shape[1]
    Tp = t_padded
    W_in = Tp - L_in + 1
    W_out = Tp - L_out + 1
    sims_in, boosts_in = _trace_any(
        X, aux, use_sums, Tp, in_t, in_s, in_std_t, in_std_s, in_ln,
        shift_t, tw_in, max_boost, num_temporal=num_temporal)
    sims_out, boosts_out = _trace_any(
        X, aux, use_sums, Tp, out_t, out_s, out_std_t, out_std_s, out_ln,
        shift_t, tw_out, max_boost, num_temporal=num_temporal)

    # validity: punch-in scan runs over len − minPunch frames (:183);
    # punch-out windows must fit the file
    t_ix = jnp.arange(W_in)
    w_in_valid = t_len - min_punch - (L_in - 1)
    in_valid = (t_ix < w_in_valid) & (sims_in > 0.0)
    o_ix = jnp.arange(W_out)
    out_ok = o_ix < (t_len - (L_out - 1))
    # pad the out trace so every banded read is in range
    pad = W_in + Tp - W_out
    out_vals = jnp.concatenate(
        [jnp.where(out_ok, sims_out, -jnp.inf),
         jnp.full((pad,), -jnp.inf, sims_out.dtype)])
    out_boosts_p = jnp.concatenate(
        [boosts_out, jnp.ones((pad,), boosts_out.dtype)])
    w_pad = out_vals.shape[0]

    # banded combine: candidates gate on inSim > 0 (:342 with low ≥ 0),
    # so argmax_j inSim·outSim[t+minPunch+j] = argmax_j outSim over the
    # band — a sliding-window maximum.  Computed sparse-table style:
    # doubling (max, earliest-argmax) passes M_p for p = 1, 2, 4, …, then
    # width-S max at offset o is the max of the two overlapping power
    # blocks M_p[o] and M_p[o+S−p], p = 2^⌊log2 S⌋ — O(log S) elementwise
    # passes instead of S sequential steps (ties keep the earliest j,
    # exactly like the reference's strict-> scan).  Only the selected
    # level is carried (a fori_loop over the ⌊log2 S⌋ doublings) so the
    # vmapped kernel holds O(w_pad) per file, not O(w_pad·log) — a 10k-file
    # punch query stays well inside HBM.
    n_levels = max(1, int(np.ceil(np.log2(w_pad))) + 1)
    # exact integer ⌊log2 S⌋ (float log2 can misround at powers of two)
    j_sel = 31 - jax.lax.clz(jnp.maximum(scan_span, 1).astype(jnp.int32))
    j_sel = jnp.clip(j_sel, 0, n_levels - 1)
    p = jnp.left_shift(jnp.int32(1), j_sel)

    neg_pad = jnp.full((w_pad,), -jnp.inf, out_vals.dtype)
    zero_pad = jnp.zeros((w_pad,), jnp.int32)

    def double(j, carry):
        v, a = carry
        sh = jnp.left_shift(jnp.int32(1), j)
        v2 = jax.lax.dynamic_slice(
            jnp.concatenate([v, neg_pad]), (sh,), (w_pad,))
        a2 = jax.lax.dynamic_slice(
            jnp.concatenate([a, zero_pad]), (sh,), (w_pad,))
        take = v2 > v
        return jnp.where(take, v2, v), jnp.where(take, a2, a)

    lv, la = jax.lax.fori_loop(
        0, j_sel, double, (out_vals, jnp.arange(w_pad, dtype=jnp.int32)))
    # block 1 at offset min_punch, block 2 at min_punch + scan_span − p
    v1 = jax.lax.dynamic_slice(lv, (min_punch,), (W_in,))
    a1 = jax.lax.dynamic_slice(la, (min_punch,), (W_in,))
    off2 = min_punch + scan_span - p
    v2 = jax.lax.dynamic_slice(lv, (off2,), (W_in,))
    a2 = jax.lax.dynamic_slice(la, (off2,), (W_in,))
    take2 = v2 > v1
    out_best = jnp.where(take2, v2, v1)
    o_best = jnp.where(take2, a2, a1)           # absolute out index
    best_j = (o_best - min_punch - t_ix).astype(jnp.int32)

    best = jnp.where(in_valid & (out_best > -jnp.inf),
                     sims_in * out_best, -jnp.inf)
    band_sim = jnp.where(best > 0.0, jnp.sqrt(jnp.maximum(best, 0.0)),
                         -jnp.inf)
    vals, t_idx = jax.lax.top_k(band_sim, k)
    j_k = best_j[t_idx]
    b_in = boosts_in[t_idx]
    b_out = out_boosts_p[t_idx + min_punch + j_k]
    # each candidate's punch-in-only sim: the exact selection replay needs
    # it for the reference's ``inSim > low²`` scan gate (:342)
    si = sims_in[t_idx]
    return vals, t_idx, j_k, b_in, b_out, si


def _multi_punch_from_spectra(spectra, xs_b, t_padded, lens,
                              in_t, in_s, in_std_t, in_std_s, in_ln,
                              out_t, out_s, out_std_t, out_std_s, out_ln,
                              shifts_t, tw_in, tw_out, max_boost,
                              min_punch, scan_span,
                              num_temporal: int = 1, k: int = 4,
                              shards: int = 1):
    """Shared body of the batched punch kernels: vmap pairs outer, files
    inner, the files axis chunked to the hardware-validated batch
    (:data:`_VALIDATED_QB_BATCH`), returning ``[Q, B, k]`` outputs
    directly.

    The chunking guards correctness, not memory (see
    :data:`_VALIDATED_QB_BATCH`; the canary decides whether the GPU needs
    it).
    """
    n_pairs = in_t.shape[0]

    def one_pair(it, is_, ist, iss, iln, ot, os_, ost, oss, oln, mp, ss):
        def one_file(*args):
            *sp, xs_row, shift_t, t_len = args
            X, aux, use_sums = _unpack_if_reduced(tuple(sp), xs_row,
                                                  num_temporal)
            return _punch_one_from_spectra(
                X, aux, use_sums, t_padded, it, is_, ist, iss, iln,
                ot, os_, ost, oss, oln, shift_t, tw_in, tw_out, max_boost,
                mp, ss, t_len, num_temporal=num_temporal, k=k)

        # 2 lanes per (pair, file): the punch-in and punch-out traces
        return _chunked_files_vmap(
            one_file, tuple(spectra) + (xs_b, shifts_t, lens), 2 * n_pairs,
            shards=shards)

    return jax.vmap(one_pair)(in_t, in_s, in_std_t, in_std_s, in_ln,
                              out_t, out_s, out_std_t, out_std_s,
                              out_ln, min_punch, scan_span)


@partial(jax.jit, static_argnames=("num_temporal", "k", "shards"))
def _multi_punch_kernel(xs_b, lens,
                        in_t, in_s, in_std_t, in_std_s, in_ln,
                        out_t, out_s, out_std_t, out_std_s, out_ln,
                        shifts_t, tw_in, tw_out, max_boost,
                        min_punch, scan_span,
                        num_temporal: int = 1, k: int = 4,
                        shards: int = 1):
    """Q punch pairs × B files in one dispatch: the per-file forward
    spectra — the expensive shared half of every punch search — are
    computed ONCE (one files-vmap pass) and reused by every
    (punch-in, punch-out) pair.  ``min_punch``/``scan_span`` are per-pair
    ``[Q]`` vectors (traced — no jit key per punch band).  Returns the
    per-pair tuple of :func:`_punch_query_kernel` outputs, each
    ``[Q, B, k]``.

    Match: FeatureCorrelationImpl.scala:325-389 (one sequential search per
    query there; a Q-query stream re-reads the whole database Q times).
    """
    X_b, Xsq_b = jax.vmap(partial(K.trace_spectra,
                                  num_temporal=num_temporal))(xs_b)
    return _multi_punch_from_spectra(
        (X_b, Xsq_b), xs_b, xs_b.shape[2], lens,
        in_t, in_s, in_std_t, in_std_s, in_ln,
        out_t, out_s, out_std_t, out_std_s, out_ln,
        shifts_t, tw_in, tw_out, max_boost, min_punch, scan_span,
        num_temporal=num_temporal, k=k, shards=shards)


@partial(jax.jit, static_argnames=("t_padded", "num_temporal", "k",
                                   "shards"))
def _multi_punch_kernel_spectra(spectra, xs_b, t_padded, lens,
                                in_t, in_s, in_std_t, in_std_s, in_ln,
                                out_t, out_s, out_std_t, out_std_s, out_ln,
                                shifts_t, tw_in, tw_out, max_boost,
                                min_punch, scan_span,
                                num_temporal: int = 1, k: int = 4,
                                shards: int = 1):
    """:func:`_multi_punch_kernel` continued from cached spectra."""
    return _multi_punch_from_spectra(
        spectra, xs_b, t_padded, lens,
        in_t, in_s, in_std_t, in_std_s, in_ln,
        out_t, out_s, out_std_t, out_std_s, out_ln,
        shifts_t, tw_in, tw_out, max_boost, min_punch, scan_span,
        num_temporal=num_temporal, k=k, shards=shards)


def _drop_memmap_pages(raw) -> None:
    """Best-effort MADV_DONTNEED on a memmap raw store: staging reads walk
    the whole mapping once, and without this the touched file-backed pages
    stay resident (ru_maxrss ≈ the full stack — exactly what the memmap
    store exists to avoid).  No-op for in-memory stores; reads after the
    drop simply fault pages back in."""
    if isinstance(raw, np.memmap):
        try:
            import mmap as _mmap
            raw._mmap.madvise(_mmap.MADV_DONTNEED)
        except (AttributeError, OSError, ValueError):
            pass


def _stack_memmap(entries, pad_multiple: int, time_capacity,
                  pad_rows_of, check_aborted=lambda: None):
    """Stream ``(name, [C, T])`` entries into an UNLINKED temp-file memmap
    ``[B, C, t_cap]`` — host RSS stays O(one row) instead of holding a
    second full copy of the database for the life of the process (~5.8 GB
    at the 10k scale).  ``entries`` may be a one-shot
    iterator when ``time_capacity`` (max frames, rounded up to
    ``pad_multiple``) is given; a sequence needs no capacity.  Returns
    ``(memmap, lens, names)`` with the files-axis padding rows
    (``pad_rows_of(count)``) already appended as zeros."""
    import os
    import tempfile

    if time_capacity is None:
        entries = list(entries)
        if not entries:
            raise ValueError("empty database")
        time_capacity = max(np.asarray(f).shape[1] for _, f in entries)
    t_cap = -(-int(time_capacity) // pad_multiple) * pad_multiple
    fd, tmp_path = tempfile.mkstemp(suffix=".strugdb")
    names, lens = [], []
    C = None
    try:
        with os.fdopen(fd, "wb") as fh:
            row = None
            for name, feat in entries:
                check_aborted()
                a = np.asarray(feat, np.float32)
                if C is None:
                    C = a.shape[0]
                    row = np.zeros((C, t_cap), np.float32)
                if a.shape[0] != C:
                    raise ValueError(
                        f"channel count mismatch ({a.shape[0]} vs {C})")
                if a.shape[1] > t_cap:
                    raise ValueError(
                        f"{name!r} has {a.shape[1]} frames > capacity "
                        f"{t_cap}")
                row[:] = 0.0
                row[:, :a.shape[1]] = a
                row.tofile(fh)
                names.append(name)
                lens.append(a.shape[1])
            if C is None:
                raise ValueError("empty database")
            pad = pad_rows_of(len(names))
            row[:] = 0.0
            for _ in range(pad):
                row.tofile(fh)
        raw = np.memmap(tmp_path, dtype=np.float32, mode="r+",
                        shape=(len(names) + pad, C, t_cap))
    finally:
        # unlink immediately: the mapping keeps the inode alive (POSIX),
        # and the backing file vanishes with the last reference
        os.unlink(tmp_path)
    return raw, np.asarray(lens + [0] * pad, np.int32), names


def _pad_rows_of(count: int, mesh) -> int:
    """Files-axis padding (zero rows, lens 0 — masked everywhere): to a
    _QUERY_CHUNK multiple when chunked dispatch will be needed, or to a
    mesh-size multiple so the sharded files axis divides evenly.
    Idempotent: a count that is already padded pads by 0, so a
    pre-padded ``_prestacked`` store (the streamed :meth:`load` path)
    passes through the constructor unchanged."""
    if mesh is None and count > _QUERY_CHUNK:
        return -count % _QUERY_CHUNK
    if mesh is not None:
        return -count % mesh.devices.size
    return 0


def _rerank_bucket(m: int) -> int:
    """Pad the re-rank candidate count to power-of-two buckets (min 64) so
    repeated queries reuse one jit key per (bucket, template length)."""
    b = 64
    while b < m:
        b <<= 1
    return b


def _rerank_window_math(xs_b, shifts_t, file_idx, frames, tmpl_t, tmpl_s,
                        a_std_t, a_std_s, ln_avg, temp_weight, max_boost,
                        num_temporal: int = 1):
    """Body of :func:`_rerank_window_kernel` (unjitted so the mesh path
    can reuse it inside a ``shard_map`` — :func:`_sharded_rerank_fn`)."""
    nt = num_temporal
    L = tmpl_t.shape[1]
    C = xs_b.shape[1]

    # window gather as dynamic_slices of M contiguous [C, L] windows,
    # STACKED THROUGH A lax.scan.  Two rejected forms:
    #  * advanced-indexing gather (index arrays broadcast to [M, C, L])
    #    lowers to a pointwise slice_sizes=(1,1,1) gather over M·C·L
    #    elements, far slower than the slice form;
    #  * jax.vmap(dynamic_slice) FUSED into the consuming reductions
    #    returned silently wrong sims on the former accelerator's compiler
    #    (docs/PARITY.md).  The scan's stacked output is a real
    #    materialization the compiler cannot fuse away; the device
    #    re-score checks of chip_smoke.py decide on the GPU whether that
    #    guard is still needed.
    def one_window(carry, it):
        i, t = it
        return carry, jax.lax.dynamic_slice(xs_b, (i, 0, t), (1, C, L))[0]

    _, win = jax.lax.scan(one_window, 0, (file_idx, frames))
    win = win.astype(jnp.float32)

    def group(rows, tmpl, a_std, n_cells):
        s = rows.sum(axis=(1, 2))
        q = (rows * rows).sum(axis=(1, 2))
        mu = s / n_cells
        var = jnp.maximum(q / n_cells - mu * mu, 0.0)
        dot = jnp.einsum("mcl,cl->m", rows, tmpl,
                         preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        return dot / (a_std * jnp.sqrt(var) * n_cells)

    w = temp_weight
    sim_t = jnp.where(w > 0.0,
                      group(win[:, :nt], tmpl_t, a_std_t, nt * L), 0.0)
    sim_s = jnp.where(w < 1.0,
                      group(win[:, nt:], tmpl_s, a_std_s, (C - nt) * L), 0.0)
    sim = sim_t * w + sim_s * (1.0 - w)
    # boost averages channel 0 only (FeatureCorrelationImpl.scala:73-78);
    # the per-file temporal shift restores the unshifted loudness mean
    loud_mean = win[:, 0].sum(axis=1) / L + shifts_t[file_idx]
    boost = jnp.exp((ln_avg - jnp.log(loud_mean)) / 0.6)
    sim = jnp.where(boost <= max_boost, sim, 0.0)
    return sim.astype(jnp.float32), boost.astype(jnp.float32)


@partial(jax.jit, static_argnames=("num_temporal",))
def _rerank_window_kernel(xs_b, shifts_t, file_idx, frames, tmpl_t, tmpl_s,
                          a_std_t, a_std_s, ln_avg, temp_weight, max_boost,
                          num_temporal: int = 1):
    """Exact re-scoring of candidate windows ON DEVICE.

    Gathers the ``[M, C, L]`` windows at ``(file_idx[m], frames[m])`` from
    the resident float32 features and scores each with the same
    cancellation-free algebra as the trace kernels (pre-centered template
    dot / shifted window stats; parity vs the f64 mirror ≤ 1e-5).  This
    replaces the host-side f64 numpy pass (``_exact_window_scores``, kept
    as the bit-level test oracle), whose per-candidate host work grows
    with the database.  The prepared features' padded tail holds the
    shift-consistent constant (kernels/prep.py), so any defensive
    zero-tail window reads reproduce the host semantics exactly.

    Mirrors FeatureCorrelationImpl.scala:414-421 (the math being
    re-scored) with the gates of :func:`~..kernels.corr.correlation_trace`.
    Returns ``(sims[M], boosts[M])`` float32.
    """
    return _rerank_window_math(
        xs_b, shifts_t, file_idx, frames, tmpl_t, tmpl_s, a_std_t,
        a_std_s, ln_avg, temp_weight, max_boost, num_temporal=num_temporal)


_SHARDED_RERANK_CACHE: dict = {}


def _sharded_rerank_fn(mesh, num_temporal: int):
    """Build-once cached SPMD re-rank program per (mesh, channel split).

    Under a mesh the resident features are sharded over ``files``, and a
    per-candidate gather through GSPMD would all-gather the whole feature
    stack onto every device (the capacity the mesh exists to exceed).
    ``shard_map`` makes the partitioning deterministic instead: every device
    receives the full (tiny) candidate index vectors, scores the
    candidates whose rows live in its local shard with the SAME math as
    the single-device kernel (:func:`_rerank_window_math`), masks the
    rest to 0, and one ``psum`` over the mesh assembles the ``[M]`` score
    vectors — each candidate is owned by exactly one shard, so the sum
    adds zeros around the one real value (exact in f32; NaN sims from
    degenerate windows propagate like the single-device kernel because
    the masking is a select, not an arithmetic product).
    """
    key = (tuple(d.id for d in mesh.devices.flat), num_temporal)
    fn = _SHARDED_RERANK_CACHE.get(key)
    if fn is None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        def body(xs_l, shifts_l, file_idx, frames, tmpl_t, tmpl_s,
                 a_std_t, a_std_s, ln_avg, temp_weight, max_boost):
            bs = xs_l.shape[0]
            base = jax.lax.axis_index("files") * bs
            li = file_idx - base
            valid = (li >= 0) & (li < bs)
            sims, boosts = _rerank_window_math(
                xs_l, shifts_l, jnp.clip(li, 0, bs - 1), frames,
                tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg, temp_weight,
                max_boost, num_temporal=num_temporal)
            sims = jnp.where(valid, sims, 0.0)
            boosts = jnp.where(valid, boosts, 0.0)
            return (jax.lax.psum(sims, "files"),
                    jax.lax.psum(boosts, "files"))

        spec_f, spec_r = P("files"), P()
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(spec_f, spec_f) + (spec_r,) * 9,
            out_specs=(spec_r, spec_r))
        fn = jax.jit(mapped)
        _SHARDED_RERANK_CACHE[key] = fn
    return fn


class FeatureDatabase:
    """Normalized, group-shifted feature matrices staged on device.

    ``entries``: ``(name, features[C, T])`` pairs (e.g. loaded from
    ``*_feat.aif``).  ``norm``: the ``feat_norms.aif`` matrix or ``None``.
    With a ``mesh``, the files axis is sharded across devices and queries
    run SPMD with the template replicated (collectives carry only the tiny
    top-k fetch).
    """

    def __init__(self, entries: Sequence[Tuple[str, np.ndarray]],
                 norm: Optional[np.ndarray], step_size: int = 512,
                 mesh=None, pad_multiple: int = 512,
                 storage_dtype=None, cache_spectra: bool = False,
                 rerank_device: Optional[bool] = None,
                 progress=None, check_aborted=None,
                 raw_store: str = "memory", time_capacity=None,
                 num_temporal: int = 1, _prestacked=None) -> None:
        from ..kernels.prep import prepare_database

        # observer protocol for minutes-long stagings (SURVEY §5; the
        # reference's checkAborted/progress pattern,
        # FeatureCorrelationImpl.scala:164,402): ``progress`` receives
        # fractions in [0, 1]; ``check_aborted`` may raise to cancel —
        # construction then fails cleanly (nothing half-staged escapes;
        # _restage adopts a fresh instance only on success, so an aborted
        # re-stage leaves the old database untouched).  Use
        # :meth:`stage` for the full Processor/observer surface.
        progress = progress if progress is not None else (lambda f: None)
        check_aborted = check_aborted if check_aborted is not None \
            else (lambda: None)
        check_aborted()

        def pad_rows_of(count: int) -> int:
            return _pad_rows_of(count, mesh)

        if raw_store not in ("memory", "memmap"):
            raise ValueError(f"raw_store {raw_store!r}")
        if num_temporal < 1:
            raise ValueError(f"num_temporal {num_temporal} < 1")
        # the temporal/spectral channel split (the reference's numTemporal,
        # FeatureCorrelation.scala:279-289) is a DATABASE property: staging
        # group-shifts and every query kernel must agree with the template's
        # split, so templates are validated against it per query
        self._num_temporal = num_temporal
        if _prestacked is not None:
            raw, lens = _prestacked
            self.files = list(entries)
        elif raw_store == "memmap":
            # streamed, disk-backed raw store: host RSS stays O(one file)
            # through staging and for the life of the process (entries may
            # be a generator when time_capacity is given)
            raw, lens, self.files = _stack_memmap(
                entries, pad_multiple, time_capacity, pad_rows_of,
                check_aborted=check_aborted)
        else:
            self.files = [name for name, _ in entries]
            # stack RAW features; normalization + group shift run on device
            # in one fused pass (kernels/prep.py) — no host prep passes
            raw, lens = pad_stack(
                [np.asarray(f, np.float32) for _, f in entries],
                multiple=pad_multiple)
        self.step_size = step_size
        pad_rows = pad_rows_of(raw.shape[0]) if raw_store != "memmap" \
            or _prestacked is not None else 0
        if pad_rows:
            raw = np.concatenate(
                [raw, np.zeros((pad_rows,) + raw.shape[1:], raw.dtype)])
            lens = np.concatenate(
                [lens, np.zeros(pad_rows, lens.dtype)])
        if num_temporal >= raw.shape[1]:
            raise ValueError(
                f"num_temporal {num_temporal} leaves no spectral channel "
                f"(database has {raw.shape[1]})")
        self._raw = raw
        self._lens = lens
        self._raw_store = raw_store
        self.norm = norm
        self._mesh = mesh
        # retained for incremental add_files/remove_files and restaging
        self._pad_multiple = pad_multiple
        self._storage_dtype = storage_dtype
        self._cache_spectra_mode = cache_spectra
        self._spectra_pack = ""

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            shard = NamedSharding(mesh, P("files"))
            # device_put straight from host memory: shards ship to their
            # own devices (a jnp.asarray first would commit the whole stack
            # to device 0 — the capacity the mesh exists to exceed)
            raw_dev = jax.device_put(raw, shard)
            self._lens_dev = jax.device_put(lens, shard)
            _drop_memmap_pages(raw)
        else:
            self._lens_dev = jnp.asarray(lens)
        if mesh is None and raw.shape[0] > _QUERY_CHUNK:
            # slab-wise staging: uploading + preparing the whole stack at
            # once would hold raw + prepared + normalization temporaries
            # simultaneously (~3x the database).  Each ≤_QUERY_CHUNK slab
            # uploads, prepares, and is written into a preallocated buffer
            # through a donated dynamic-update-slice — peak device memory
            # ≈ the database + ONE slab in flight (concatenating prepared
            # slabs would transiently hold ~2× the database).
            store_dtype = (jnp.float32 if storage_dtype is None
                           else storage_dtype)
            w_feat = 0.7 if cache_spectra else 1.0
            buf = jnp.zeros(raw.shape, store_dtype)
            shift_parts = []
            for o in range(0, raw.shape[0], _QUERY_CHUNK):
                check_aborted()
                dev = jax.device_put(raw[o:o + _QUERY_CHUNK])
                xs_p, sh_p = prepare_database(
                    dev, norm, self._lens_dev[o:o + _QUERY_CHUNK],
                    num_temporal=num_temporal)
                buf = _write_slab(buf, xs_p.astype(store_dtype),
                                  jnp.int32(o))
                buf.block_until_ready()   # one slab in flight at a time
                del dev, xs_p
                shift_parts.append(sh_p)
                _drop_memmap_pages(raw)   # keep a memmap store's RSS flat
                progress(w_feat * min(1.0, (o + _QUERY_CHUNK)
                                      / raw.shape[0]))
            self._xs = buf
            self._shifts = jnp.concatenate(shift_parts)
        else:
            if mesh is None:
                raw_dev = jax.device_put(raw)
            self._xs, self._shifts = prepare_database(
                raw_dev, norm, self._lens_dev, num_temporal=num_temporal)
            _drop_memmap_pages(raw)
            progress(0.7 if cache_spectra else 1.0)
            if storage_dtype is not None:
                # e.g. jnp.bfloat16: doubles resident capacity; queries
                # upcast on the fly (device sims good to ~1e-2; the exact
                # re-rank + automatic k-inflation recover exact results)
                self._xs = self._xs.astype(storage_dtype)
        # cache_spectra: keep every file's forward spectra resident
        # (~1.8× the feature memory at f32, half that packed to bf16) so
        # each query pays only its inverse FFTs.  True = full complex64
        # (X, Xsq; FFT window sums).
        # "bf16"/"bfloat16" (or any real dtype name) = reduced planar
        # (re, im) pairs of the FORWARD spectra only; window statistics
        # come from per-file window-sum prefix tables computed on the fly
        # from the resident f32 features inside the query kernels
        # (kernels.corr.window_sum_table via _unpack_if_reduced — storing
        # the tables would cost ~1.7 GiB at 10k files), so each trace pays
        # only its 2 template-dot irffts.  That's the smallest cache;
        # device sims then carry ~1e-3 noise (bf16 quantization ≫ the
        # table's ~1e-5 prefix rounding); the automatic exact re-rank
        # (+4× k-inflation) makes the RERANK_LIMIT best returned hits
        # exact, and the rest keep the raw sims (QueryResult.exact).
        self._spectra_reduced = False
        if cache_spectra:
            pack = "" if cache_spectra is True else str(
                jnp.dtype("bfloat16" if cache_spectra in ("bf16",)
                          else cache_spectra))
            self._spectra_pack = pack
            self._spectra_reduced = bool(pack)
            b = self._xs.shape[0]
            if mesh is not None or b <= _QUERY_CHUNK:
                # under a mesh the kernel runs SPMD on the sharded xs and
                # its outputs inherit the files sharding — the chunked
                # host-buffer path below would gather onto one device
                self._spectra = _spectra_kernel(
                    self._xs, num_temporal=num_temporal, pack_dtype=pack)
            else:
                # chunk-wise into preallocated donated buffers: one chunk's
                # f32 forward-FFT transient in flight at a time (shapes via
                # eval_shape — a compiled batch-of-1 probe would cost a
                # whole extra compile).  The compute chunk is capped below
                # _QUERY_CHUNK: a 2048-file complex64 forward-FFT transient
                # is ~2 GiB on top of the resident features and spectra.
                step = min(_QUERY_CHUNK, _SPECTRA_CHUNK)
                probe = jax.eval_shape(
                    partial(_spectra_kernel, num_temporal=num_temporal,
                            pack_dtype=pack), self._xs[:1])
                bufs = [jnp.zeros((b,) + p.shape[1:], p.dtype)
                        for p in probe]
                for o in range(0, b, step):
                    check_aborted()
                    part = _spectra_kernel(self._xs[o:o + step],
                                           num_temporal=num_temporal,
                                           pack_dtype=pack)
                    bufs = [_write_slab(buf, p, jnp.int32(o))
                            for buf, p in zip(bufs, part)]
                    jax.block_until_ready(bufs)
                    del part
                    progress(0.7 + 0.3 * min(1.0, (o + step) / b))
                self._spectra = tuple(bufs)
        else:
            self._spectra = None
        # exact re-rank backend: candidate windows re-score on device
        # (_rerank_window_kernel single-chip; _sharded_rerank_fn SPMD under
        # a mesh) whenever the resident features are f32; otherwise the
        # host f64 mirror runs.  Explicit ``rerank_device=True`` on an
        # ineligible configuration is an error (a silent bf16 "exact"
        # re-rank would not be exact).
        eligible = self._xs.dtype == jnp.float32
        if rerank_device is None:
            self._rerank_device = eligible
        else:
            if rerank_device and not eligible:
                raise ValueError(
                    "rerank_device=True needs float32 features "
                    f"(got dtype {self._xs.dtype})")
            self._rerank_device = bool(rerank_device)
        # block so construction reports staging errors here, not at query time
        jax.block_until_ready(self._xs)
        progress(1.0)

    @property
    def num_files(self) -> int:
        """Live file count (tombstoned entries excluded)."""
        return sum(1 for n in self.files if n is not None)

    @property
    def _num_shards(self) -> int:
        """Files-axis shard count for the validated-batch chunk budget."""
        return 1 if self._mesh is None else int(self._mesh.devices.size)

    # -- incremental updates -----------------------------------------------

    def remove_files(self, names: Sequence[str]) -> None:
        """Drop files from the resident database without restaging.

        Rows are tombstoned: length masked to 0 on device (every kernel
        already treats a zero-length file as "no valid window" → −inf sims,
        the same masking the staging padding uses) and the name slot set to
        None.  :meth:`add_files` reuses tombstoned rows; :meth:`save`
        compacts them away.  O(bytes of one lens vector) — no feature data
        moves; under a mesh only the sharded lens vector re-ships.
        """
        pos = {n: i for i, n in enumerate(self.files) if n is not None}
        idxs = []
        for n in names:
            if n not in pos:
                raise KeyError(f"{n!r} is not in the database")
            idxs.append(pos[n])
        for i in idxs:
            self.files[i] = None
            self._lens[i] = 0
            self._raw[i] = 0.0
        self._lens_dev = self._put_lens()

    def add_files(self, entries: Sequence[Tuple[str, np.ndarray]],
                  progress=None, check_aborted=None) -> None:
        """Stage additional files into the resident database.

        New rows fill tombstoned slots (see :meth:`remove_files`) and the
        staging padding; only the new files' features cross the link and
        only they are prepared (one ``prepare_database`` pass).  When the
        free slots run out, or a file exceeds the current time capacity,
        the whole database restages — batch adds where possible, since
        each distinct add-batch shape is its own jit key.

        ``progress``/``check_aborted`` follow the staging observer
        protocol.  Abort points sit BEFORE the incremental path mutates
        anything (and the restage path adopts atomically), so an aborted
        add always leaves the previous state fully usable.
        """
        from ..kernels.prep import prepare_database

        progress = progress if progress is not None else (lambda f: None)
        check_aborted = check_aborted if check_aborted is not None \
            else (lambda: None)
        if not entries:
            return
        check_aborted()
        if self._mesh is not None:
            # a sharded files axis cannot take an in-place row write without
            # resharding anyway — restage with the mesh preserved
            return self._restage(self._dedup_new(entries),
                                 progress=progress,
                                 check_aborted=check_aborted)
        entries = self._dedup_new(entries)
        names = [n for n, _ in entries]
        feats = [np.asarray(f, np.float32) for _, f in entries]
        C, t_cap = self._raw.shape[1], self._raw.shape[2]
        if any(f.shape[0] != C for f in feats):
            raise ValueError(f"channel count mismatch (database has {C})")
        if max(f.shape[1] for f in feats) > t_cap:
            return self._restage(entries, progress=progress,
                                 check_aborted=check_aborted)

        slots = [i for i, n in enumerate(self.files) if n is None]
        tail = list(range(len(self.files), self._raw.shape[0]))
        free = slots + tail
        if len(free) < len(entries):
            return self._restage(entries, progress=progress,
                                 check_aborted=check_aborted)

        raw_new, lens_new = pad_stack(feats, multiple=1)
        if raw_new.shape[2] < t_cap:
            raw_new = np.pad(
                raw_new, ((0, 0), (0, 0), (0, t_cap - raw_new.shape[2])))
        dev = jax.device_put(raw_new)
        xs_p, sh_p = prepare_database(dev, self.norm, jnp.asarray(lens_new),
                                      num_temporal=self._num_temporal)
        if self._storage_dtype is not None:
            xs_p = xs_p.astype(self._storage_dtype)
        sp_p = _spectra_kernel(xs_p, num_temporal=self._num_temporal,
                               pack_dtype=self._spectra_pack) \
            if self._spectra is not None else None
        # surface any async device failure (e.g. RESOURCE_EXHAUSTED in the
        # prep/spectra kernels) BEFORE host metadata mutates — past the
        # abort point the commit must be all-or-nothing
        jax.block_until_ready((xs_p, sh_p) if sp_p is None
                              else (xs_p, sh_p, sp_p))
        progress(0.8)
        # last abort point: past here the scatter commits atomically
        check_aborted()

        used = free[:len(entries)]
        for j, slot in enumerate(used):
            if slot < len(self.files):
                self.files[slot] = names[j]      # tombstone reuse
            else:
                assert slot == len(self.files)   # tail slots are in order
                self.files.append(names[j])
            self._lens[slot] = lens_new[j]
            self._raw[slot] = raw_new[j]
        # one DONATED scatter per device array (a per-row Python loop would
        # cost a dispatch round-trip and a fresh tiny jit key per slot; an
        # undonated .at[].set would transiently double the resident buffer)
        slots_dev = jnp.asarray(np.asarray(used, np.int32))
        self._xs = _scatter_rows(self._xs, slots_dev, xs_p)
        self._shifts = _scatter_rows(self._shifts, slots_dev, sh_p)
        if sp_p is not None:
            self._spectra = tuple(_scatter_rows(buf, slots_dev, p)
                                  for buf, p in zip(self._spectra, sp_p))
        self._lens_dev = self._put_lens()
        jax.block_until_ready(self._xs)
        progress(1.0)

    def _dedup_new(self, entries):
        """Validate an add batch: no name may collide with a live entry or
        repeat within the batch."""
        live = {n for n in self.files if n is not None}
        seen = set()
        for n, _ in entries:
            if n in live:
                raise ValueError(f"{n!r} is already in the database")
            if n in seen:
                raise ValueError(f"{n!r} appears twice in this add batch")
            seen.add(n)
        return list(entries)

    def _put_lens(self):
        """Host lens vector → device, re-sharded under a mesh."""
        lens = jnp.asarray(self._lens)
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            return jax.device_put(lens, NamedSharding(self._mesh, P("files")))
        return lens

    def _restage(self, new_entries: Sequence[Tuple[str, np.ndarray]],
                 progress=None, check_aborted=None) -> None:
        """Full rebuild with the surviving entries plus ``new_entries`` —
        the fallback when an add outgrows the time or files capacity (and
        the add path for mesh-sharded databases).  A FRESH instance is
        built first and adopted only on success: an abort (or any staging
        failure) mid-restage leaves the old resident database fully
        usable."""
        live = [(i, n) for i, n in enumerate(self.files) if n is not None]
        new_entries = list(new_entries)
        # time_capacity is NOT forwarded as-is (the restage may exist
        # precisely because it was outgrown) — recomputed from the live
        # lens + the new entries' frame counts
        kwargs = dict(
            step_size=self.step_size, mesh=self._mesh,
            pad_multiple=self._pad_multiple,
            storage_dtype=self._storage_dtype,
            cache_spectra=self._cache_spectra_mode,
            rerank_device=self._rerank_device,
            raw_store=self._raw_store,
            num_temporal=self._num_temporal,
            progress=progress, check_aborted=check_aborted)
        if self._raw_store == "memmap":
            # stream the old rows lazily AND drop the old mapping's pages
            # as the copy walks it — without the drops the read loop
            # faults the whole old store resident and ru_maxrss spikes to
            # the full database size, the exact bound the memmap store
            # exists to keep
            import itertools

            cap = max([int(self._lens[i]) for i, _ in live]
                      + [int(np.asarray(f).shape[1])
                         for _, f in new_entries])

            def old_rows():
                for j, (i, n) in enumerate(live):
                    yield (n, self._raw[i][:, :int(self._lens[i])])
                    if j % 64 == 63:
                        _drop_memmap_pages(self._raw)
                _drop_memmap_pages(self._raw)

            fresh = FeatureDatabase(
                itertools.chain(old_rows(), new_entries), self.norm,
                time_capacity=cap, **kwargs)
        else:
            old = [(n, self._raw[i][:, :int(self._lens[i])])
                   for i, n in live]
            fresh = FeatureDatabase(old + new_entries, self.norm, **kwargs)
        self.__dict__.update(fresh.__dict__)

    def _chunks(self):
        """Per-dispatch file ranges (one range when unchunked/sharded)."""
        b = self._xs.shape[0]
        if self._mesh is not None or b <= _QUERY_CHUNK:
            return [slice(0, b)]
        return [slice(o, o + _QUERY_CHUNK) for o in range(0, b, _QUERY_CHUNK)]

    def _trim(self, *arrays, axis: int = 0):
        """Drop the staging-padding rows beyond the real file count."""
        n = len(self.files)
        out = tuple(np.asarray(a)[(slice(None),) * axis + (slice(0, n),)]
                    for a in arrays)
        return out if len(out) > 1 else out[0]

    def query(self, template: InputTemplate, temp_weight: float = 0.5,
              max_boost: float = 8.0, k: int = 4,
              with_traces: bool = False,
              exact_rerank: Optional[bool] = None):
        """One-dispatch punch query → :class:`QueryResult` (and optionally
        the dense (sims, boosts) traces for exact host-side replay; rows of
        tombstoned files — see :meth:`remove_files` — carry no valid
        windows and surface as −inf there like the staging padding).

        ``exact_rerank`` recomputes the returned top-k candidates' sims and
        boosts exactly (the ``RERANK_LIMIT`` globally best of them, marked
        in ``QueryResult.exact``; the rest keep their device sims) and
        re-sorts each file's hits — it defaults to ON for reduced-precision
        storage (e.g. bfloat16, whose device sims are only good to ~1e-2).
        For reduced-precision storage the device top-k is automatically
        inflated 4× before the exact re-rank and trimmed back after, so
        candidates the lossy sims mis-rank just outside the top-k are
        recovered (recall at the ~1e-2 margin); use a float32 database when
        even that inflation is not enough.
        """
        self._check_template(template)
        reduced = (self._xs.dtype != jnp.float32) or self._spectra_reduced
        if exact_rerank is None:
            exact_rerank = reduced
        k_dev = self._inflated_k(k, template.num_frames) \
            if (exact_rerank and reduced) else k
        k_dev = self._k_clamp(k_dev, template.num_frames)
        if k_dev == 0:
            if with_traces:
                raise ValueError(
                    f"template ({template.num_frames} frames) exceeds the "
                    f"database's padded time capacity "
                    f"{self._xs.shape[2]} — no file can contain it, and "
                    "there is no trace to return")
            return self._masked_query_result(k)
        tmpl_args = (template.device_temporal(), template.device_spectral(),
                     jnp.float32(template.temporal_std),
                     jnp.float32(template.spectral_std),
                     jnp.float32(template.ln_avg_loudness))
        scal_args = (jnp.float32(temp_weight), jnp.float32(max_boost))
        parts = []
        for sl in self._chunks():
            targs = tmpl_args + (self._shifts[sl],) + scal_args
            if self._spectra is not None:
                out = _query_kernel_spectra(
                    tuple(s[sl] for s in self._spectra), self._xs[sl],
                    self._xs.shape[2], self._lens_dev[sl], *targs,
                    num_temporal=self._num_temporal, k=k_dev)
            else:
                out = _query_kernel(self._xs[sl], self._lens_dev[sl],
                                    *targs,
                                    num_temporal=self._num_temporal, k=k_dev)
            parts.append(out if with_traces else out[:3])
        # dispatch every chunk first, then one fetch pass: chunk k+1's
        # device work overlaps chunk k's transfer
        parts = jax.device_get(parts)
        got = tuple(np.concatenate([p[i] for p in parts])
                    for i in range(len(parts[0])))
        vals, idx, boosts_k = self._trim(got[0], got[1], got[2])
        res = QueryResult(vals, idx, list(self.files), boosts_k)
        if exact_rerank:
            self._rerank_exact(res, template, temp_weight, max_boost)
        if k_dev != k:
            self._fit_cols(res, k)
        if with_traces:
            sims, boosts = self._trim(got[3], got[4])
            return res, (sims, boosts, self._lens[:len(self.files)])
        return res

    def _inflated_k(self, k: int, tmpl_frames: int) -> int:
        """Device top-k for reduced-precision storage: 4× the requested k
        (bounded by the window count) so the exact re-rank can pull back
        candidates the lossy device sims pushed just outside the top-k.
        May still exceed the window count when ``k`` itself does —
        :meth:`_k_clamp` bounds the final device k in every query path."""
        return max(k, min(4 * k, self._xs.shape[2] - tmpl_frames + 1))

    def _k_clamp(self, k_dev: int, *tmpl_frames: int) -> int:
        """Largest device top-k the kernels can take: their window axis
        has ``t_cap − L + 1`` slots (padded time capacity), and
        ``lax.top_k`` requires ``k`` ≤ that.  Returns 0 when some template
        is longer than the capacity itself — i.e. longer than EVERY file —
        where the documented serving rule (files shorter than the template
        are excluded from results) leaves nothing to search: callers
        short-circuit to an all-masked result instead of crashing."""
        w = min(self._xs.shape[2] - L + 1 for L in tmpl_frames)
        return max(0, min(k_dev, w))

    def _check_template(self, *templates: InputTemplate) -> None:
        """Every query template must carry the database's channel layout:
        the same channel count and the same temporal/spectral split
        (``num_temporal``) the staging group-shift was computed with — a
        mismatched split would silently score channels against the wrong
        group statistics (the host exact mirror honors the template's
        split, so the two backends would disagree without this gate)."""
        C = self._raw.shape[1]
        for t in templates:
            tc = t.temporal_block.shape[0] + t.spectral_block.shape[0]
            if tc != C:
                raise ValueError(
                    f"template has {tc} channels, database has {C}")
            if t.num_temporal != self._num_temporal:
                raise ValueError(
                    f"template num_temporal {t.num_temporal} != database "
                    f"num_temporal {self._num_temporal}")

    @staticmethod
    def _fit_k_cols(arr: np.ndarray, k: int, fill) -> np.ndarray:
        """Return exactly ``k`` result columns: trim an inflated device k,
        or pad a capacity-clamped one with masked values (−inf sims are
        dropped by ``matches``'s finite gate like the staging padding)."""
        if arr.shape[1] >= k:
            return arr[:, :k]
        pad = np.full((arr.shape[0], k - arr.shape[1]), fill, arr.dtype)
        return np.concatenate([arr, pad], axis=1)

    def _masked_query_result(self, k: int) -> QueryResult:
        """All-masked ``[num_rows, k]`` result (template fits no window)."""
        B = len(self.files)
        return QueryResult(np.full((B, k), -np.inf, np.float32),
                           np.zeros((B, k), np.int32), list(self.files),
                           np.ones((B, k), np.float32))

    def _masked_punch_result(self, k: int, min_punch: int
                             ) -> PunchQueryResult:
        """All-masked punch result (some template fits no window)."""
        B = len(self.files)
        ones = np.ones((B, k), np.float32)
        return PunchQueryResult(
            np.full((B, k), -np.inf, np.float32),
            np.zeros((B, k), np.int32), np.zeros((B, k), np.int32),
            ones, ones.copy(), list(self.files), min_punch,
            np.full((B, k), -np.inf, np.float32))

    #: exact-re-rank budget: only the globally best (by device sim)
    #: candidates are re-scored on host.  Every candidate `.matches()` can
    #: surface for any sane ``k_total·num_per_file`` lies far inside this;
    #: without the cap a reduced-precision 10k-file query would copy
    #: 160k × [C, L] windows (~8 GB) to host per query.
    RERANK_LIMIT = 4096

    def _rerank_exact(self, res: QueryResult, template: InputTemplate,
                      temp_weight: float, max_boost: float) -> None:
        """Replace each returned candidate's (sim, boost) with the exact
        host-side value and re-sort every file's k hits.  Candidates beyond
        the ``RERANK_LIMIT`` globally best keep their device-precision sims
        (they cannot reach the match lists those limits are sized for);
        ``res.exact`` marks which hits were re-scored."""
        # device_get hands back read-only views; re-ranking mutates
        res.sims = np.array(res.sims)
        res.frames = np.array(res.frames)
        if res.boosts is not None:
            res.boosts = np.array(res.boosts)
        res.exact = np.zeros(res.sims.shape, bool)
        cand = self._rerank_candidates(res.sims)
        if cand.size:
            sims, boosts = self._window_scores(
                cand[:, 0], res.frames[cand[:, 0], cand[:, 1]],
                template, temp_weight, max_boost)
            res.sims[cand[:, 0], cand[:, 1]] = sims
            if res.boosts is not None:
                res.boosts[cand[:, 0], cand[:, 1]] = boosts
            res.exact[cand[:, 0], cand[:, 1]] = True
        order = np.argsort(-np.nan_to_num(res.sims, nan=-np.inf), axis=1)
        for name in ("sims", "frames", "boosts", "exact"):
            arr = getattr(res, name)
            if arr is not None:
                setattr(res, name, np.take_along_axis(arr, order, axis=1))

    def _rerank_candidates(self, sims: np.ndarray) -> np.ndarray:
        """(i, j) indices to re-score exactly: all finite candidates, or —
        past ``RERANK_LIMIT`` of them — the globally best by device sim."""
        finite = np.isfinite(sims)
        n_finite = int(finite.sum())
        if n_finite <= self.RERANK_LIMIT:
            return np.argwhere(finite)
        flat = np.where(finite.ravel(), sims.ravel(), -np.inf)
        top = np.argpartition(-flat, self.RERANK_LIMIT - 1)[:self.RERANK_LIMIT]
        return np.stack(np.unravel_index(top, sims.shape), axis=1)

    def _window_scores(self, file_idx: np.ndarray, frames: np.ndarray,
                       template: InputTemplate, temp_weight: float,
                       max_boost: float):
        """Re-rank backend dispatch: device kernel when the resident
        features are f32 (≤~1e-7 of the mirror), host f64 mirror
        otherwise (bit-level, but slow at 10k scale on a small host)."""
        if self._rerank_device:
            return self._device_window_scores(file_idx, frames, template,
                                              temp_weight, max_boost)
        return self._exact_window_scores(file_idx, frames, template,
                                         temp_weight, max_boost)

    def _device_window_scores_async(self, file_idx: np.ndarray,
                                    frames: np.ndarray,
                                    template: InputTemplate,
                                    temp_weight: float, max_boost: float):
        """Dispatch the device re-rank over bucket-padded candidates and
        return the DEVICE ``(sims, boosts)`` arrays without fetching —
        callers with several independent re-ranks (the punch in+out pair)
        launch them all, then fetch once, so the device round trips
        overlap instead of serializing.  Under a mesh this is the SPMD
        :func:`_sharded_rerank_fn` program (each shard scores its local
        candidates, one psum merges the tiny [M] vectors)."""
        m = len(file_idx)
        mp = _rerank_bucket(m)
        fi = np.zeros(mp, np.int32)
        fi[:m] = file_idx
        fr = np.zeros(mp, np.int32)
        fr[:m] = frames
        args = (self._xs, self._shifts, jnp.asarray(fi), jnp.asarray(fr),
                template.device_temporal(), template.device_spectral(),
                jnp.float32(template.temporal_std),
                jnp.float32(template.spectral_std),
                jnp.float32(template.ln_avg_loudness),
                jnp.float32(temp_weight), jnp.float32(max_boost))
        if self._mesh is None:
            return _rerank_window_kernel(
                *args, num_temporal=self._num_temporal)
        return _sharded_rerank_fn(self._mesh, self._num_temporal)(*args)

    def _device_window_scores(self, file_idx: np.ndarray, frames: np.ndarray,
                              template: InputTemplate, temp_weight: float,
                              max_boost: float):
        """:meth:`_device_window_scores_async` + fetch + pad-trim."""
        m = len(file_idx)
        sims, boosts = jax.device_get(self._device_window_scores_async(
            file_idx, frames, template, temp_weight, max_boost))
        return sims[:m].copy(), boosts[:m].copy()

    def _exact_window_scores(self, file_idx: np.ndarray,
                             frames: np.ndarray, template: InputTemplate,
                             temp_weight: float, max_boost: float):
        """Exact (sims, boosts) of ``template`` at windows
        ``(file_idx[m], frames[m])`` — a batched mirror of
        analysis.correlation._single_window_trace with the same float
        widths (f32 normalization, f64 accumulation, f32 results); a
        per-candidate Python loop costs ~a minute at 10k files × k."""
        L = template.num_frames
        C = self._raw.shape[1]
        nt = template.num_temporal
        n = len(file_idx)
        wins = np.zeros((n, C, L), np.float32)
        valid_len = np.empty(n, np.int64)
        for m in range(n):
            i, t = int(file_idx[m]), int(frames[m])
            stop = min(t + L, int(self._lens[i]))
            wins[m, :, :stop - t] = self._raw[i][:, t:stop]
            valid_len[m] = stop - t
        if self.norm is not None:
            mins = np.asarray(self.norm[:, 0:1], np.float32)
            rng = (np.asarray(self.norm[:, 1:2], np.float32) - mins)
            with np.errstate(divide="ignore", invalid="ignore"):
                normed = (wins - mins) / rng
            # only the read frames are normalized; a zero tail stays 0
            # (the freshly-allocated buffer, _single_window_trace)
            tail = np.arange(L)[None, :] >= valid_len[:, None]
            normed[np.broadcast_to(tail[:, None, :], normed.shape)] = 0.0
            wins = normed.astype(np.float32)
        w64 = wins.astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            avg32 = (w64[:, 0, :].sum(axis=1) / L).astype(np.float32)
            boosts = np.exp(
                (template.ln_avg_loudness
                 - np.log(avg32.astype(np.float64))) / 0.6
            ).astype(np.float32)

            def group_sim(lo, hi, block, a_mean, a_std):
                g = w64[:, lo:hi, :]
                size = (hi - lo) * L
                bm = g.reshape(n, -1).sum(axis=1) / size
                var = ((g - bm[:, None, None]) ** 2
                       ).reshape(n, -1).sum(axis=1) / size
                bs = np.sqrt(var)
                # the RAW normalized template block (reconstructing it as
                # centered + f32(mean) costs 1 ulp per cell and can flip
                # exact-compare selection gates), widened like M.correlate
                a64 = np.asarray(block, np.float32).astype(np.float64)
                num = ((a64[None] - a_mean) * (g - bm[:, None, None])
                       ).reshape(n, -1).sum(axis=1)
                return (num / (a_std * bs * size)).astype(np.float32)

            sim_t = group_sim(0, nt, template.temporal_block,
                              template.temporal_mean,
                              template.temporal_std) \
                if temp_weight > 0 else np.zeros(n, np.float32)
            sim_s = group_sim(nt, C, template.spectral_block,
                              template.spectral_mean,
                              template.spectral_std) \
                if temp_weight < 1 else np.zeros(n, np.float32)
        sims = (sim_t * np.float32(temp_weight)
                + sim_s * np.float32(1 - temp_weight)).astype(np.float32)
        sims = np.where(boosts <= max_boost, sims, np.float32(0.0))
        return sims, boosts

    def _rerank_exact_punch(self, res: PunchQueryResult,
                            punch_in: InputTemplate,
                            punch_out: InputTemplate,
                            tw_in: float, tw_out: float,
                            max_boost: float) -> None:
        """Exact host re-scoring of a punch result's candidates: both
        windows per candidate through the f64 mirror, recombined as
        ``√(inSim·outSim)`` with the kernel's gates (inSim > 0, positive
        product), then each file's k hits re-sorted.  The device's *choice*
        of best punch length per offset is kept (re-picking it would need
        the whole band); with reduced-precision storage/spectra a near-tie
        (≲1e-3) between lengths can therefore resolve differently than a
        float32 database.  Only the ``RERANK_LIMIT`` globally best
        candidates are re-scored; ``res.exact`` marks them."""
        res.sims = np.array(res.sims)
        res.frames = np.array(res.frames)
        res.punch_lens = np.array(res.punch_lens)
        res.boosts_in = np.array(res.boosts_in)
        res.boosts_out = np.array(res.boosts_out)
        if res.in_sims is not None:
            res.in_sims = np.array(res.in_sims)
        res.exact = np.zeros(res.sims.shape, bool)
        cand = self._rerank_candidates(res.sims)
        if cand.size:
            fi, fj = cand[:, 0], cand[:, 1]
            t_in = res.frames[fi, fj]
            t_out = t_in + res.min_punch + res.punch_lens[fi, fj]
            if self._rerank_device:
                # dispatch BOTH window kernels before fetching either:
                # serializing them would pay two device round trips per
                # punch query
                m = len(fi)
                d_in = self._device_window_scores_async(
                    fi, t_in, punch_in, tw_in, max_boost)
                d_out = self._device_window_scores_async(
                    fi, t_out, punch_out, tw_out, max_boost)
                (in_sims, b_in), (out_sims, b_out) = jax.device_get(
                    (d_in, d_out))
                in_sims, b_in = in_sims[:m].copy(), b_in[:m].copy()
                out_sims, b_out = out_sims[:m].copy(), b_out[:m].copy()
            else:
                in_sims, b_in = self._window_scores(
                    fi, t_in, punch_in, tw_in, max_boost)
                out_sims, b_out = self._window_scores(
                    fi, t_out, punch_out, tw_out, max_boost)
            # the reference's inSim * outSim is a Java Float multiply —
            # round the product to f32 BEFORE the sqrt (an f64 product can
            # land 1 ulp away and flip downstream selection gates)
            prod = (in_sims * out_sims).astype(np.float32)
            sims = np.where((in_sims > 0) & (prod > 0),
                            np.sqrt(np.maximum(prod, 0)),
                            -np.inf).astype(np.float32)
            res.sims[fi, fj] = sims
            res.boosts_in[fi, fj] = b_in
            res.boosts_out[fi, fj] = b_out
            if res.in_sims is not None:
                res.in_sims[fi, fj] = in_sims
            res.exact[fi, fj] = True
        order = np.argsort(-np.nan_to_num(res.sims, nan=-np.inf), axis=1)
        for name in ("sims", "frames", "punch_lens", "boosts_in",
                     "boosts_out", "in_sims", "exact"):
            arr = getattr(res, name)
            if arr is not None:
                setattr(res, name, np.take_along_axis(arr, order, axis=1))

    def query_punch(self, punch_in: InputTemplate, punch_out: InputTemplate,
                    min_punch: int, max_punch: int,
                    temp_weight_in: float = 0.5,
                    temp_weight_out: float = 0.5,
                    max_boost: float = 8.0, k: int = 4,
                    exact_rerank: Optional[bool] = None) -> PunchQueryResult:
        """Punch-in × punch-out search in ONE dispatch (the reference's
        three hot loops, FeatureCorrelationImpl.scala:190-389, fused on
        device): per file, the best punch length in ``[min_punch,
        max_punch]`` (feature frames) is found for every punch-in offset
        and the top-k offsets returned with ``√(inSim·outSim)`` scores and
        both boosts.

        ``exact_rerank`` (default ON for reduced-precision storage or
        spectra, like :meth:`query`) re-scores the candidates' in/out
        windows exactly on host, recombines, and re-sorts — with the
        automatic 4× device-k inflation recovering candidates the lossy
        sims mis-ranked just outside the top-k."""
        if min_punch > max_punch:
            raise ValueError(f"min_punch {min_punch} > max_punch {max_punch}")
        self._check_template(punch_in, punch_out)
        reduced = (self._xs.dtype != jnp.float32) or self._spectra_reduced
        if exact_rerank is None:
            exact_rerank = reduced
        k_dev = self._inflated_k(k, punch_in.num_frames) \
            if (exact_rerank and reduced) else k
        if self._k_clamp(1, punch_in.num_frames, punch_out.num_frames) == 0:
            return self._masked_punch_result(k, min_punch)
        k_dev = self._k_clamp(k_dev, punch_in.num_frames)
        targs = (punch_in.device_temporal(), punch_in.device_spectral(),
                 jnp.float32(punch_in.temporal_std),
                 jnp.float32(punch_in.spectral_std),
                 jnp.float32(punch_in.ln_avg_loudness),
                 punch_out.device_temporal(), punch_out.device_spectral(),
                 jnp.float32(punch_out.temporal_std),
                 jnp.float32(punch_out.spectral_std),
                 jnp.float32(punch_out.ln_avg_loudness),
                 None,  # per-chunk shifts slot
                 jnp.float32(temp_weight_in),
                 jnp.float32(temp_weight_out), jnp.float32(max_boost),
                 jnp.int32(min_punch), jnp.int32(max_punch - min_punch + 1))
        parts = []
        for sl in self._chunks():
            ch_args = targs[:10] + (self._shifts[sl],) + targs[11:]
            if self._spectra is not None:
                out = _punch_query_kernel_spectra(
                    tuple(s[sl] for s in self._spectra), self._xs[sl],
                    self._xs.shape[2], self._lens_dev[sl], *ch_args,
                    num_temporal=self._num_temporal, k=k_dev)
            else:
                out = _punch_query_kernel(self._xs[sl], self._lens_dev[sl],
                                          *ch_args,
                                          num_temporal=self._num_temporal,
                                          k=k_dev)
            parts.append(out)
        parts = jax.device_get(parts)   # all chunks dispatched before fetch
        vals, t_idx, j_k, b_in, b_out, in_sims = self._trim(
            *(np.concatenate([p[i] for p in parts]) for i in range(6)))
        res = PunchQueryResult(vals, t_idx, j_k, b_in, b_out,
                               list(self.files), min_punch, in_sims)
        if exact_rerank:
            self._rerank_exact_punch(res, punch_in, punch_out,
                                     temp_weight_in, temp_weight_out,
                                     max_boost)
        if k_dev != k:
            self._fit_cols(res, k)
        return res

    def _fit_cols(self, res, k: int) -> None:
        """Trim/pad every array of a query or punch result to exactly ``k``
        columns (see :meth:`_fit_k_cols`)."""
        for name, fill in (("sims", -np.inf), ("frames", 0),
                           ("punch_lens", 0), ("boosts", 1.0),
                           ("boosts_in", 1.0), ("boosts_out", 1.0),
                           ("in_sims", -np.inf), ("exact", False)):
            arr = getattr(res, name, None)
            if arr is not None:
                setattr(res, name, self._fit_k_cols(arr, k, fill))

    def query_batch(self, templates: Sequence[InputTemplate],
                    temp_weight: float = 0.5, max_boost: float = 8.0,
                    k: int = 4,
                    exact_rerank: Optional[bool] = None) -> List[QueryResult]:
        """Many punches against the resident database, batched by length.

        Templates are bucketed by frame length; each bucket is stacked on a
        leading axis (from the per-template cached device arrays — no
        re-upload) and answered in one dispatch (a punch-in + punch-out
        pair of different lengths costs two dispatches, not Q).  Results
        come back in input order with boosts, and reduced-precision
        storage re-ranks exactly on host like :meth:`query`.
        """
        self._check_template(*templates)
        reduced = (self._xs.dtype != jnp.float32) or self._spectra_reduced
        if exact_rerank is None:
            exact_rerank = reduced
        buckets: dict = {}
        for qi, t in enumerate(templates):
            buckets.setdefault(t.num_frames, []).append(qi)
        results: List[Optional[QueryResult]] = [None] * len(templates)
        for frames_len, idxs in _split_buckets(buckets):
            k_dev = self._inflated_k(k, frames_len) \
                if (exact_rerank and reduced) else k
            k_dev = self._k_clamp(k_dev, frames_len)
            if k_dev == 0:
                for qi in idxs:
                    results[qi] = self._masked_query_result(k)
                continue
            group = [templates[qi] for qi in idxs]
            tt = jnp.stack([t.device_temporal() for t in group])
            ts = jnp.stack([t.device_spectral() for t in group])
            st_t = jnp.asarray([t.temporal_std for t in group], jnp.float32)
            st_s = jnp.asarray([t.spectral_std for t in group], jnp.float32)
            la = jnp.asarray([t.ln_avg_loudness for t in group], jnp.float32)
            parts = []
            for sl in self._chunks():
                qargs = (tt, ts, st_t, st_s, la, self._shifts[sl],
                         jnp.float32(temp_weight), jnp.float32(max_boost))
                if self._spectra is not None:
                    out = _multi_query_kernel_spectra(
                        tuple(s[sl] for s in self._spectra), self._xs[sl],
                        self._xs.shape[2], self._lens_dev[sl], *qargs,
                        num_temporal=self._num_temporal, k=k_dev,
                        shards=self._num_shards)
                else:
                    out = _multi_query_kernel(self._xs[sl],
                                              self._lens_dev[sl], *qargs,
                                              num_temporal=self._num_temporal,
                                              k=k_dev,
                                              shards=self._num_shards)
                parts.append(out)
            parts = jax.device_get(parts)
            # per-chunk results are [Q, chunk, k]: concat the files axis
            vals, idx, boosts = (
                self._trim(np.concatenate([p[i] for p in parts], axis=1),
                           axis=1)
                for i in range(3))
            for q, qi in enumerate(idxs):
                if results[qi] is not None:
                    continue        # power-of-two padding lane (duplicate
                    # of sub[-1]): identical data — skip the re-rank
                res = QueryResult(vals[q], idx[q], list(self.files),
                                  boosts[q])
                if exact_rerank:
                    self._rerank_exact(res, group[q], temp_weight, max_boost)
                if k_dev != k:
                    self._fit_cols(res, k)
                results[qi] = res
        return results

    def query_punch_batch(self, pairs: Sequence[tuple],
                          temp_weight_in: float = 0.5,
                          temp_weight_out: float = 0.5,
                          max_boost: float = 8.0, k: int = 4,
                          exact_rerank: Optional[bool] = None
                          ) -> List[PunchQueryResult]:
        """Many punch-in × punch-out searches against the resident
        database, batched by template shape.

        ``pairs``: sequence of ``(punch_in, punch_out, min_punch,
        max_punch)`` tuples (templates are :class:`InputTemplate`, the
        band in feature frames).  Pairs are bucketed by
        ``(len_in, len_out)`` — the punch band is traced, so it mints no
        keys; the pair count is a shape dimension too, but
        :func:`_split_buckets` pads it to a power of two ≤
        :data:`_MAX_BATCH_QUERIES`, bounding the jit keys per shape
        bucket — and each bucket answers in one dispatch per database
        chunk, with the per-file forward spectra computed ONCE per
        bucket instead of once per query (the Q× FFT saving; see
        :func:`_multi_punch_kernel`).  Results come back in input order
        and are each equal to the corresponding :meth:`query_punch`
        (tests pin this), including the automatic exact re-rank +
        k-inflation for reduced-precision storage/spectra."""
        reduced = (self._xs.dtype != jnp.float32) or self._spectra_reduced
        if exact_rerank is None:
            exact_rerank = reduced
        for q, (p_in, p_out, mp, xp) in enumerate(pairs):
            if mp > xp:
                raise ValueError(
                    f"pair {q}: min_punch {mp} > max_punch {xp}")
            self._check_template(p_in, p_out)
        buckets: dict = {}
        for q, (p_in, p_out, *_band) in enumerate(pairs):
            buckets.setdefault((p_in.num_frames, p_out.num_frames),
                               []).append(q)
        results: List[Optional[PunchQueryResult]] = [None] * len(pairs)
        scal = (jnp.float32(temp_weight_in), jnp.float32(temp_weight_out),
                jnp.float32(max_boost))
        for (_li, _lo), idxs in _split_buckets(buckets):
            group = [pairs[q] for q in idxs]
            ins = [p for p, _, _, _ in group]
            outs = [p for _, p, _, _ in group]
            if self._k_clamp(1, _li, _lo) == 0:
                for q in idxs:
                    results[q] = self._masked_punch_result(
                        k, int(pairs[q][2]))
                continue
            k_dev = self._inflated_k(k, ins[0].num_frames) \
                if (exact_rerank and reduced) else k
            k_dev = self._k_clamp(k_dev, _li)

            def stack(ts):
                return (jnp.stack([t.device_temporal() for t in ts]),
                        jnp.stack([t.device_spectral() for t in ts]),
                        jnp.asarray([t.temporal_std for t in ts],
                                    jnp.float32),
                        jnp.asarray([t.spectral_std for t in ts],
                                    jnp.float32),
                        jnp.asarray([t.ln_avg_loudness for t in ts],
                                    jnp.float32))

            targs = stack(ins) + stack(outs)
            mps = jnp.asarray([mp for _, _, mp, _ in group], jnp.int32)
            spans = jnp.asarray([xp - mp + 1 for _, _, mp, xp in group],
                                jnp.int32)
            parts = []
            for sl in self._chunks():
                ch = targs + (self._shifts[sl],) + scal + (mps, spans)
                if self._spectra is not None:
                    out = _multi_punch_kernel_spectra(
                        tuple(s[sl] for s in self._spectra), self._xs[sl],
                        self._xs.shape[2], self._lens_dev[sl], *ch,
                        num_temporal=self._num_temporal, k=k_dev,
                        shards=self._num_shards)
                else:
                    out = _multi_punch_kernel(
                        self._xs[sl], self._lens_dev[sl], *ch,
                        num_temporal=self._num_temporal, k=k_dev,
                        shards=self._num_shards)
                parts.append(out)
            parts = jax.device_get(parts)   # all chunks dispatched first
            # per-chunk results are [Q, chunk, k]: concat the files axis
            got = tuple(
                self._trim(np.concatenate([p[i] for p in parts], axis=1),
                           axis=1)
                for i in range(6))
            for g, q in enumerate(idxs):
                if results[q] is not None:
                    continue        # power-of-two padding lane (duplicate
                    # of sub[-1]): identical data — skip the re-rank
                p_in, p_out, mp, _xp = pairs[q]
                res = PunchQueryResult(
                    got[0][g], got[1][g], got[2][g], got[3][g], got[4][g],
                    list(self.files), int(mp), got[5][g])
                if exact_rerank:
                    self._rerank_exact_punch(res, p_in, p_out,
                                             temp_weight_in,
                                             temp_weight_out, max_boost)
                if k_dev != k:
                    self._fit_cols(res, k)
                results[q] = res
        return results

    def save(self, path, progress=None, check_aborted=None,
             compresslevel=None) -> None:
        """Persist the stacked database (raw features + lengths + norm +
        file names) so serving restarts skip the per-file AIFF parsing —
        reload with :meth:`load` and the device staging re-runs in one
        fused pass.

        The archive is byte-compatible with ``np.savez_compressed`` (same
        member names; ``np.load`` reads it), but the ``raw`` member
        streams ROW BY ROW with periodic page drops, so a
        ``raw_store="memmap"`` database saves without materializing its
        full raw stack in host RAM (the bounded-RSS contract; ~5.8 GB at
        the 10k scale).  The write goes to a same-directory temp file and
        renames into place on success, so an abort (honored between rows)
        or crash never leaves a torn archive at ``path``.

        ``compresslevel`` (1–9, default zlib's 6): at the 10k scale the
        deflate of ~5.8 GB of f32 features dominates save wall time on a
        1-vCPU serving host — level 1 is ~3× faster for a few percent
        more bytes."""
        import os
        import tempfile
        import zipfile
        from numpy.lib import format as npf

        progress = progress if progress is not None else (lambda f: None)
        check_aborted = check_aborted if check_aborted is not None \
            else (lambda: None)
        check_aborted()
        progress(0.0)
        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"                       # np.savez semantics
        keep = [i for i, n in enumerate(self.files) if n is not None]
        small = {
            "lens": self._lens[keep],
            "norm": (self.norm if self.norm is not None
                     else np.zeros((0, 2), np.float32)),
            "files": np.array([self.files[i] for i in keep]),
            "step_size": np.asarray(self.step_size),
            "num_temporal": np.asarray(self._num_temporal),
        }
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path) or ".", suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as fh, \
                    zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED,
                                    allowZip64=True,
                                    compresslevel=compresslevel) as zf:
                with zf.open("raw.npy", "w", force_zip64=True) as f:
                    npf.write_array_header_1_0(f, {
                        "descr": npf.dtype_to_descr(self._raw.dtype),
                        "fortran_order": False,
                        "shape": (len(keep),) + self._raw.shape[1:]})
                    for j, i in enumerate(keep):
                        check_aborted()
                        f.write(np.ascontiguousarray(
                            self._raw[i]).tobytes())
                        if j % 64 == 63:
                            _drop_memmap_pages(self._raw)
                            progress(0.9 * (j + 1) / len(keep))
                _drop_memmap_pages(self._raw)
                for name, arr in small.items():
                    with zf.open(name + ".npy", "w",
                                 force_zip64=True) as f:
                        npf.write_array(f, np.asanyarray(arr),
                                        allow_pickle=False)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        progress(1.0)

    @staticmethod
    def load(path, mesh=None, **stage_kwargs) -> "FeatureDatabase":
        """Re-stage a :meth:`save`d database.  ``stage_kwargs`` pass
        through to the constructor (e.g. ``cache_spectra="bf16"`` for the
        compact serving mode, or ``progress=``/``check_aborted=`` for the
        staging observer protocol).

        With ``raw_store="memmap"`` the archive's ``raw`` member streams
        ROW BY ROW straight into the unlinked temp-file memmap store —
        peak host RSS stays O(one row + the deflate window) instead of
        the full decompressed raw stack (~5.8 GB at the 10k scale): the
        same bounded-RSS contract :meth:`save` keeps on the way out."""
        if stage_kwargs.get("raw_store") == "memmap":
            return FeatureDatabase._load_memmap(path, mesh, stage_kwargs)
        with np.load(path, allow_pickle=False) as z:
            norm = z["norm"] if z["norm"].size else None
            # plain np.savez archives / pre-round-4 saves lack the member
            stage_kwargs.setdefault(
                "num_temporal",
                int(z["num_temporal"]) if "num_temporal" in z.files else 1)
            return FeatureDatabase(
                [str(f) for f in z["files"]], norm,
                step_size=int(z["step_size"]), mesh=mesh,
                _prestacked=(z["raw"], z["lens"]), **stage_kwargs)

    @staticmethod
    def _load_memmap(path, mesh, stage_kwargs) -> "FeatureDatabase":
        """Streamed :meth:`load` for ``raw_store="memmap"``: decompress
        the ``raw.npy`` member row-wise from the zip into a fresh
        :func:`_stack_memmap` store (files-axis pads included, so the
        constructor's idempotent :func:`_pad_rows_of` re-pad is a no-op
        and the memmap is adopted as-is — a ``np.concatenate`` re-pad
        would materialize the stack, the exact thing this path avoids)."""
        import os
        import zipfile
        from numpy.lib import format as npf

        check_aborted = stage_kwargs.get("check_aborted") or (lambda: None)
        with zipfile.ZipFile(os.fspath(path)) as zf:
            def member(name):
                with zf.open(name + ".npy") as f:
                    return npf.read_array(f, allow_pickle=False)

            lens = member("lens")
            norm = member("norm")
            files = [str(f) for f in member("files")]
            step_size = int(member("step_size"))
            # plain np.savez archives / pre-round-4 saves lack the member
            stage_kwargs.setdefault(
                "num_temporal",
                int(member("num_temporal"))
                if "num_temporal.npy" in zf.namelist() else 1)
            with zf.open("raw.npy") as f:
                version = npf.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = npf.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = npf.read_array_header_2_0(f)
                else:
                    raise ValueError(f"unsupported npy version {version}")
                if fortran or len(shape) != 3 or shape[0] != len(files):
                    raise ValueError(f"unexpected raw layout {shape}")
                n, C, t_cap = shape
                row_bytes = C * t_cap * dtype.itemsize

                def rows():
                    for i in range(n):
                        check_aborted()
                        buf = f.read(row_bytes)
                        if len(buf) != row_bytes:
                            raise ValueError("truncated raw member")
                        a = np.frombuffer(buf, dtype).reshape(C, t_cap)
                        yield files[i], a[:, :int(lens[i])]

                # pad_multiple=1 + time_capacity=t_cap keeps the stored
                # frame capacity EXACT (it already carries the original
                # save-time padding)
                raw, lens_p, names = _stack_memmap(
                    rows(), 1, t_cap,
                    lambda c: _pad_rows_of(c, mesh),
                    check_aborted=check_aborted)
        return FeatureDatabase(
            names, norm if norm.size else None, step_size=step_size,
            mesh=mesh, _prestacked=(raw, lens_p), **stage_kwargs)

    @staticmethod
    def stage(entries, norm, observer=None, name: str = "database staging",
              **kwargs):
        """Stage a database under the full observer protocol, like the
        six analysis factories: returns a started
        :class:`~strugatzki_tpu.runtime.processor.Processor` whose result
        is the :class:`FeatureDatabase`; the observer receives
        :class:`Progress` events during the minutes-long 10k-scale
        staging and ``abort()`` cancels cooperatively (the reference's
        processor pattern, SURVEY §5)."""
        from ..runtime.processor import Processor

        def body(proc):
            return FeatureDatabase(entries, norm,
                                   progress=proc.set_progress,
                                   check_aborted=proc.check_aborted,
                                   **kwargs)

        return Processor(body, name=name, observer=observer).start()

    @staticmethod
    def from_folder(folder: str, num_coeffs: int = 13, step_size: int = 512,
                    normalize: bool = True, mesh=None) -> "FeatureDatabase":
        """Load every ``*_feat.xml`` entry in a database folder."""
        import os

        from ..analysis.common import load_norm, read_features

        norm = load_norm(folder, num_coeffs) if normalize else None
        entries = []
        for name in sorted(os.listdir(folder)):
            if not name.endswith("_feat.xml"):
                continue
            meta = ExtractionConfig.from_xml_file(os.path.join(folder, name))
            if meta.num_coeffs != num_coeffs or meta.step_size != step_size:
                continue
            entries.append((meta.audio_input, read_features(meta)))
        return FeatureDatabase(entries, norm, step_size, mesh=mesh)
