"""Batched sliding-correlation kernels (JAX/XLA).

These replace the reference's scalar ring-buffer loops
(impl/FeatureCorrelationImpl.scala:190-246, impl/FeatureSegmentationImpl.scala:107-133,
impl/SelfSimilarityImpl.scala:127-165, impl/CrossSimilarityImpl.scala:135-170)
with dense formulations (FFTs, matmuls and elementwise passes):

* **sliding template correlation** — FFT cross-correlation: one rfft per
  channel serves the template dots AND, via a ones-kernel spectrum, the
  sliding window sums/sums-of-squares; serves FeatureCorrelation and
  CrossSimilarity.  (A direct conv formulation is kept for short
  templates; its cost grows with the template length.)
* **novelty curve** — ``correlateHalf`` for every window position from a
  lag-product plus FFT window sums; serves FeatureSegmentation.
* **gram similarity** — ``correlateHalf`` over all window *pairs* from one
  ``X·Xᵀ`` matmul plus per-window sums; serves SelfSimilarity.

Numerical design (this is what holds the ≤1e-5 parity target in float32):
Pearson-style correlation is invariant to adding a constant per channel
group, so

1. templates are *pre-centered* in float64 on the host
   (``a ← a − mean(a)``); the numerator then reduces to a single dot product
   ``Σ (a−μa)·b`` with no ``−N·μa·μb`` cancellation term, and
2. feature matrices are *pre-shifted* per channel group by their global f64
   mean, so window sums / sums of squares are small and
   ``var = q/N − μ²`` suffers no cancellation.

The algebra (derived from MathUtil.scala:177-196 and :80-99):

  correlate:      sim(t) = dot(a−μa, W_t) / (σa·σb(t)·N)
  correlateHalf:  sim(t) = (P(t) − h·C·μ(t)²) / (σ(t)²·h·C)
                  with P(t) = Σ_c Σ_{i<h} x[c,t+i]·x[c,t+h+i]
  gram cell:      sim(i,j) = (D_ij − N_h·μ_ij²) / (σ_ij²·N_h)
                  with D = X_w·X_wᵀ,  μ/σ from per-window sums s, q

All functions take/return float32 device arrays; shapes are static per jit
specialization.
"""

from __future__ import annotations

from functools import partial

from ..runtime.platform import configure as _configure_platform

_configure_platform()

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "sliding_sum", "sliding_dot",
    "correlation_trace", "novelty_trace",
    "window_stats", "gram_similarity_block", "extract_windows",
    "prepare_template", "shift_per_group",
    "trace_spectra", "pack_spectra", "unpack_spectra",
    "forward_spectra", "window_sum_table", "correlation_trace_from_sums",
]


# ---------------------------------------------------------------------------
# host-side preparation (float64, tiny)
# ---------------------------------------------------------------------------

def prepare_template(mat: np.ndarray):
    """Center a template channel-group in f64; return (centered f32, mean, std).

    ``mean``/``std`` come from the single parity anchor
    :func:`~strugatzki_tpu.kernels.mathref.stat` (MathUtil.stat,
    FeatureCorrelationImpl.scala:92-97) so the device template statistics
    can never desynchronize from the host mirror the tests anchor to.
    """
    from . import mathref as M

    m64 = np.asarray(mat, dtype=np.float64)
    mean, std = M.stat(m64, 0, m64.shape[1], 0, m64.shape[0])
    centered = (m64 - mean).astype(np.float32)
    return centered, float(mean), float(std)


def shift_per_group(x: np.ndarray, num_temporal: int = 1):
    """Subtract the global f64 mean of each channel group (temporal = rows
    ``[0:num_temporal)``, spectral = the rest).  Returns (shifted f32,
    temporal_shift, spectral_shift).  Correlations are invariant to this; the
    temporal shift is returned so loudness window means can be recovered for
    the boost estimate."""
    x = np.asarray(x, dtype=np.float32)
    t64 = x[:num_temporal].astype(np.float64)
    s64 = x[num_temporal:].astype(np.float64)
    ts = float(t64.mean()) if t64.size else 0.0
    ss = float(s64.mean()) if s64.size else 0.0
    out = np.empty_like(x)
    out[:num_temporal] = (t64 - ts).astype(np.float32)
    out[num_temporal:] = (s64 - ss).astype(np.float32)
    return out, ts, ss


# ---------------------------------------------------------------------------
# device primitives
# ---------------------------------------------------------------------------

def sliding_sum(v: jnp.ndarray, win: int) -> jnp.ndarray:
    """Sum over every length-``win`` window of the last axis (VALID).

    ``reduce_window`` lowering, for small windows; the trace kernels
    below use FFT ones-kernel correlation instead (see module docstring).
    Kept as a reference primitive.
    """
    return jax.lax.reduce_window(
        v, 0.0, jax.lax.add,
        window_dimensions=(1,) * (v.ndim - 1) + (win,),
        window_strides=(1,) * v.ndim,
        padding="VALID",
    )


def sliding_dot_conv(template: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """``Σ_c Σ_i template[c,i]·x[c,t+i]`` for every valid offset ``t`` via a
    single-output-channel convolution (an implicit GEMM).

    template: ``[C, L]``, x: ``[C, T]`` → ``[T-L+1]``.  Good for short
    templates; for long ones see :func:`sliding_dot_fft`.
    """
    out = jax.lax.conv_general_dilated(
        x[None],                 # [1, C, T]
        template[None],          # [1, C, L]  (OIH: out=1, in=C)
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # full f32: a reduced-precision default (bf16 passes, or TF32 on
        # a GPU) loses ~1e-3 relative, blowing the ≤1e-5 parity budget
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0, 0]


def _fft_len(n: int) -> int:
    """Next power of two ≥ n.

    Linear correlation only needs N ≥ n; a 3-smooth length (cuFFT handles
    it natively) has up to 37% fewer spectrum bins at the serving bucket.
    Whether that is faster on the GPU is not measured: an isolated FFT
    micro-benchmark did not predict the fused per-file [C, N] trace
    programs on the former accelerator, so benchmark the whole 10k
    program, not the FFT, before changing this."""
    p = 1
    while p < n:
        p <<= 1
    return p


def sliding_dot_fft(template: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """FFT cross-correlation: ``Σ_c Σ_i template[c,i]·x[c,t+i]`` for all t.

    O(C·N log N) and — unlike a length-L convolution kernel — compiles
    instantly for any template length.  Both operands are pre-centered /
    group-shifted (small values), which keeps the f32 FFT round-trip within
    the parity budget.
    """
    C, L = template.shape
    T = x.shape[1]
    W = T - L + 1
    if W <= 0:
        # static shapes: raise at trace time — a negative [:W] slice would
        # silently return a wrong-length array of circularly-wrapped values
        raise ValueError(f"template length {L} exceeds signal length {T}")
    N = _fft_len(T)
    ta = jnp.fft.rfft(template, n=N, axis=1)
    xa = jnp.fft.rfft(x, n=N, axis=1)
    spec = (jnp.conj(ta) * xa).sum(axis=0)
    return jnp.fft.irfft(spec, n=N)[:W].astype(jnp.float32)


#: default sliding-dot implementation
sliding_dot = sliding_dot_fft


# ---------------------------------------------------------------------------
# sliding template correlation (FeatureCorrelation / CrossSimilarity)
# ---------------------------------------------------------------------------

def _ones_spectrum(length: int, n: int) -> jnp.ndarray:
    """rfft of a length-``length`` ones kernel (host-computed constant):
    correlating with it yields sliding window sums."""
    return jnp.asarray(np.fft.rfft(np.ones(length), n=n).astype(np.complex64))


@partial(jax.jit, static_argnames=("num_temporal",))
def correlation_trace(xs: jnp.ndarray,
                      template_t: jnp.ndarray, template_s: jnp.ndarray,
                      a_std_t: jnp.ndarray, a_std_s: jnp.ndarray,
                      ln_avg_loud: jnp.ndarray, temporal_shift: jnp.ndarray,
                      temp_weight: jnp.ndarray, max_boost: jnp.ndarray,
                      num_temporal: int = 1):
    """Similarity + boost traces for a template slid over a feature matrix.

    Dense equivalent of the punch-in/out hot loops
    (FeatureCorrelationImpl.scala:190-246, :281-315):

    * ``xs``: ``[C, Tp]`` normalized features, group-shifted
      (:func:`shift_per_group`), zero-padded so ``Tp = W + L − 1`` for ``W``
      window positions.
    * ``template_t``/``template_s``: pre-centered template groups ``[1, L]`` /
      ``[C−1, L]`` (:func:`prepare_template`).
    * boost(t) = ``exp((lnAvgLoud_template − ln(mean loud window))/0.6)``
      (FeatureCorrelationImpl.scala:73-78); windows whose boost exceeds
      ``max_boost`` get sim = 0 (:199-210), NaN boost included (NaN ≤ x is
      false, as in the JVM).
    * temporal/spectral groups are blended by ``temp_weight``; a group with
      zero weight is skipped entirely, exactly like the reference's
      ``if (inTempWeight > 0f)`` gates (:200-205) — this keeps NaN/Inf from an
      unused degenerate group out of the result.

    Returns ``(sim[W], boost[W])`` float32.
    """
    X, Xsq = trace_spectra(xs, num_temporal=num_temporal)
    return correlation_trace_from_spectra(
        X, Xsq, xs.shape[1], template_t, template_s, a_std_t, a_std_s,
        ln_avg_loud, temporal_shift, temp_weight, max_boost,
        num_temporal=num_temporal)


def trace_spectra(xs: jnp.ndarray, num_temporal: int = 1):
    """The per-file half of :func:`correlation_trace`: forward spectra of
    every channel plus the two group power rows.  Computing these once and
    sharing them across templates is the big FFT saving of multi-template
    queries (punch-in × punch-out, ``query_batch``): the shared part is
    C+2 forward FFTs per file vs ~6 inverse FFTs per (file, template).

    One rfft per channel serves everything: template dots (per-channel
    spectra × template spectra), window sums (group-sum spectra × ones
    kernel) — long-window reduce_window/conv lowerings are avoided
    entirely.
    """
    nt = num_temporal
    N = _fft_len(xs.shape[1])
    if xs.dtype != jnp.float32:
        # bf16-stored databases (2x memory capacity) upcast on the fly
        xs = xs.astype(jnp.float32)
    X = jnp.fft.rfft(xs, n=N, axis=1)                     # [C, N/2+1]
    Xsq = jnp.fft.rfft(
        jnp.concatenate([(xs[:nt] * xs[:nt]).sum(axis=0, keepdims=True),
                         (xs[nt:] * xs[nt:]).sum(axis=0, keepdims=True)],
                        axis=0), n=N, axis=1)             # [2, N/2+1]
    return X, Xsq


def forward_spectra(xs: jnp.ndarray) -> jnp.ndarray:
    """Per-channel forward spectra only (``X`` of :func:`trace_spectra`)
    — the half the sums-based serving path needs; the squared-row spectra
    ``Xsq`` exist solely to FFT-form window sums, which
    :func:`window_sum_table` replaces."""
    N = _fft_len(xs.shape[1])
    if xs.dtype != jnp.float32:
        xs = xs.astype(jnp.float32)
    return jnp.fft.rfft(xs, n=N, axis=1)


def pack_spectra(z: jnp.ndarray, dtype=jnp.bfloat16):
    """Complex spectra → PLANAR ``(re, im)`` arrays in a reduced dtype.

    Halves the resident size of a spectra cache (parallel/database.py
    ``cache_spectra="bf16"``).  Planar storage (two separate real
    arrays) keeps the frequency axis as the minor dimension; a ``[..., 2]``
    trailing-stack layout would make every consumer read stride-2 through
    a 2-wide minor axis.  Quantization adds
    ~1e-3-level noise to device sims; the serving layer's exact re-rank
    (+ automatic k-inflation) makes its ``RERANK_LIMIT`` best returned
    candidates exact."""
    return jnp.real(z).astype(dtype), jnp.imag(z).astype(dtype)


def unpack_spectra(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`pack_spectra` (any real dtype pair → complex64);
    the upcast fuses into the first consumer inside a jit."""
    return jax.lax.complex(re.astype(jnp.float32), im.astype(jnp.float32))


def correlation_trace_from_spectra(X: jnp.ndarray, Xsq: jnp.ndarray,
                                   t_padded: int,
                                   template_t: jnp.ndarray,
                                   template_s: jnp.ndarray,
                                   a_std_t: jnp.ndarray, a_std_s: jnp.ndarray,
                                   ln_avg_loud: jnp.ndarray,
                                   temporal_shift: jnp.ndarray,
                                   temp_weight: jnp.ndarray,
                                   max_boost: jnp.ndarray,
                                   num_temporal: int = 1):
    """:func:`correlation_trace` continued from precomputed
    :func:`trace_spectra` output (``t_padded`` = the original ``xs`` width)."""
    nt = num_temporal
    L = template_t.shape[1]
    Tp = t_padded
    W = Tp - L + 1
    if W <= 0:
        # static shapes: raise at trace time instead of returning a
        # negative-slice array of circularly-wrapped garbage (serving-layer
        # callers pre-clamp via FeatureDatabase._k_clamp; this guards any
        # new direct caller)
        raise ValueError(
            f"template length {L} exceeds padded signal length {Tp}")
    N = _fft_len(Tp)
    ones_l = _ones_spectrum(L, N)

    def wsum(spec_row):
        return jnp.fft.irfft(spec_row * jnp.conj(ones_l), n=N)[:W]

    s_t = wsum(X[:nt].sum(axis=0))
    q_t = wsum(Xsq[0])
    s_s = wsum(X[nt:].sum(axis=0))
    q_s = wsum(Xsq[1])
    mu0 = None if nt == 1 else wsum(X[0]) / L
    return _trace_epilogue(X, t_padded, s_t, q_t, s_s, q_s, mu0,
                           template_t, template_s, a_std_t, a_std_s,
                           ln_avg_loud, temporal_shift, temp_weight,
                           max_boost, num_temporal=nt)


def window_sum_table(xs: jnp.ndarray, num_temporal: int = 1) -> jnp.ndarray:
    """Exclusive prefix sums of the window-statistic rows: ``[R, Tp+1]``
    float32 with rows ``[Σ_t x, Σ_t x², Σ_s x, Σ_s x²]`` (plus an ``x[0]``
    row when ``num_temporal != 1`` — the boost's window mean averages
    channel 0 alone, FeatureCorrelationImpl.scala:73-78).

    A sliding length-``L`` window sum is then two static slices,
    ``P[r, L:] − P[r, :W]`` — no inverse FFT.  This replaces 4 of the 6
    per-(file, template) irffts of :func:`correlation_trace_from_spectra`
    on the reduced-precision serving path (the table is
    template-independent, so a punch-in × punch-out pair shares ONE
    table where the FFT formulation pays the 4 window-sum irffts twice).
    f32 prefix rounding adds ~1e-5-level noise to window statistics —
    an order below the bf16 spectra quantization the path already
    carries, and the serving layer's exact re-rank makes its
    ``RERANK_LIMIT`` best returned hits exact (parallel/database.py).  Parity paths (f32
    features, no spectra cache) keep the FFT window sums and their
    ≤3e-8 budget.
    """
    nt = num_temporal
    if xs.dtype != jnp.float32:
        xs = xs.astype(jnp.float32)
    rows = [xs[:nt].sum(axis=0), (xs[:nt] * xs[:nt]).sum(axis=0),
            xs[nt:].sum(axis=0), (xs[nt:] * xs[nt:]).sum(axis=0)]
    if nt != 1:
        rows.append(xs[0])
    r = jnp.stack(rows)
    return jnp.concatenate(
        [jnp.zeros((r.shape[0], 1), jnp.float32),
         jnp.cumsum(r, axis=1, dtype=jnp.float32)], axis=1)


def correlation_trace_from_sums(X: jnp.ndarray, sums: jnp.ndarray,
                                t_padded: int,
                                template_t: jnp.ndarray,
                                template_s: jnp.ndarray,
                                a_std_t: jnp.ndarray, a_std_s: jnp.ndarray,
                                ln_avg_loud: jnp.ndarray,
                                temporal_shift: jnp.ndarray,
                                temp_weight: jnp.ndarray,
                                max_boost: jnp.ndarray,
                                num_temporal: int = 1):
    """:func:`correlation_trace` continued from forward spectra ``X`` plus
    a :func:`window_sum_table` — the 2-irfft trace (template dots only)
    used by the cached-spectra serving kernels."""
    nt = num_temporal
    L = template_t.shape[1]
    W = t_padded - L + 1
    if W <= 0:
        raise ValueError(
            f"template length {L} exceeds padded signal length {t_padded}")

    def wsum(row):
        return row[L:L + W] - row[:W]

    s_t = wsum(sums[0])
    q_t = wsum(sums[1])
    s_s = wsum(sums[2])
    q_s = wsum(sums[3])
    mu0 = None if nt == 1 else wsum(sums[4]) / L
    return _trace_epilogue(X, t_padded, s_t, q_t, s_s, q_s, mu0,
                           template_t, template_s, a_std_t, a_std_s,
                           ln_avg_loud, temporal_shift, temp_weight,
                           max_boost, num_temporal=nt)


def _trace_epilogue(X, t_padded, s_t, q_t, s_s, q_s, mu0,
                    template_t, template_s, a_std_t, a_std_s,
                    ln_avg_loud, temporal_shift, temp_weight, max_boost,
                    num_temporal: int = 1):
    """Shared tail of the trace kernels: window statistics → template dots
    (the 2 irreducible irffts) → blend → boost gate.  ``mu0`` is the
    window mean of channel 0 when ``num_temporal != 1``, else ``None``
    (reuses ``mu_t``)."""
    nt = num_temporal
    L = template_t.shape[1]
    Tp = t_padded
    W = Tp - L + 1
    C_s = X.shape[0] - nt
    N = _fft_len(Tp)

    n_t = nt * L
    mu_t = s_t / n_t
    var_t = jnp.maximum(q_t / n_t - mu_t * mu_t, 0.0)
    std_t = jnp.sqrt(var_t)

    n_s = C_s * L
    mu_s = s_s / n_s
    var_s = jnp.maximum(q_s / n_s - mu_s * mu_s, 0.0)
    std_s = jnp.sqrt(var_s)

    def tdot(tmpl, rows):
        # NOTE on precision: this multiply-reduce (like trace_spectra's
        # squared-row sums and novelty_trace's lag product) is elementwise
        # f32 ops + a tree reduce — no dot_general, so no reduced-precision
        # matmul path (the explicit matmuls in sliding_dot_conv /
        # gram_similarity_block set Precision.HIGHEST, and
        # tests/test_precision.py pins that).  chip_smoke.py's parity phase
        # (≤1e-5 vs the f64 mirror on the GPU) is the canary if a future
        # XLA starts dot-forming these contractions.
        ta = jnp.fft.rfft(tmpl, n=N, axis=1)
        spec = (jnp.conj(ta) * rows).sum(axis=0)
        return jnp.fft.irfft(spec, n=N)[:W]

    w = temp_weight
    sim_t = jnp.where(
        w > 0.0, tdot(template_t, X[:nt]) / (a_std_t * std_t * n_t), 0.0)
    sim_s = jnp.where(
        w < 1.0, tdot(template_s, X[nt:]) / (a_std_s * std_s * n_s), 0.0)
    sim = sim_t * w + sim_s * (1.0 - w)

    # loudness boost: window mean of (unshifted) channel 0 — NOT the whole
    # temporal group (calcBoost averages b(0) only,
    # FeatureCorrelationImpl.scala:73-78)
    if mu0 is None:
        mu0 = mu_t
    loud_mean = mu0 + temporal_shift
    boost = jnp.exp((ln_avg_loud - jnp.log(loud_mean)) / 0.6)
    sim = jnp.where(boost <= max_boost, sim, 0.0)
    return sim.astype(jnp.float32), boost.astype(jnp.float32)


# ---------------------------------------------------------------------------
# novelty curve (FeatureSegmentation)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("half_win", "num_temporal"))
def novelty_trace(xs: jnp.ndarray, half_win: int,
                  temp_weight: jnp.ndarray, num_temporal: int = 1):
    """``correlateHalf`` at every window position, per group, blended.

    Dense equivalent of the segmentation hot loop
    (FeatureSegmentationImpl.scala:107-133).  ``xs``: ``[C, Tp]`` with
    ``Tp = W + 2·half_win − 1`` for ``W`` positions.  Returns ``sim[W]``.

    Derivation: for window at ``t`` (length ``2h``), statistics run over the
    whole window (MathUtil.scala:82 — rotation-invariant), and the numerator
    reduces to ``P(t) − h·C·μ(t)²`` with ``P`` the lag-``h`` product sum.
    """
    h = half_win
    nt = num_temporal
    if xs.dtype != jnp.float32:
        # mirror trace_spectra's guard: products/squares below must not run
        # in a reduced storage dtype (~4e-3 relative per bf16 product vs
        # the ~2e-5 parity budget)
        xs = xs.astype(jnp.float32)
    Tp = xs.shape[1]
    W = Tp - 2 * h + 1
    N = _fft_len(Tp)
    ones_h = _ones_spectrum(h, N)
    ones_2h = _ones_spectrum(2 * h, N)

    def group(rows: jnp.ndarray):
        c = rows.shape[0]
        # lag product: y[i] = x[i]·x[i+h], summed over channels
        y = (rows[:, :-h] * rows[:, h:]).sum(axis=0)
        # window sums via FFT correlation with ones kernels (no
        # long-window reduce_window)
        yf = jnp.fft.rfft(y, n=N)
        p = jnp.fft.irfft(yf * jnp.conj(ones_h), n=N)[:W]
        sf = jnp.fft.rfft(rows.sum(axis=0), n=N)
        s = jnp.fft.irfft(sf * jnp.conj(ones_2h), n=N)[:W]
        qf = jnp.fft.rfft((rows * rows).sum(axis=0), n=N)
        q = jnp.fft.irfft(qf * jnp.conj(ones_2h), n=N)[:W]
        n2 = 2 * h * c
        mu = s / n2
        # clamp: the reference's two-pass variance is non-negative by
        # construction (MathUtil.scala:48-60); q/N − μ² can round negative
        var = jnp.maximum(q / n2 - mu * mu, 0.0)
        n_half = h * c
        return (p - n_half * mu * mu) / (var * n_half)

    w = temp_weight
    sim_t = jnp.where(w > 0.0, group(xs[:nt]), 0.0)
    sim_s = jnp.where(w < 1.0, group(xs[nt:]), 0.0)
    return (sim_t * w + sim_s * (1.0 - w)).astype(jnp.float32)


# ---------------------------------------------------------------------------
# gram similarity (SelfSimilarity)
# ---------------------------------------------------------------------------

def extract_windows(xs: jnp.ndarray, starts: jnp.ndarray, half_win: int):
    """Gather windows ``xs[:, s:s+half_win]`` for each start → ``[B, C, h]``."""
    idx = starts[:, None] + jnp.arange(half_win)[None, :]   # [B, h]
    return jnp.transpose(xs[:, idx], (1, 0, 2))             # [B, C, h]


@partial(jax.jit, static_argnames=("num_temporal",))
def window_stats(win: jnp.ndarray, num_temporal: int = 1):
    """Per-window per-group sums and sums of squares: ``[B, C, h]`` →
    ``(s_t, q_t, s_s, q_s)`` each ``[B]``."""
    nt = num_temporal
    if win.dtype != jnp.float32:
        win = win.astype(jnp.float32)   # see novelty_trace's dtype guard
    t, s = win[:, :nt], win[:, nt:]
    return (t.sum(axis=(1, 2)), (t * t).sum(axis=(1, 2)),
            s.sum(axis=(1, 2)), (s * s).sum(axis=(1, 2)))


@partial(jax.jit, static_argnames=("num_temporal",))
def gram_similarity_block(win_i: jnp.ndarray, win_j: jnp.ndarray,
                          stats_i, stats_j,
                          temp_weight: jnp.ndarray, num_temporal: int = 1):
    """Blended ``correlateHalf`` for a block of window pairs.

    Dense equivalent of SelfSimilarityImpl.scala:127-165's per-cell loop: the
    cell (i, j) correlates window_i (first half) against window_j (second
    half) with joint statistics over both halves.  ``win_*``: ``[B, C, h]``
    blocks; ``stats_*`` from :func:`window_stats`.  Returns ``sim[Bi, Bj]``.

    The pair dot is one matmul per group → MXU.
    """
    nt = num_temporal
    h = win_i.shape[2]

    def group(a: jnp.ndarray, b: jnp.ndarray, sa, qa, sb, qb):
        c = a.shape[1]
        d = jnp.einsum("ick,jck->ij", a, b,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        n_h = c * h
        mu = (sa[:, None] + sb[None, :]) / (2 * n_h)
        var = jnp.maximum((qa[:, None] + qb[None, :]) / (2 * n_h) - mu * mu, 0.0)
        return (d - n_h * mu * mu) / (var * n_h)

    s_ti, q_ti, s_si, q_si = stats_i
    s_tj, q_tj, s_sj, q_sj = stats_j
    w = temp_weight
    sim_t = jnp.where(w > 0.0, group(win_i[:, :nt], win_j[:, :nt],
                                     s_ti, q_ti, s_tj, q_tj), 0.0)
    sim_s = jnp.where(w < 1.0, group(win_i[:, nt:], win_j[:, nt:],
                                     s_si, q_si, s_sj, q_sj), 0.0)
    return (sim_t * w + sim_s * (1.0 - w)).astype(jnp.float32)
