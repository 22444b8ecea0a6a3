"""Fused feature-extraction front-end (framed STFT → MFCC + sones).

JAX replacement for the reference's scsynth NRT render
(impl/NonRealtimeProcessor.scala, impl/FeatureExtractionImpl.scala:40-55): no
subprocess, no OSC file — one jitted XLA pipeline per block of frames:

    frames → Hann window → rFFT power → ┬→ mel(42) → log10 → DCT → scale   (MFCC)
                                        └→ ERB(42) bands → dB → smask →
                                           tmask → contours (dB→phon) →
                                           phon→sone → Σ → /32              (loudness)

The MFCC and loudness paths transcribe SuperCollider's ``MFCC``/``Loudness``
UGens (server/plugins/ML.cpp — see dsp/constants.py, dsp/ml_tables.py and
docs/ML_DERIVATION.md for the constant-by-constant derivation).

Frame timing replicates the NRT graph's Impulse/Stepper capture semantics
(NonRealtimeProcessor.scala:81-117) including the dropped first frame
(:107-109): the feature file holds ``ceil(inFrames/step) − 1`` frames, and
output frame ``j`` is the window covering samples
``[(j+1)·step − fftSize, (j+1)·step)`` (zero-padded at signal edges, matching
scsynth's initially-zero FFT buffer).

Frames are processed in fixed-size blocks (bounded HBM, one jit
specialization).  The only cross-frame state is temporal masking, which
depends on exactly the previous frame's excitation — the carry across
blocks is that single 42-band vector, making results bit-independent of the
block plan (streaming vs whole-file vs batch produce identical features up
to elementwise f32 rounding).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Tuple

from ..runtime.platform import configure as _configure_platform

_configure_platform()

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from . import ml_tables as T

__all__ = ["FrontendBasis", "extract_features", "extract_features_batch",
           "extract_features_streaming", "finalize_features",
           "num_output_frames", "stage_resident_batch", "BLOCK_FRAMES"]

#: Frames per device block (≈ 24s of audio at the default resolution).
BLOCK_FRAMES = 2048


def num_output_frames(in_frames: int, step_size: int) -> int:
    """Feature-file frame count: ``ceil(inFrames/step) − 1``
    (NonRealtimeProcessor.scala:93 with the first frame dropped :107-109)."""
    out = (in_frames + step_size - 1) // step_size
    return max(out - 1, 0)


# ---------------------------------------------------------------------------
# host-side basis construction (float64, cached)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FrontendBasis:
    """Per-(sample_rate, fft_size, num_coeffs) constant matrices (float32)."""

    sample_rate: float
    fft_size: int
    num_coeffs: int
    hann: np.ndarray          # [fft_size]
    mel_fb: np.ndarray        # [bins, MEL_BANDS]  power → mel energies
    dct: np.ndarray           # [MEL_BANDS, num_coeffs]
    erb_fb: np.ndarray        # [bins, ERB_BANDS]  0/1 band partition
    power_cal_db: float       # calibration: full-scale 1kHz sine band → 90 dB
    contours_ext: np.ndarray  # [ERB_BANDS, 12] dB of each phon contour (+extrap)
    phons_ext: np.ndarray     # [12] phon levels matching contours_ext
    thresh_db: np.ndarray     # [ERB_BANDS] audibility threshold (2-phon row)


@lru_cache(maxsize=32)
def make_basis(sample_rate: float, fft_size: int, num_coeffs: int) -> FrontendBasis:
    bins = fft_size // 2 + 1
    freqs = np.arange(bins) * (sample_rate / fft_size)

    # Hann window (SC FFT winType 1, FeatureExtractionImpl.scala:38)
    n = np.arange(fft_size)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / fft_size)

    # --- MFCC mel filterbank: 42 triangles equally spaced in mel over
    # [0, Nyquist] (44 edges at i·mel(nyq)/43), peak 1 — ML.cpp's layout
    mel_hi = C.mel_of_hz(sample_rate / 2.0)
    edges = C.hz_of_mel(np.linspace(C.mel_of_hz(C.MEL_FMIN), mel_hi,
                                    C.MEL_BANDS + 2))
    mel_fb = np.zeros((bins, C.MEL_BANDS))
    for b in range(C.MEL_BANDS):
        lo, ctr, hi = edges[b], edges[b + 1], edges[b + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - freqs) / max(hi - ctr, 1e-9)
        mel_fb[:, b] = np.clip(np.minimum(up, down), 0.0, 1.0)

    # --- DCT-II, coefficients DCT_FIRST_COEFF .. (+num_coeffs) --------------
    b_idx = np.arange(C.MEL_BANDS)
    j_idx = np.arange(C.DCT_FIRST_COEFF, C.DCT_FIRST_COEFF + num_coeffs)
    dct = np.sqrt(2.0 / C.MEL_BANDS) * np.cos(
        np.pi / C.MEL_BANDS * np.outer(b_idx + 0.5, j_idx))

    # --- Loudness ERB band partition (ML.cpp eqlbandbins) --------------------
    band_edges = T.erb_band_edges(float(sample_rate), fft_size)
    erb_fb = np.zeros((bins, T.ERB_BANDS))
    for k in range(T.ERB_BANDS):
        erb_fb[band_edges[k]:band_edges[k + 1], k] = 1.0

    # --- equal-loudness contours at band centres, + linear extrapolation
    # point above the 100-phon contour so loud signals keep a defined slope
    contours = T.contour_table(float(sample_rate), fft_size)
    ext = contours[:, -1] + 4.0 * (contours[:, -1] - contours[:, -2])
    contours_ext = np.concatenate([contours, ext[:, None]], axis=1)
    phons_ext = np.concatenate([T.PHONS, [140.0]])

    # --- calibration: the ERB band containing a full-scale 1 kHz sine reads
    # FULL_SCALE_DB (→ ~90 phon → 32 sones, the /32 headroom)
    k = 1000.0 * fft_size / sample_rate
    phase = 2.0 * np.pi * k * n / fft_size
    spec_pow = np.abs(np.fft.rfft(np.sin(phase) * hann)) ** 2
    band_1k = int(np.searchsorted(band_edges, k, side="right")) - 1
    band_1k = min(max(band_1k, 0), T.ERB_BANDS - 1)
    peak_band_power = float(
        spec_pow[band_edges[band_1k]:band_edges[band_1k + 1]].sum())
    power_cal_db = C.FULL_SCALE_DB - 10.0 * np.log10(peak_band_power)

    return FrontendBasis(
        sample_rate=float(sample_rate), fft_size=fft_size, num_coeffs=num_coeffs,
        hann=hann.astype(np.float32),
        mel_fb=mel_fb.astype(np.float32),
        dct=dct.astype(np.float32),
        erb_fb=erb_fb.astype(np.float32),
        power_cal_db=float(power_cal_db),
        contours_ext=contours_ext.astype(np.float32),
        phons_ext=phons_ext.astype(np.float32),
        thresh_db=contours[:, 0].astype(np.float32),
    )


# ---------------------------------------------------------------------------
# device pipeline
# ---------------------------------------------------------------------------

def _frame_block(audio: jnp.ndarray, num_frames: int, fft_size: int,
                 step: int) -> jnp.ndarray:
    """Slice ``audio`` (length ``(num_frames−1)·step + fft_size``) into
    ``[num_frames, fft_size]`` hop-``step`` windows without a gather when
    ``step`` divides ``fft_size`` (the fftOverlap ∈ ℕ case)."""
    if fft_size % step == 0:
        k = fft_size // step
        chunks = audio.reshape(-1, step)          # [num_frames + k - 1, step]
        parts = [chunks[i:i + num_frames] for i in range(k)]
        return jnp.concatenate(parts, axis=1)
    idx = (jnp.arange(num_frames)[:, None] * step
           + jnp.arange(fft_size)[None, :])
    return audio[idx]


def _block_pipeline(audio: jnp.ndarray, carry: jnp.ndarray,
                    hann: jnp.ndarray, mel_fb: jnp.ndarray, dct: jnp.ndarray,
                    erb_fb: jnp.ndarray, power_cal_db: jnp.ndarray,
                    contours_ext: jnp.ndarray, phons_ext: jnp.ndarray,
                    thresh_db: jnp.ndarray,
                    smask: jnp.ndarray, tmask: jnp.ndarray,
                    num_frames: int, fft_size: int, step: int,
                    use_fft: bool = True,
                    valid_frames=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One block: audio slice → ``[num_coeffs+1, num_frames]`` features.

    ``carry``: the previous frame's spectrally-masked band excitation (dB,
    [ERB_BANDS]) — temporal masking's only state; returns the updated carry.

    ``valid_frames`` (traced scalar, optional): real frames in this block.
    When given, the returned carry is the excitation at the last VALID
    frame (padded-silence frames pass the state through), so carries stay
    exact under any padded shape plan; valid frames' features are
    unaffected either way (the recursion is forward-only).
    """
    _hi = jax.lax.Precision.HIGHEST
    # raw-int16 shipping is a pipeline-wide property (module docstring), so
    # the dequantize must live at every device entry: without this, int16
    # fed straight to the jitted _extract_block (the driver compile-check /
    # hypothesis entry) would promote UN-normalized into the hann multiply
    # — features ~90 dB hot with no error.  _extract_scan dequantizes the
    # whole padded buffer up front (cheaper: overlaps dequantize once), so
    # this is a no-op on that path.
    if audio.dtype == jnp.int16:
        audio = audio.astype(jnp.float32) * (1.0 / 32768.0)
    frames = _frame_block(audio, num_frames, fft_size, step) * hann[None, :]
    if use_fft:
        spec = jnp.fft.rfft(frames, axis=1)
        power = (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2).astype(jnp.float32)
    else:  # GEMM-native DFT (MXU path; numerically ~f32-FFT with HIGHEST)
        bins = fft_size // 2 + 1
        wn = (2.0 * np.pi / fft_size) * np.outer(np.arange(fft_size),
                                                 np.arange(bins))
        cos_m = jnp.asarray(np.cos(wn), dtype=jnp.float32)
        sin_m = jnp.asarray(np.sin(wn), dtype=jnp.float32)
        re = jnp.matmul(frames, cos_m, precision=_hi)
        im = jnp.matmul(frames, sin_m, precision=_hi)
        power = re * re + im * im

    # ---- MFCC (ML.cpp, Dan Stowell) ----------------------------------------
    # band input: power (shipped hypothesis) vs magnitude — a structural
    # C-grade choice under experimental discrimination (constants.py
    # HYPOTHESES; tools/discriminate_constants.py)
    band_in = power if C.MEL_BAND_INPUT == "power" else jnp.sqrt(power)
    mel_e = jnp.matmul(band_in, mel_fb, precision=_hi)       # [F, 42]
    log_e = jnp.log10(jnp.maximum(mel_e, C.MEL_LOG_FLOOR))
    coeffs = (jnp.matmul(log_e, dct, precision=_hi)
              * C.MFCC_SCALE + C.MFCC_OFFSET)                # [F, num_coeffs]

    # ---- Loudness (ML.cpp, Nick Collins) -----------------------------------
    # banded power → dB, clamped at 0 dB (inaudible floor; every contour
    # threshold sits above 0.1 dB, so digital silence yields 0 sones)
    band_p = jnp.matmul(power, erb_fb, precision=_hi)        # [F, 42]
    band_db = jnp.maximum(10.0 * jnp.log10(jnp.maximum(band_p, 1e-30))
                          + power_cal_db, 0.0)

    # spectral masking: lower bands mask higher ones — excitation
    # e_k = max(db_k, e_{k-1}·smask) in the shipped "factor_db" form,
    # unrolled over the 42 bands (cheap elementwise chain; deterministic
    # order → plan-invariant).  The "factor_intensity" candidate scales the
    # masker's intensity instead: e_k = max(db_k, e_{k-1} + 10·log10 smask).
    cols = []
    prev = jnp.zeros_like(band_db[:, 0])
    if C.SMASK_FORM == "factor_db":
        for k in range(T.ERB_BANDS):
            prev = jnp.maximum(band_db[:, k], prev * smask)
            cols.append(prev)
    else:  # factor_intensity
        skirt = 10.0 * jnp.log10(jnp.maximum(smask, 1e-10))
        for k in range(T.ERB_BANDS):
            prev = jnp.maximum(band_db[:, k], prev + skirt)
            cols.append(prev)
    exc = jnp.stack(cols, axis=1)                            # [F, 42]

    # temporal masking: a frame masks its successor — shipped "prev_frame"
    # form m_t = max(e_t, e_{t-1}·tmask): state is exactly one frame deep.
    # The "feedback" candidate feeds the masked output back
    # (m_t = max(e_t, m_{t-1}·tmask) — a sequential scan over frames).
    def _carry_at_valid(rows, full_last):
        if valid_frames is None:
            return full_last
        last = jnp.clip(valid_frames - 1, 0, rows.shape[0] - 1)
        return jnp.where(valid_frames > 0,
                         jax.lax.dynamic_index_in_dim(rows, last, axis=0,
                                                      keepdims=False),
                         carry)

    if C.TMASK_FORM == "prev_frame":
        prev_exc = jnp.concatenate([carry[None, :], exc[:-1]], axis=0)
        masked = jnp.maximum(exc, prev_exc * tmask)
        new_carry = _carry_at_valid(exc, exc[-1])
    else:  # feedback
        def tstep(m_prev, e_t):
            m_t = jnp.maximum(e_t, m_prev * tmask)
            return m_t, m_t
        carry_full, masked = jax.lax.scan(tstep, carry, exc)
        new_carry = _carry_at_valid(masked, carry_full)

    # dB → phon via the band's equal-loudness contour (linear interpolation
    # across the 11 tabulated levels, extrapolated above 100 phon); bands
    # below their 2-phon threshold are inaudible.  Branchless gather-free
    # piecewise-linear form — equivalent to jnp.interp for the strictly
    # increasing contour rows, without interp's searchsorted lowering
    # (a gather per element; this is a sum of clipped segments)
    dc = contours_ext[:, 1:] - contours_ext[:, :-1]          # [42, S]
    dp = phons_ext[1:] - phons_ext[:-1]                      # [S]
    seg = jnp.clip((masked[:, :, None] - contours_ext[None, :, :-1])
                   / dc[None, :, :], 0.0, 1.0)               # [F, 42, S]
    phon = phons_ext[0] + (seg * dp[None, None, :]).sum(axis=-1)
    sones = jnp.where(masked > thresh_db[None, :],
                      jnp.exp2((phon - C.SONE_PIVOT_PHON) * 0.1), 0.0)
    loud = sones.sum(axis=1) / 32.0                          # [F]

    feats = jnp.concatenate([loud[:, None], coeffs], axis=1).T  # [C, F]
    return feats.astype(jnp.float32), new_carry


#: jitted single-block entry (used by the driver's compile check)
_extract_block = partial(jax.jit, static_argnames=(
    "num_frames", "fft_size", "step", "use_fft"))(_block_pipeline)


@partial(jax.jit, static_argnames=("num_blocks", "block", "fft_size", "step",
                                   "use_fft"))
def _extract_scan(padded_audio: jnp.ndarray, carry0: jnp.ndarray,
                  hann, mel_fb, dct, erb_fb, power_cal_db, contours_ext,
                  phons_ext, thresh_db, smask, tmask,
                  num_blocks: int, block: int, fft_size: int, step: int,
                  use_fft: bool = True, total_frames=None) -> jnp.ndarray:
    """Whole file (or chunk) in ONE dispatch: ``lax.scan`` over fixed-size
    blocks with the temporal-masking carry threaded through.
    ``padded_audio`` length is ``num_blocks·block·step + fft_size − step``.
    Returns ``([num_blocks, C, block]`` features (trim on host), carry).

    ``total_frames`` (traced, optional): the real frame count — makes the
    returned carry the excitation at frame ``total_frames − 1`` regardless
    of the plan's padding (callers that discard the carry can omit it and
    keep their jit keys)."""
    span = (block - 1) * step + fft_size

    # int16 inputs are shipped raw (half the host→device bytes for PCM16
    # sources, bit-exact) and dequantized here on the VPU
    if padded_audio.dtype == jnp.int16:
        padded_audio = padded_audio.astype(jnp.float32) * (1.0 / 32768.0)

    def body(carry, i):
        sl = jax.lax.dynamic_slice(padded_audio, (i * (block * step),), (span,))
        vf = None if total_frames is None else \
            jnp.clip(total_frames - i * block, 0, block)
        feats, carry = _block_pipeline(
            sl, carry, hann, mel_fb, dct, erb_fb, power_cal_db,
            contours_ext, phons_ext, thresh_db, smask, tmask,
            num_frames=block, fft_size=fft_size, step=step,
            use_fft=use_fft, valid_frames=vf)
        return carry, feats

    carry, feats = jax.lax.scan(body, carry0, jnp.arange(num_blocks))
    return feats, carry


@partial(jax.jit, static_argnames=("num_blocks", "block", "fft_size", "step",
                                   "use_fft"))
def _extract_scan_batch(padded_b: jnp.ndarray, carry_b: jnp.ndarray,
                        hann, mel_fb, dct, erb_fb, power_cal_db, contours_ext,
                        phons_ext, thresh_db, smask, tmask,
                        num_blocks: int, block: int, fft_size: int,
                        step: int, use_fft: bool = True):
    """vmap of :func:`_extract_scan` over a files axis: ``padded_b``
    ``[B, Tp]`` → (``[B, num_blocks, C, block]``, carries ``[B, bands]``).
    Shardable over a ``files`` mesh axis (see parallel/sweep.py)."""
    def one(a, c):
        return _extract_scan(a, c, hann, mel_fb, dct, erb_fb,
                             power_cal_db, contours_ext, phons_ext,
                             thresh_db, smask, tmask, num_blocks=num_blocks, block=block,
                             fft_size=fft_size, step=step, use_fft=use_fft)

    return jax.vmap(one)(padded_b, carry_b)


def stage_resident_batch(audios, sample_rate: float, num_coeffs: int = 13,
                         fft_size: int = 1024, fft_overlap: int = 2,
                         smask: float = C.SPECTRAL_MASK_DEFAULT,
                         tmask: float = C.TEMPORAL_MASK_DEFAULT,
                         block_frames: int = BLOCK_FRAMES,
                         mesh=None):
    """Stage a batch for :func:`_extract_scan_batch` on the PRODUCTION
    layout: padded rows uploaded, zero carries, device constants, and the
    shape plan — ``(x_dev, carry0, consts, block, num_blocks)``.
    :func:`extract_features_batch` runs through this, and the
    resident-compute bench (bench.py) stages with it so it always times
    the exact layout production compiles.

    With ``mesh`` (a ``files``-axis :class:`jax.sharding.Mesh`) the batch
    is padded with 1-sample silent rows to a device-count multiple and the
    rows/carries are placed sharded over the mesh — the returned batch
    dimension is then the PADDED count (callers slice their real rows)."""
    step = fft_size // fft_overlap
    audios = [np.asarray(a) for a in audios]
    if mesh is not None:
        pad_b = (-len(audios)) % mesh.devices.size
        if pad_b:
            pad_dtype = np.int16 if all(
                a.dtype == np.int16 for a in audios) else np.float32
            audios += [np.zeros(1, pad_dtype)] * pad_b
    total_max = max(num_output_frames(len(a), step) for a in audios)
    consts = _device_consts(float(sample_rate), fft_size, num_coeffs,
                            float(smask), float(tmask))
    block, num_blocks = _plan_shapes(total_max, block_frames)
    left_pad = fft_size - step
    padded_len = num_blocks * block * step + fft_size - step
    dtype = np.int16 if all(a.dtype == np.int16 for a in audios) else np.float32
    # np.empty + explicit pad-region zeroing: the rows are mostly payload,
    # so zeroing the whole buffer first would double host memory traffic
    # (tens of ms per 100 MB batch on the bench path)
    padded = np.empty((len(audios), padded_len), dtype)
    padded[:, :left_pad] = 0
    for i, a in enumerate(audios):
        if dtype == np.float32 and a.dtype == np.int16:
            a = a.astype(np.float32) / 32768.0  # dequantize mixed batches
        n = min(len(a), padded_len - left_pad)
        padded[i, left_pad:left_pad + n] = a[:n]
        padded[i, left_pad + n:] = 0
    carry0 = jnp.zeros((len(audios), T.ERB_BANDS), dtype=jnp.float32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        shard = NamedSharding(mesh, P("files"))
        return (jax.device_put(padded, shard), jax.device_put(carry0, shard),
                consts, block, num_blocks)
    return jax.device_put(padded), carry0, consts, block, num_blocks


def extract_features_batch(audios, sample_rate: float, num_coeffs: int = 13,
                           fft_size: int = 1024, fft_overlap: int = 2,
                           smask: float = C.SPECTRAL_MASK_DEFAULT,
                           tmask: float = C.TEMPORAL_MASK_DEFAULT,
                           block_frames: int = BLOCK_FRAMES,
                           as_device: bool = False, mesh=None):
    """Batch extraction: list of equal-rate mono signals → ``[B, C, F_max]``
    features (each file's valid length is ``num_output_frames(len_i, step)``;
    the tail beyond it holds silence features).  One device dispatch for the
    whole batch — the 1k-file sweep path.

    With ``as_device=True`` returns the async device handle
    ``([B, nb, C, block], per-file frame totals)`` so callers can overlap
    host work (e.g. a live per-file transcript) with the device compute and
    fetch per-file slices via :func:`finalize_features`.

    With ``mesh`` (a ``files``-axis mesh, :func:`parallel.sweep.
    make_files_mesh`) the files axis shards over the devices (data
    parallel — SURVEY §2.3); the batch is internally padded with silent
    rows to a device-count multiple.  The host-path result is trimmed back
    to ``len(audios)`` rows; the ``as_device`` handle keeps the padded
    rows (like the callers' own power-of-two batch padding) while
    ``totals`` stays one entry per REAL file."""
    step = fft_size // fft_overlap
    audios = [np.asarray(a) for a in audios]
    if not audios:
        empty = np.zeros((0, num_coeffs + 1, 0), np.float32)
        return (empty, []) if as_device else empty
    totals = [num_output_frames(len(a), step) for a in audios]
    total_max = max(totals)
    if total_max == 0:
        if as_device:
            # block-shaped like the device handle so finalize_features works
            return np.zeros((len(audios), 1, num_coeffs + 1, 0),
                            np.float32), totals
        return np.zeros((len(audios), num_coeffs + 1, 0), np.float32)
    x_dev, carry0, consts, block, num_blocks = stage_resident_batch(
        audios, sample_rate, num_coeffs=num_coeffs, fft_size=fft_size,
        fft_overlap=fft_overlap, smask=smask, tmask=tmask,
        block_frames=block_frames, mesh=mesh)
    feats, _ = _extract_scan_batch(
        x_dev, carry0, *consts,
        num_blocks=num_blocks, block=block, fft_size=fft_size, step=step)
    if as_device:
        return feats, totals
    out = np.asarray(feats)  # [Bp, nb, C, block]
    out = out.transpose(0, 2, 1, 3).reshape(out.shape[0], num_coeffs + 1, -1)
    return out[:len(audios), :, :total_max].copy()


def _bucket_blocks(n: int) -> int:
    """Round block counts up geometrically to bound jit specializations."""
    b = 1
    while b < n:
        b = max(b + 1, int(b * 1.3))
    return b


def _plan_shapes(total: int, block_frames: int):
    """Choose (block, num_blocks) minimizing padded frames ≥ total."""
    best = None
    for block in (block_frames, block_frames // 2, block_frames // 4,
                  block_frames // 8):
        block = max(block, 256)
        nb = _bucket_blocks((total + block - 1) // block)
        padded = nb * block
        if best is None or padded < best[2]:
            best = (block, nb, padded)
    return best[0], best[1]


@lru_cache(maxsize=64)
def _device_consts(sample_rate: float, fft_size: int, num_coeffs: int,
                   smask: float, tmask: float):
    """Basis matrices + scalars staged on device once per process, so
    constants are not re-shipped per call."""
    basis = make_basis(sample_rate, fft_size, num_coeffs)
    return (jnp.asarray(basis.hann), jnp.asarray(basis.mel_fb),
            jnp.asarray(basis.dct), jnp.asarray(basis.erb_fb),
            jnp.float32(basis.power_cal_db),
            jnp.asarray(basis.contours_ext), jnp.asarray(basis.phons_ext),
            jnp.asarray(basis.thresh_db), jnp.float32(smask),
            jnp.float32(tmask))


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

def extract_features(audio: np.ndarray, sample_rate: float,
                     num_coeffs: int = 13, fft_size: int = 1024,
                     fft_overlap: int = 2,
                     smask: float = C.SPECTRAL_MASK_DEFAULT,
                     tmask: float = C.TEMPORAL_MASK_DEFAULT,
                     block_frames: int = BLOCK_FRAMES,
                     progress=None, as_device: bool = False,
                     carry=None, return_carry: bool = False):
    """Extract ``[num_coeffs+1, F]`` features (row 0 = loudness/32, rows 1.. =
    MFCC) from a mono float32 signal.

    ``F = ceil(len(audio)/step) − 1`` with the reference's frame alignment
    (see module docstring).  ``progress`` is an optional callable invoked
    ONCE with 1.0 after the fetch completes — the whole file is one fused
    dispatch, so there is no intermediate granularity to report (and no
    host involvement an abort could interrupt mid-render; callers needing
    incremental progress/abort use :func:`extract_features_streaming`,
    which reports per chunk).

    ``audio`` may be float32 (values in ±1) or int16 (raw PCM16 samples) —
    the int16 path halves the host→device transfer and dequantizes by
    1/32768 on device, bit-identical to the float path for PCM16 sources.
    """
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32, copy=False)
    audio = audio.reshape(-1)
    step = fft_size // fft_overlap
    if carry is None:
        carry = jnp.zeros((T.ERB_BANDS,), dtype=jnp.float32)
    total = num_output_frames(len(audio), step)
    if total == 0:
        empty = np.zeros((num_coeffs + 1, 0), dtype=np.float32)
        return (empty, carry) if return_carry else empty

    consts = _device_consts(float(sample_rate), fft_size, num_coeffs,
                            float(smask), float(tmask))

    # shape plan: whole file in one dispatch (one h2d, one d2h); candidate
    # block sizes × bucketed block counts keep the jit key space small while
    # minimizing padded transfer bytes
    block, num_blocks = _plan_shapes(total, block_frames)

    # window j covers [(j+1)·step − fft_size, (j+1)·step): left-pad by
    # fft_size − step so window j = padded[j·step : j·step + fft_size]
    left_pad = fft_size - step
    padded_len = num_blocks * block * step + fft_size - step
    # np.empty + explicit pad-region zeroing (stage_resident_batch's rule:
    # zeroing the whole buffer first doubles host memory traffic)
    padded = np.empty(padded_len, audio.dtype)
    padded[:left_pad] = 0
    n_copy = min(len(audio), padded_len - left_pad)
    padded[left_pad:left_pad + n_copy] = audio[:n_copy]
    padded[left_pad + n_copy:] = 0

    feats, carry_out = _extract_scan(
        jax.device_put(padded), carry, *consts,
        num_blocks=num_blocks, block=block, fft_size=fft_size, step=step,
        # with a padded plan the raw last-block carry would be the PADDED
        # silence's excitation; the valid-frame capture keeps it exact
        total_frames=jnp.int32(total) if return_carry else None)
    if as_device:
        # async handle: [num_blocks, C, block] device array + true length;
        # lets batch pipelines overlap the next file's upload with this
        # file's compute (finish with finalize_features)
        return (feats, total, carry_out) if return_carry else (feats, total)
    out = finalize_features(feats, total)
    if progress is not None:
        progress(1.0)
    return (out, carry_out) if return_carry else out


def finalize_features(feats, total: int) -> np.ndarray:
    """Fetch + reshape a device result from ``extract_features(as_device=True)``."""
    out = np.asarray(feats).transpose(1, 0, 2).reshape(feats.shape[1], -1)
    return out[:, :total].copy()


def extract_features_streaming(read_samples, num_samples: int,
                               sample_rate: float,
                               emit, num_coeffs: int = 13,
                               fft_size: int = 1024, fft_overlap: int = 2,
                               smask: float = C.SPECTRAL_MASK_DEFAULT,
                               tmask: float = C.TEMPORAL_MASK_DEFAULT,
                               chunk_frames: int = 16384,
                               progress=None) -> int:
    """Bounded-memory extraction for arbitrarily long inputs.

    ``read_samples(n)`` returns the next ≤ n mono samples (float32 or raw
    int16); short reads are fine — the loop keeps requesting until it has
    the samples a chunk needs (an empty return means EOF and the remainder
    is treated as silence, like the reference's zero-filled final buffer).
    A source may even switch from int16 to float mid-stream (the pipeline
    degrades to the float domain from there on).  ``emit(feats)`` receives
    consecutive ``[C, nc]`` feature chunks (e.g. an
    :class:`io.audiofile.AudioFileWriter`).  The temporal-masking carry is
    threaded across chunks, and ``chunk_frames`` is kept a multiple of 1024
    so the NaN-fixup state resets land on the same boundaries as the
    whole-file path (NonRealtimeProcessor.scala:178-190 parity).

    Returns the number of feature frames produced
    (``ceil(num_samples/step) − 1``).
    """
    step = fft_size // fft_overlap
    total = num_output_frames(num_samples, step)
    if total == 0:
        return 0
    chunk_frames = max(1024, (chunk_frames // 1024) * 1024)
    consts = _device_consts(float(sample_rate), fft_size, num_coeffs,
                            float(smask), float(tmask))
    carry = jnp.zeros((T.ERB_BANDS,), dtype=jnp.float32)

    overlap = fft_size - step          # samples shared between chunks
    tail = None                        # zeros: scsynth's initial buffer
    done = 0
    consumed = 0                        # samples pulled from read_samples
    eof = False

    def _read_exact(n: int):
        """Gather exactly ``n`` samples across short reads; zero-pad past
        EOF so chunk alignment never drifts."""
        nonlocal consumed, eof, tail
        parts = []
        got = 0
        while got < n and not eof:
            piece = np.asarray(read_samples(n - got))
            if piece.size == 0:
                eof = True
                break
            if piece.dtype != np.int16:
                piece = piece.astype(np.float32, copy=False)
            if parts and piece.dtype != parts[0].dtype or (
                    tail is not None and piece.dtype != tail.dtype):
                # mid-stream int16→float switch: move everything to the
                # float domain (dequantize raw PCM by 1/32768)
                def to_f32(a):
                    return (a.astype(np.float32) / 32768.0
                            if a.dtype == np.int16
                            else a.astype(np.float32, copy=False))
                parts = [to_f32(p) for p in parts]
                piece = to_f32(piece)
                if tail is not None:
                    tail = to_f32(tail)
            parts.append(piece)
            got += len(piece)
        consumed += got
        if not parts:
            dtype = tail.dtype if tail is not None else np.float32
            return np.zeros(0, dtype)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    while done < total:
        nc = min(chunk_frames, total - done)
        # frames [done, done+nc): windows end at (done+1..done+nc)·step,
        # needing samples [done·step − overlap, (done+nc−1)·step + fft)
        need_to = (done + nc) * step
        fresh = _read_exact(need_to - consumed)
        if tail is None:
            tail = np.zeros(overlap, fresh.dtype)
        # (no dtype reconciliation needed here: _read_exact already moves
        # the carried tail to float32 on a mid-stream int16→float switch)

        block, num_blocks = _plan_shapes(nc, chunk_frames)
        padded_len = num_blocks * block * step + fft_size - step
        # np.empty + tail-region zeroing: a full np.zeros memset per 16384-
        # frame chunk doubles host memory traffic on an arbitrarily long
        # stream (stage_resident_batch's rule)
        padded = np.empty(padded_len, tail.dtype)
        padded[:overlap] = tail
        padded[overlap:overlap + len(fresh)] = fresh
        padded[overlap + len(fresh):] = 0

        feats, carry = _extract_scan(
            jax.device_put(padded), carry, *consts,
            num_blocks=num_blocks, block=block, fft_size=fft_size, step=step,
            total_frames=jnp.int32(nc))   # exact carry for the next chunk
        emit(finalize_features(feats, nc))

        # next chunk's first window needs the last `overlap` samples before
        # need_to.  In the steady state those all sit inside `fresh`
        # (nc·step ≥ overlap because step·1 = overlap) — slice them out
        # directly instead of re-concatenating the whole ~nc·step chunk
        # just to keep 2 KB; only an EOF short read rebuilds the small
        # zero-extended join (the stream starts at done·step − overlap)
        span = nc * step + overlap
        if len(fresh) >= nc * step and nc * step >= overlap:
            # (the second guard matters for fft_overlap > 2, where a short
            # final chunk can have nc·step < overlap — a negative slice
            # start would silently wrap)
            tail = fresh[nc * step - overlap:nc * step].copy()
        else:
            joined = np.concatenate(
                [tail, fresh, np.zeros(max(0, span - len(tail) - len(fresh)),
                                       tail.dtype)])
            tail = joined[span - overlap:span].copy()
        done += nc
        if progress is not None:
            progress(done / total)
    return total
