"""Multi-chip batch sweeps (the framework's data-parallel layer).

The reference processes database files strictly sequentially on one thread
(FeatureCorrelationImpl.scala:161, README.md:83).  Here the per-file sliding
correlation is *batched* (one leading files axis) and sharded over a
``jax.sharding.Mesh`` axis ``"files"``: each chip computes the dense
(sim, boost) traces and a per-file device top-k for its shard of the
database; the only cross-chip communication is the implicit all-gather when
the small ``[B, K]`` top-k results are fetched — cheap over the device interconnect by
construction (SURVEY §2.3's rebuild decision).

Exact match selection still runs on host over the returned traces (the
reference's priority/collapse semantics are inherently sequential); the
device top-k is used by pipelines that only need best-candidates (bench,
sweep tooling).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kernels import corr as K

__all__ = ["make_files_mesh", "env_mesh", "batched_correlation_traces",
           "sharded_sweep_step", "pad_stack", "sharded_long_file_trace",
           "sharded_extract_long", "batched_novelty_traces",
           "sharded_long_novelty_trace"]


def make_files_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name ``files``."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), axis_names=("files",))


def env_mesh() -> Optional[Mesh]:
    """``STRUGATZKI_MESH=1``: a files mesh over all attached devices when
    more than one exists — the CLI's opt-in multi-chip gate.  ``None``
    (the default, and always on a one-chip host) keeps the single-device
    programs and their compile cache untouched (every new jit key is a
    fresh compile)."""
    import os
    # conventional "off" spellings disable too: a user exporting
    # STRUGATZKI_MESH=0 must get the single-device programs
    if os.environ.get("STRUGATZKI_MESH", "").strip().lower() in (
            "", "0", "false", "no", "off"):
        return None
    if len(jax.devices()) <= 1:
        return None
    return make_files_mesh()


def pad_stack(mats: Sequence[np.ndarray], pad_value: float = 0.0,
              multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ``[C, T_i]`` matrices into ``[B, C, T_max]`` plus lengths."""
    t_max = max(m.shape[1] for m in mats)
    t_max = ((t_max + multiple - 1) // multiple) * multiple
    out = np.full((len(mats), mats[0].shape[0], t_max), pad_value, np.float32)
    lens = np.zeros(len(mats), np.int32)
    for i, m in enumerate(mats):
        out[i, :, :m.shape[1]] = m
        lens[i] = m.shape[1]
    return out, lens


@partial(jax.jit, static_argnames=("num_temporal",))
def _batched_traces(xs_b, tmpl_t, tmpl_s, a_std_t, a_std_s,
                    ln_avg, shifts_t, temp_weight, max_boost,
                    num_temporal: int = 1):
    """vmap of kernels.corr.correlation_trace over the files axis.

    ``xs_b``: ``[B, C, Tp]`` prepared features; ``shifts_t``: ``[B]`` per-file
    temporal shifts.  Returns ``(sims [B, W], boosts [B, W])``.
    """
    def one(xs, shift_t):
        return K.correlation_trace(
            xs, tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg, shift_t,
            temp_weight, max_boost, num_temporal=num_temporal)

    return jax.vmap(one)(xs_b, shifts_t)


def batched_correlation_traces(xs_b: np.ndarray, shifts_t: np.ndarray,
                               template, temp_weight: float, max_boost: float,
                               mesh: Optional[Mesh] = None):
    """Dense traces for a whole padded batch, optionally sharded over
    ``mesh`` axis ``files`` (a batch that doesn't divide the device count
    is zero-padded to a mesh multiple and the pad rows trimmed, like
    :func:`batched_novelty_traces`).  ``template`` is an
    ``analysis.correlation.InputTemplate``."""
    xs_b = np.asarray(xs_b)
    shifts_np = np.asarray(shifts_t, dtype=np.float32)
    b = xs_b.shape[0]
    if mesh is not None:
        pad_rows = -b % mesh.devices.size
        if pad_rows:
            xs_b = np.concatenate(
                [xs_b, np.zeros((pad_rows,) + xs_b.shape[1:], xs_b.dtype)])
            shifts_np = np.concatenate(
                [shifts_np, np.zeros(pad_rows, np.float32)])
    # device_temporal/device_spectral are the per-template upload caches
    # (each fresh host→device constant is an upload of its own)
    args = (template.device_temporal(), template.device_spectral(),
            jnp.float32(template.temporal_std),
            jnp.float32(template.spectral_std),
            jnp.float32(template.ln_avg_loudness),
            jnp.asarray(shifts_np),
            jnp.float32(temp_weight), jnp.float32(max_boost))
    if mesh is None:
        sims, boosts = _batched_traces(jnp.asarray(xs_b), *args,
                                       num_temporal=template.num_temporal)
    else:
        fn = _sharded_traces_fn(mesh)
        # shard straight from host memory — an eager jnp.asarray would
        # commit the whole stack to device 0 first; shifts match the
        # wrapper's sharded in_sharding the same way
        xs_s = jax.device_put(xs_b, NamedSharding(mesh, P("files")))
        args = args[:5] + (jax.device_put(
            shifts_np, NamedSharding(mesh, P("files"))),) + args[6:]
        # positional: pjit rejects kwargs when in_shardings is specified
        # (num_temporal is static, so it is not part of the shardings tuple)
        sims, boosts = fn(xs_s, *args, template.num_temporal)
    return np.asarray(sims)[:b], np.asarray(boosts)[:b]


_SHARDED_TRACES_CACHE: dict = {}


def _sharded_traces_fn(mesh: Mesh):
    """Build-once cached pjit wrapper per mesh (a fresh jax.jit per call
    would bypass the dispatch fastpath — and any cache miss is a fresh
    compile)."""
    key = tuple(d.id for d in mesh.devices.flat)
    fn = _SHARDED_TRACES_CACHE.get(key)
    if fn is None:
        shard = NamedSharding(mesh, P("files"))
        repl = NamedSharding(mesh, P())
        fn = jax.jit(
            _batched_traces,
            in_shardings=(shard, repl, repl, repl, repl, repl, shard,
                          repl, repl),
            out_shardings=(shard, shard),
            static_argnames=("num_temporal",))
        _SHARDED_TRACES_CACHE[key] = fn
    return fn


def sharded_long_file_trace(xs: np.ndarray, shift_t: float, template,
                            temp_weight: float, max_boost: float,
                            mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Correlation trace of ONE very long file, time axis sharded over the
    mesh — the framework's sequence/context-parallel dimension (SURVEY §5's
    ring-buffer streaming analog).

    Window starts are split into contiguous per-chip ranges; each shard
    receives its slab plus the ``L − 1``-frame halo so every window is
    computed locally (no collectives in the hot path — only the trace
    gather on fetch).  Results match the single-chip trace to f32 rounding
    (the per-shard FFT length differs, so not bit-identical; tests budget
    3e-5).

    ``xs``: prepared (normalized, group-shifted) features ``[C, T]``.
    Returns ``(sims[W], boosts[W])``, ``W = T − L + 1``.
    """
    n_dev = mesh.devices.size
    L = template.num_frames
    C, T = xs.shape
    W = T - L + 1
    if W <= 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    per = -(-W // n_dev)                     # window starts per shard
    # bucket the slab width so sweeps over many file lengths reuse a
    # handful of jit keys (every fresh key is a compile); the pad
    # windows are trimmed below
    from ..analysis.correlation import _bucket
    slab = _bucket(per + L - 1)              # samples per shard incl. halo
    slabs = np.zeros((n_dev, C, slab), np.float32)
    for d in range(n_dev):
        s0 = d * per
        src = xs[:, s0:s0 + slab]
        slabs[d, :, :src.shape[1]] = src

    shard = NamedSharding(mesh, P("files"))
    shifts = np.full(n_dev, np.float32(shift_t))
    sims, boosts = _batched_traces(
        jax.device_put(slabs, shard),       # host → per-shard devices
        template.device_temporal(), template.device_spectral(),
        jnp.float32(template.temporal_std), jnp.float32(template.spectral_std),
        jnp.float32(template.ln_avg_loudness),
        jax.device_put(shifts, shard),
        jnp.float32(temp_weight), jnp.float32(max_boost),
        num_temporal=template.num_temporal)
    # per-shard W' = slab − L + 1 ≥ per: keep each shard's first `per`
    # window starts (the rest are bucket-pad windows), then trim the tail
    # shard's overhang past W
    sims = np.asarray(sims)[:, :per].reshape(-1)[:W].copy()
    boosts = np.asarray(boosts)[:, :per].reshape(-1)[:W].copy()
    return sims, boosts


def sharded_extract_long(audio: np.ndarray, sample_rate: float,
                         mesh: Mesh, num_coeffs: int = 13,
                         fft_size: int = 1024, fft_overlap: int = 2,
                         smask: Optional[float] = None,
                         tmask: Optional[float] = None):
    """Feature extraction of ONE very long file, time axis sharded over the
    mesh — context parallelism for the DSP front-end.

    Output frames are split into contiguous per-chip ranges.  The pipeline's
    only cross-frame state is temporal masking, and the masking floor of
    frame ``t`` is the *spectral* excitation of frame ``t−1`` (no
    recursion, dsp/frontend.py) — so each shard recomputes exactly one halo
    frame to seed its carry and every result frame is identical to the
    sequential path (no collectives at all; the feature gather happens on
    fetch).  Shard 0's halo frame is the zero-padded pre-signal window, the
    same silence the sequential carry encodes.

    ``audio``: mono float32 (±1) or raw int16.  ``smask``/``tmask``
    default to the front-end's mask factors.  Returns ``[C, F]`` features,
    ``F = ceil(len(audio)/step) − 1``, equal to
    ``dsp.frontend.extract_features`` within f32 plan tolerance (≤2e-5).
    """
    from ..dsp import frontend as FE
    from ..dsp.ml_tables import ERB_BANDS

    # the one-halo-frame trick is an invariant of the shipped prev_frame
    # masking form; the 'feedback' hypothesis form is recursive across all
    # history, which no finite halo can reconstruct — fail loud rather
    # than silently diverge from the sequential path
    if FE.C.TMASK_FORM != "prev_frame":
        raise NotImplementedError(
            f"sharded_extract_long requires TMASK_FORM == 'prev_frame' "
            f"(got {FE.C.TMASK_FORM!r}): the recursive feedback form "
            "cannot be seeded from one halo frame — use "
            "dsp.frontend.extract_features")
    if smask is None:
        smask = FE.C.SPECTRAL_MASK_DEFAULT
    if tmask is None:
        tmask = FE.C.TEMPORAL_MASK_DEFAULT

    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32, copy=False)
    step = fft_size // fft_overlap
    total = FE.num_output_frames(len(audio), step)
    C = num_coeffs + 1
    if total == 0:
        return np.zeros((C, 0), np.float32)

    n_dev = mesh.devices.size
    per = -(-total // n_dev)                 # result frames per shard
    frames_local = per + 1                   # + the halo frame
    block, nb = FE._plan_shapes(frames_local, FE.BLOCK_FRAMES)
    slab_len = nb * block * step + fft_size - step

    # global sample layout: window of frame g is padded[g*step : g*step+fft]
    left_pad = fft_size - step
    lead = left_pad + step                   # shard 0's halo frame is g = −1
    padded = np.zeros(lead + max(len(audio),
                                 (n_dev * per) * step + fft_size), audio.dtype)
    padded[lead:lead + len(audio)] = audio
    slabs = np.zeros((n_dev, slab_len), audio.dtype)
    for d in range(n_dev):
        g0 = d * per - 1                     # first local frame (halo)
        s0 = lead + g0 * step - left_pad
        src = padded[s0:s0 + slab_len]
        slabs[d, :len(src)] = src

    consts = FE._device_consts(float(sample_rate), fft_size, num_coeffs,
                               float(smask), float(tmask))
    shard = NamedSharding(mesh, P("files"))
    # shard straight from host memory (np arrays) — an eager jnp.asarray
    # would commit the whole long-file stack to device 0 and pay the
    # transfer twice (the rule batched_correlation_traces documents)
    feats, _ = FE._extract_scan_batch(
        jax.device_put(slabs, shard),
        jax.device_put(np.zeros((n_dev, ERB_BANDS), np.float32), shard),
        *consts,
        num_blocks=nb, block=block, fft_size=fft_size, step=step)
    out = np.asarray(feats)                  # [n_dev, nb, C, block]
    out = out.transpose(0, 2, 1, 3).reshape(n_dev, C, -1)
    out = out[:, :, 1:per + 1]               # drop each shard's halo frame
    return np.concatenate(list(out), axis=1)[:, :total].copy()


@partial(jax.jit, static_argnames=("half_win", "num_temporal"))
def _batched_novelty(xs_b, half_win: int, temp_weight,
                     num_temporal: int = 1):
    """vmap of kernels.corr.novelty_trace over a files/spans axis."""
    return jax.vmap(lambda xs: K.novelty_trace(
        xs, half_win, temp_weight, num_temporal=num_temporal))(xs_b)


def batched_novelty_traces(xs_b: np.ndarray, half_win: int,
                           temp_weight: float,
                           mesh: Optional[Mesh] = None) -> np.ndarray:
    """Novelty curves for a padded batch of prepared feature matrices
    ``[B, C, Tp]`` — the segmentation hot loop
    (FeatureSegmentationImpl.scala:107-133) batched over files/spans and
    optionally sharded over a ``files`` mesh axis.  Each curve is
    independent (no cross-file state); sharding a mesh-divisible batch is
    bit-identical to the unsharded batch (tests pin it).  When the batch
    must be zero-padded to a mesh multiple, the changed FFT batch size
    can shift curve values by f32 rounding (~2e-8 observed; the ≤2e-5
    plan-invariance budget applies).  Returns ``sims [B, W]``,
    ``W = Tp − 2·half_win + 1``."""
    tw = jnp.float32(temp_weight)
    xs_b = np.asarray(xs_b)
    if mesh is None:
        return np.asarray(_batched_novelty(jnp.asarray(xs_b), half_win, tw))
    b = xs_b.shape[0]
    pad_rows = -b % mesh.devices.size
    if pad_rows:
        xs_b = np.concatenate(
            [xs_b, np.zeros((pad_rows,) + xs_b.shape[1:], xs_b.dtype)])
    xs_s = jax.device_put(xs_b, NamedSharding(mesh, P("files")))
    return np.asarray(_batched_novelty(xs_s, half_win, tw))[:b]


def sharded_long_novelty_trace(xs: np.ndarray, half_win: int,
                               temp_weight: float, mesh: Mesh) -> np.ndarray:
    """Novelty curve of ONE very long file, time axis sharded over the
    mesh — :func:`sharded_long_file_trace`'s analog for the segmentation
    window (correlateHalf, FeatureSegmentationImpl.scala:107-133).

    Window starts split into contiguous per-chip ranges; each shard
    receives its slab plus the ``2·half_win − 1``-frame halo so every
    window computes locally (no collectives in the hot path).  Per-shard
    FFT lengths differ from the full-file plan, so values carry the
    plan-invariance budget (≤2e-5; ~1e-7 observed) vs
    :func:`kernels.corr.novelty_trace` on the same input.

    ``xs``: prepared (normalized, group-shifted) features ``[C, T]``.
    Returns ``sims[W]``, ``W = T − 2·half_win + 1``.
    """
    n_dev = mesh.devices.size
    C, T = xs.shape
    win = 2 * half_win
    W = T - win + 1
    if W <= 0:
        return np.zeros(0, np.float32)
    per = -(-W // n_dev)                     # window starts per shard
    # bucketed slab width: one jit key serves a range of file lengths
    # (same rationale as sharded_long_file_trace)
    from ..analysis.correlation import _bucket
    slab = _bucket(per + win - 1)            # frames per shard incl. halo
    slabs = np.zeros((n_dev, C, slab), np.float32)
    for d in range(n_dev):
        src = xs[:, d * per:d * per + slab]
        slabs[d, :, :src.shape[1]] = src
    # per-shard W' = slab − win + 1 ≥ per: keep each shard's first `per`
    # window starts (bucket-pad windows dropped), trim the tail shard's
    # overhang past W
    sims = batched_novelty_traces(slabs, half_win, temp_weight, mesh=mesh)
    return sims[:, :per].reshape(-1)[:W].copy()


_SWEEP_STEP_CACHE: dict = {}


def sharded_sweep_step(mesh: Mesh, num_temporal: int = 1):
    """Build the jitted full sweep step over a mesh: batched extraction-style
    feature prep is assumed done; the step takes a sharded feature batch and
    a replicated template and returns per-file device top-k (values, frame
    indices) — the pattern the 10k-file north-star sweep uses.

    The files axis is sharded; templates are replicated; ``jnp.top_k`` runs
    shard-local and results gather over the device interconnect on fetch.

    Cached per (mesh devices, num_temporal) like :func:`_sharded_traces_fn`:
    a fresh ``jax.jit`` closure per call would recompile the large
    correlation program on every rebuild (minutes per remote compile,
    CLAUDE.md).
    """
    key = (tuple(d.id for d in mesh.devices.flat), num_temporal)
    cached = _SWEEP_STEP_CACHE.get(key)
    if cached is not None:
        return cached
    shard = NamedSharding(mesh, P("files"))
    repl = NamedSharding(mesh, P())

    @partial(jax.jit,
             in_shardings=(shard, repl, repl, repl, repl, repl, shard,
                           shard, repl, repl),
             out_shardings=(shard, shard),
             static_argnames=("k",))
    def step(xs_b, tmpl_t, tmpl_s, a_std_t, a_std_s, ln_avg, shifts_t,
             lens, temp_weight, max_boost, k: int = 4):
        sims, _ = _batched_traces(xs_b, tmpl_t, tmpl_s, a_std_t, a_std_s,
                                  ln_avg, shifts_t, temp_weight, max_boost,
                                  num_temporal=num_temporal)
        # mask windows that extend past each file's true length (the batch
        # is padded to a common T; padded-tail windows are degenerate)
        L = tmpl_t.shape[1]
        w_valid = lens - (L - 1)
        t_idx = jnp.arange(sims.shape[1])[None, :]
        sims = jnp.where(t_idx < w_valid[:, None], sims, -jnp.inf)
        vals, idx = jax.lax.top_k(sims, k)
        return vals, idx

    _SWEEP_STEP_CACHE[key] = step
    return step
