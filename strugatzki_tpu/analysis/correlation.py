"""Database correlation search (punch-in/punch-out matcher).

JAX re-implementation of impl/FeatureCorrelationImpl.scala — the
reference's flagship algorithm.  The three hot loops become dense device
computations; the data-dependent match selection is replayed on host in the
reference's exact iteration order:

* HOT LOOPS 1+2 (:190-246, :281-315) punch-in/punch-out sliding
  correlations → batched FFT traces (kernels/corr.py) over 32-file chunks,
  prepared on device by the fused normalize+shift kernel
  (kernels/prep.py); the reference's temp-IRCAM-file spill becomes
  in-memory dense traces;
* HOT LOOP 3 (:325-389) in×out combination — host replay over the dense
  traces with the ``inSim > low²`` gate (:342), ``sim = √(inSim·outSim)``
  (:370) and the priority-queue caching semantics (:339-379).

Divergence note (documented in docs/PARITY.md): the reference's combine pass
reads ``punchInLen − 1`` frames past the end of its punch-in temp file and up
to ``punchOutLen − 1`` past the punch-out temp file (tIn/tOut hold
``W − off`` entries but the loop runs ``tOutSize = numFrames − poOff0``
iterations); behavior there depends on stale I/O buffers.  We iterate over
the *defined* trace entries only.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import CorrelationConfig, ExtractionConfig, Match
from ..kernels import corr as K
from ..kernels import mathref as M
from ..runtime.processor import Processor, ProcessorFactory
from ..span import Span, spacing
from .common import feat_to_full, full_to_feat, load_norm, normalized, read_features
from .topk import SimSortedSet

__all__ = ["FeatureCorrelation", "InputTemplate", "sliding_traces",
           "correlate_database"]


# Padding buckets bound jit recompiles across differing file lengths.
_BUCKET_GROWTH = 1.25
_BUCKET_MIN = 1024


def _bucket(n: int) -> int:
    b = _BUCKET_MIN
    while b < n:
        b = int(math.ceil(b * _BUCKET_GROWTH))
    return b


class InputTemplate:
    """A punch template: normalized feature block with per-group statistics
    (reference ``InputMatrix``/``FeatureMatrix``, FeatureCorrelation.scala:279-289)."""

    def __init__(self, block: np.ndarray, num_temporal: int = 1) -> None:
        self.num_frames = block.shape[1]
        self.num_temporal = num_temporal
        # the RAW normalized groups, for host-exact paths: reconstructing
        # the block as centered + f32(mean) costs up to 1 ulp per cell and
        # can flip exact-compare selection gates
        self.temporal_block = np.asarray(block[:num_temporal],
                                         np.float32).copy()
        self.spectral_block = np.asarray(block[num_temporal:],
                                         np.float32).copy()
        self.temporal_centered, self.temporal_mean, self.temporal_std = \
            K.prepare_template(block[:num_temporal])
        self.spectral_centered, self.spectral_mean, self.spectral_std = \
            K.prepare_template(block[num_temporal:])
        # ln of the average (normalized) loudness (FeatureCorrelationImpl.scala:73)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.ln_avg_loudness = float(
                np.log(np.float64(M.avg(block[0], 0, self.num_frames))))
        self._dev_t = None
        self._dev_s = None

    def device_temporal(self):
        """Template staged on device once, not re-uploaded per dispatch."""
        if self._dev_t is None:
            self._dev_t = jnp.asarray(self.temporal_centered)
        return self._dev_t

    def device_spectral(self):
        if self._dev_s is None:
            self._dev_s = jnp.asarray(self.spectral_centered)
        return self._dev_s

    @staticmethod
    def from_features(features: np.ndarray, norm: Optional[np.ndarray],
                      start: int, stop: int) -> "InputTemplate":
        """Reference ``readInBuffer`` (:83-98): slice feature frames
        ``[start, stop)``, zero-padded at EOF like a partial read, normalize,
        compute stats."""
        if start < 0:
            # the reference's afIn.seek(negative) throws; a Python negative
            # slice would silently grab tail frames instead
            raise ValueError(f"punch span starts before the file "
                             f"(feature frame {start})")
        frame_num = stop - start
        block = np.zeros((features.shape[0], frame_num), np.float32)
        avail = features[:, start:min(stop, features.shape[1])]
        block[:, :avail.shape[1]] = avail
        M.normalize(norm, block, 0, frame_num)
        return InputTemplate(block)


def sliding_traces(xs_shifted: np.ndarray, shift_t: float, shift_s: float,
                   template: InputTemplate, scan_len: int,
                   temp_weight: float, max_boost: float,
                   as_device: bool = False):
    """(sim, boost) for windows ``t = 0 .. scan_len − L`` (or the single
    zero-padded window when ``scan_len < L``) of a prepared feature matrix.

    ``xs_shifted``: group-shifted normalized features (``shift_per_group``),
    full file.  ``scan_len`` is the reference's initial ``left`` (numFrames,
    minus minPunch in punch-out mode, FeatureCorrelationImpl.scala:182-184).
    """
    L = template.num_frames
    if scan_len <= 0:
        empty = np.zeros(0, np.float32)
        return (empty, empty, 0) if as_device else (empty, empty)
    num_windows = scan_len - L + 1 if scan_len >= L else 1

    pad_to = _bucket(num_windows - 1 + L)
    # never read past scan_len: in the scan_len < L single-window case the
    # reference correlates scan_len real frames + a zero tail
    # (FeatureCorrelationImpl.scala:183-195) even when the file is longer
    xs = xs_shifted[:, :min(scan_len, num_windows - 1 + L)]
    if xs.shape[1] < pad_to:
        # padding represents literal zeros of the reference's freshly
        # allocated buffer (normalized space), i.e. −shift in shifted space;
        # only the scan_len < L single-window case actually reads it — the
        # bucket tail is trimmed from the outputs below
        pad = np.zeros((xs.shape[0], pad_to - xs.shape[1]), np.float32)
        pad[:template.num_temporal] = -shift_t
        pad[template.num_temporal:] = -shift_s
        xs = np.concatenate([xs, pad], axis=1)

    sims, boosts = K.correlation_trace(
        jnp.asarray(xs),
        template.device_temporal(), template.device_spectral(),
        jnp.float32(template.temporal_std), jnp.float32(template.spectral_std),
        jnp.float32(template.ln_avg_loudness), jnp.float32(shift_t),
        jnp.float32(temp_weight), jnp.float32(max_boost),
        num_temporal=template.num_temporal)
    if as_device:
        # async handles — lets callers overlap further uploads/compute
        # before forcing the fetch
        return sims, boosts, num_windows
    return (np.asarray(sims)[:num_windows].copy(),
            np.asarray(boosts)[:num_windows].copy())


def _single_window_trace(avail: np.ndarray, norm, template: InputTemplate,
                         temp_weight: float, max_boost: float):
    """(sim, boost) arrays for ONE zero-tailed window: ``avail`` holds the
    frames the reference actually reads; the rest of the window is the
    freshly-allocated buffer's zeros (normalized space)."""
    L = template.num_frames
    win = np.zeros((avail.shape[0], L), np.float32)
    win[:, :avail.shape[1]] = avail
    M.normalize(norm, win, 0, avail.shape[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        boost = np.float32(np.exp(
            (template.ln_avg_loudness
             - np.log(np.float64(M.avg(win[0], 0, L)))) / 0.6))
    if boost <= max_boost:
        nt = template.num_temporal
        sim_t = np.float32(0.0)
        sim_s = np.float32(0.0)
        if temp_weight > 0:
            bm, bs = M.stat(win, 0, L, 0, nt)
            sim_t = M.correlate(
                template.temporal_block,
                template.temporal_mean, template.temporal_std, L, nt,
                win, bm, bs, 0, 0)
        if temp_weight < 1:
            bm, bs = M.stat(win, 0, L, nt, win.shape[0] - nt)
            sim_s = M.correlate(
                template.spectral_block,
                template.spectral_mean, template.spectral_std, L,
                win.shape[0] - nt, win, bm, bs, 0, nt)
        sim = np.float32(sim_t * np.float32(temp_weight)
                         + sim_s * np.float32(1 - temp_weight))
    else:
        sim = np.float32(0.0)
    return (np.array([sim], np.float32), np.array([boost], np.float32))


def correlate_database(meta_in: ExtractionConfig, db_entries, norm,
                       config: CorrelationConfig,
                       check_aborted=lambda: None,
                       progress=lambda f: None,
                       verbose: bool = False,
                       skip_nan: bool = False, mesh=None) -> List[Match]:
    """Run the full search.  ``db_entries`` is a list of
    ``(ExtractionConfig, features_loader)`` pairs.

    With ``mesh`` each chunk's prep + trace dispatch runs SPMD over the
    ``files`` axis (the chunk size rounds up to a device multiple); the
    host replay is unchanged, so selection semantics are identical while
    sims carry the plan-invariance budget vs the single-device program.

    ``skip_nan`` is a framework extension (off by default for faithful
    reference behavior): in the reference, a NaN similarity — e.g.
    ``√(inSim·outSim)`` of a negative product (FeatureCorrelationImpl
    .scala:370) — once admitted ranks as the best match
    (``java.lang.Float.compare`` total order) and, worse, poisons
    ``lowestSim`` so the ``inSim > low²`` gate (:342) rejects every later
    candidate.  With ``skip_nan=True`` NaN candidates are never admitted."""
    cfg = config
    step = meta_in.step_size

    f2f = lambda n: full_to_feat(n, step)
    t2f = lambda i: feat_to_full(i, step)

    # --- input templates (reference :80-107) --------------------------------
    in_feats = read_features(meta_in)
    pi = cfg.punch_in
    matrix_in = InputTemplate.from_features(
        in_feats, norm, f2f(pi.span.start), f2f(pi.span.stop))
    matrix_out = None
    if cfg.punch_out is not None:
        po = cfg.punch_out
        matrix_out = InputTemplate.from_features(
            in_feats, norm, f2f(po.span.start), f2f(po.span.stop))

    punch_in_len = matrix_in.num_frames
    punch_out_len = matrix_out.num_frames if matrix_out else 0
    in_temp_weight = pi.temporal_weight
    min_punch = f2f(cfg.min_punch)
    max_punch = f2f(cfg.max_punch)

    all_prio: SimSortedSet[Match] = SimSortedSet(descending=True)

    # --- chunked batched traces ---------------------------------------------
    # Device traces are state-independent supersets: both punch traces are
    # computed over EVERY window start of every file (the replay slices the
    # per-file valid prefixes and index-shifts by tInOff / poOff0), so whole
    # chunks of files go through one fused prep (kernels/prep) + one
    # batched FFT-trace dispatch each, ahead of the sequential host replay.
    from collections import deque

    import jax.numpy as jnp_  # local alias; module-level jnp already imported

    from ..kernels.prep import prepare_database
    from ..parallel.sweep import _batched_traces, pad_stack

    chunk_size = 32
    chunk_shard = None
    traces_fn = _batched_traces
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.sweep import _sharded_traces_fn
        n_dev = mesh.devices.size
        chunk_size = -(-chunk_size // n_dev) * n_dev
        chunk_shard = NamedSharding(mesh, P("files"))
        traces_fn = _sharded_traces_fn(mesh)

    # per-search scalar constants staged on device ONCE: each eager
    # jnp.float32 is a host→device upload, and a 10k-file sweep dispatches
    # hundreds of chunks
    _scal_cache: dict = {}

    def _trace_batch(xs_dev, shifts_dev, template: InputTemplate,
                     temp_weight: float):
        sc = _scal_cache.get(id(template))
        if sc is None:
            sc = (jnp_.float32(template.temporal_std),
                  jnp_.float32(template.spectral_std),
                  jnp_.float32(template.ln_avg_loudness),
                  jnp_.float32(temp_weight), jnp_.float32(cfg.max_boost))
            _scal_cache[id(template)] = sc
        sims, boosts = traces_fn(
            xs_dev,
            template.device_temporal(), template.device_spectral(),
            sc[0], sc[1], sc[2], shifts_dev, sc[3], sc[4])
        return sims, boosts

    def dispatch_chunk(chunk_entries):
        """Host prep + async device dispatch of one chunk's traces; the
        fetch happens in :func:`collect_chunk`, so the NEXT chunk's device
        work can run while the host replays the current one."""
        if not chunk_entries:
            return None
        feats_list = [load() for _, load in chunk_entries]
        lens = [f.shape[1] for f in feats_list]
        # pad the batch to a fixed chunk size and bucketed width so the
        # whole sweep reuses a handful of jit keys
        while len(feats_list) < chunk_size:
            feats_list.append(np.zeros((feats_list[0].shape[0], 1), np.float32))
            lens.append(0)
        raw, lens_arr = pad_stack(feats_list)
        # the device width must cover the TEMPLATE too: a chunk whose files
        # are all shorter than the punch would otherwise feed the trace a
        # Tp < L input (negative window count → garbage/empty traces for
        # the single zero-tail window the reference computes)
        t_pad = _bucket(max(raw.shape[2], punch_in_len, punch_out_len))
        if raw.shape[2] < t_pad:
            raw = np.pad(raw, ((0, 0), (0, 0), (0, t_pad - raw.shape[2])))
        if verbose:
            import sys as _sys
            print(f"  chunk: {len(chunk_entries)} files dispatched "
                  f"(device width {t_pad})", file=_sys.stderr)
        xs_dev, shifts_dev = prepare_database(raw, norm, lens_arr,
                                              sharding=chunk_shard)
        in_b = _trace_batch(xs_dev, shifts_dev, matrix_in, in_temp_weight)
        out_b = None
        if matrix_out is not None:
            out_b = _trace_batch(xs_dev, shifts_dev, matrix_out,
                                 cfg.punch_out.temporal_weight)
        return (chunk_entries, feats_list, lens, in_b, out_b)

    def collect_chunk(pending_chunk):
        chunk_entries, feats_list, lens, in_b, out_b = pending_chunk
        # fetch once per chunk; slice per-file valid prefixes
        sims_in_b = np.asarray(in_b[0])
        boosts_in_b = np.asarray(in_b[1])
        if out_b is not None:
            sims_out_b = np.asarray(out_b[0])
            boosts_out_b = np.asarray(out_b[1])
        items = []
        scan_delta = min_punch if matrix_out is not None else 0
        for i, (entry, t_i) in enumerate(zip(chunk_entries, lens)):
            scan = t_i - scan_delta
            w_in = scan - punch_in_len + 1 if scan >= punch_in_len \
                else (1 if scan > 0 else 0)
            h_in = (sims_in_b[i, :w_in].copy(), boosts_in_b[i, :w_in].copy())
            if matrix_out is not None and 0 < scan < punch_in_len:
                # reference edge case: the punch-in loop reads only `scan`
                # frames even though the file holds more (left = numFrames −
                # minPunch, FeatureCorrelationImpl.scala:183-195); the single
                # window's tail is the buffer's zeros, not file data —
                # recompute it host-side with that exact padding
                h_in = _single_window_trace(
                    feats_list[i][:, :scan], norm, matrix_in,
                    in_temp_weight, cfg.max_boost)
            h_out = None
            if matrix_out is not None:
                w_outv = max(t_i - punch_out_len + 1, 0)
                h_out = (sims_out_b[i, :w_outv].copy(),
                         boosts_out_b[i, :w_outv].copy())
            items.append((entry[0], t_i, h_in, h_out))
        return items

    queue = deque()
    entries_list = list(db_entries)
    chunk_iter = (entries_list[o:o + chunk_size]
                  for o in range(0, len(entries_list), chunk_size))
    pending = dispatch_chunk(next(chunk_iter, None))

    def refill():
        # dispatch chunk k+1 BEFORE fetching chunk k: the device computes
        # the next chunk while the host fetches and replays this one
        nonlocal pending
        if not queue and pending is not None:
            cur = pending
            pending = dispatch_chunk(next(chunk_iter, None))
            queue.extend(collect_chunk(cur))

    refill()
    idx = -1
    while queue:
        idx += 1
        check_aborted()
        extr_db, num_frames, h_in, h_out = queue.popleft()
        refill()

        entry_prio: SimSortedSet[Match] = SimSortedSet(descending=True)
        last_entry_match: Optional[Match] = None

        def entry_has_space() -> bool:
            max_sz = min(cfg.num_matches - len(all_prio), cfg.num_per_file)
            return len(entry_prio) < max_sz

        def lowest_sim() -> float:
            if len(entry_prio):
                return entry_prio.last_sim
            if len(all_prio):
                return all_prio.last_sim
            return 0.0

        def add_match(m: Match) -> None:
            nonlocal last_entry_match
            if (last_entry_match is not None
                    and spacing(m.punch, last_entry_match.punch) < cfg.min_spacing):
                if last_entry_match.sim < m.sim:
                    entry_prio.remove_sim(last_entry_match.sim)
                    entry_prio.add(m.sim, m)
                    last_entry_match = m
            else:
                entry_prio.add(m.sim, m)
                if len(entry_prio) > cfg.num_per_file:
                    entry_prio.drop_last()
                last_entry_match = m

        sims_in, boosts_in = h_in
        check_aborted()

        if matrix_out is None:
            # matches added inline during the punch-in scan (:233-240).
            # While the entry queue is full, `lowestSim` is non-decreasing,
            # so windows failing `sim > low` can be skipped with a vector
            # scan — identical selection, not O(W) Python steps.
            w_in = len(sims_in)
            t = 0
            while t < w_in:
                if entry_has_space():
                    sim = float(sims_in[t])
                elif sims_in[t] > (low := lowest_sim()):
                    sim = float(sims_in[t])   # scalar fast path: no O(W) scan
                else:
                    rel = int(np.argmax(sims_in[t:] > low))
                    sim = float(sims_in[t + rel])
                    if not sim > low:
                        break  # no further candidate in this file
                    t += rel
                if not (skip_nan and math.isnan(sim)):
                    if entry_has_space() or sim > lowest_sim():
                        add_match(Match(sim, extr_db.audio_input,
                                        Span(t2f(t), t2f(t + punch_in_len)),
                                        float(boosts_in[t]), 1.0))
                t += 1
        else:
            # trace-open gate (:213-223): hs/lowestSim are constant during the
            # punch-in scan (no matches are added until the combine pass)
            if entry_has_space():
                t_in_off = 0
            else:
                low0 = lowest_sim()
                above = np.nonzero(sims_in > low0)[0]
                t_in_off = int(above[0]) if above.size else -1

            if t_in_off >= 0 and len(sims_in) > t_in_off:
                tin_sims = sims_in[t_in_off:]

                po_off0 = t_in_off + min_punch
                t_out_size = num_frames - po_off0
                if t_out_size >= punch_out_len:
                    # the prefetched punch-out trace covers EVERY window
                    # start of the file; the reference's tout index j maps
                    # to full index poOff0 + j (:273-315)
                    tout_full, tout_boosts_full = h_out
                    check_aborted()

                    w_out = len(tout_full) - po_off0
                    scan_span = max_punch - min_punch + 1
                    n_in = len(tin_sims)
                    i = 0
                    while i < n_in:
                        low = lowest_sim()
                        hs = entry_has_space()
                        # skip piOffs failing the inSim > low² gate with a
                        # vector scan — no state changes at skipped
                        # positions, so the replay is exact (:342).  low² is
                        # a Java Float multiply: round to f32 (the f64
                        # product can sit 1 ulp away and flip the gate)
                        low2 = np.float32(low * low)
                        if not tin_sims[i] > low2:   # scalar-first: the
                            # suffix scan is O(n) and runs per candidate
                            rel = int(np.argmax(tin_sims[i:] > low2))
                            if not tin_sims[i + rel] > low2:
                                break
                            i += rel
                        in_sim = float(tin_sims[i])
                        boost_in = float(boosts_in[t_in_off + i])
                        seek = i
                        n2 = min(t_out_size - seek, scan_span, w_out - seek)
                        if n2 > 0:
                            base = po_off0 + seek
                            seg = tout_full[base:base + n2]
                            with np.errstate(invalid="ignore"):
                                # NaN for negative products is the
                                # reference's own behavior (:370)
                                sims_c = np.sqrt(
                                    np.float32(in_sim) * seg).astype(np.float32)
                            pi_off = t_in_off + i
                            k = 0
                            while k < n2:
                                if not hs and not sims_c[k] > low:
                                    # jump to the next candidate above `low`
                                    rel = int(np.argmax(sims_c[k:] > low))
                                    if not sims_c[k + rel] > low:
                                        break
                                    k += rel
                                sim = float(sims_c[k])
                                if skip_nan and math.isnan(sim):
                                    k += 1
                                    continue
                                if hs or sim > low:
                                    add_match(Match(
                                        sim, extr_db.audio_input,
                                        Span(t2f(pi_off),
                                             t2f(pi_off + min_punch + k)),
                                        boost_in,
                                        float(tout_boosts_full[base + k])))
                                    low = lowest_sim()
                                    hs = entry_has_space()
                                k += 1
                        i += 1
                        if i % 8192 == 0:
                            check_aborted()

        # merge entry results (:399-400)
        all_prio.update(entry_prio)
        all_prio.truncate(cfg.num_matches)
        progress((idx + 1) / max(len(entries_list), 1))

    return all_prio.items()


class FeatureCorrelation(ProcessorFactory):
    """``FeatureCorrelation.run(config, observer) -> Processor[list[Match]]``."""

    name = "correlation"
    Config = CorrelationConfig
    #: extension: reject NaN similarities instead of the reference's
    #: NaN-ranks-first-and-poisons-gates behavior (see correlate_database)
    skip_nan = False
    #: like ``SelfSimilarity.mesh``: shard each chunk's trace dispatch
    #: over a ``files`` mesh axis (process state, not config)
    mesh = None

    @classmethod
    def _make_body(cls, config: CorrelationConfig):
        cfg = config.build()

        def body(proc: Processor):
            meta_in = ExtractionConfig.from_xml_file(cfg.meta_input)
            step = meta_in.step_size

            # scan database folder (:42-55)
            folder = cfg.database_folder
            meta_abs = os.path.abspath(cfg.meta_input)
            names = sorted(n for n in os.listdir(folder)
                           if n.endswith("_feat.xml"))
            paths = [os.path.join(folder, n) for n in names]
            paths = [p for p in paths if os.path.abspath(p) != meta_abs]
            if cls.verbose:
                print(f"Number of files in database : {len(paths)}")

            entries = []
            for p in paths:
                e = ExtractionConfig.from_xml_file(p)
                if (e.num_coeffs == meta_in.num_coeffs
                        and e.step_size == step):
                    entries.append(
                        (e, (lambda e_=e: read_features(e_))))
            if cls.verbose:
                print(f"Number of compatible files in database : {len(entries)}")

            norm = load_norm(folder, meta_in.num_coeffs) if cfg.normalize else None

            return correlate_database(
                meta_in, entries, norm, cfg,
                check_aborted=proc.check_aborted,
                progress=proc.set_progress,
                verbose=cls.verbose,
                skip_nan=cls.skip_nan, mesh=cls.mesh)

        return body
