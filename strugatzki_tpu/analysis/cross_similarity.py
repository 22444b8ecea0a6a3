"""Sliding cross-similarity vector.

JAX re-implementation of impl/CrossSimilarityImpl.scala: the shorter
feature span becomes an in-memory template (:92-114), slid across the longer
span one frame per step with the same sim/boost formulas as the correlation
matcher (:142-154); the per-step similarity is written as a 1-channel float
audio file at the feature rate of ``meta_input1`` (:87-89 — note the rate is
taken from input 1 *before* the shorter/longer swap).

Divergence (documented in docs/PARITY.md): the reference's ring buffer is a
fixed 8192-column array while its rotation arithmetic is modulo the template
length (:119,:140,:165 vs MathUtil.scala:190's ``% cb.length``), which
corrupts windows and truncates the output to ``max(1, len2 − 8191)`` frames
whenever the template length ≠ 8192.  We implement the evident intent:
``len2 − len1 + 1`` correct sliding windows.
"""

from __future__ import annotations


from ..config import CrossSimilarityConfig, ExtractionConfig
from ..io import audiofile as af
from ..kernels import corr as K
from ..runtime.processor import Processor, ProcessorFactory
from ..span import Span
from .common import full_to_feat, load_norm, normalized, read_features
from .correlation import InputTemplate, sliding_traces

__all__ = ["CrossSimilarity"]


def _open_span(extr: ExtractionConfig, span: Span, num_frames: int):
    """Feature-frame [start, stop) for a span (CrossSimilarityImpl.scala:67-80)."""
    step = extr.step_size
    if span.is_closed:
        lo, hi = full_to_feat(span.start, step), full_to_feat(span.stop, step)
    elif span.has_start:
        lo, hi = full_to_feat(span.start, step), num_frames
    elif span.has_stop:
        lo, hi = 0, full_to_feat(span.stop, step)
    else:
        lo, hi = 0, num_frames
    stop = min(num_frames, hi)
    start = max(0, min(stop, lo))
    return start, stop


class CrossSimilarity(ProcessorFactory):
    """``CrossSimilarity.run(config, observer) -> Processor[None]``
    (writes the similarity audio file).

    The classvar ``mesh`` (like ``SelfSimilarity.mesh``) runs the sliding
    trace sequence-parallel: the longer file's time axis splits into
    per-chip slabs with an ``L − 1``-frame halo
    (:func:`strugatzki_tpu.parallel.sweep.sharded_long_file_trace`) — the
    natural scaling axis here, since a cross-similarity run is ONE very
    long trace, not a batch.  Sims match the single-device trace within
    the plan budget (different FFT lengths per shard; tests budget 3e-5).
    """

    name = "cross similarity"
    Config = CrossSimilarityConfig
    mesh = None

    @classmethod
    def _make_body(cls, config: CrossSimilarityConfig):
        cfg = config.build()

        def body(proc: Processor):
            extr1 = ExtractionConfig.from_xml_file(cfg.meta_input1)
            extr2 = ExtractionConfig.from_xml_file(cfg.meta_input2)
            if (extr1.fft_size != extr2.fft_size
                    or extr1.fft_overlap != extr2.fft_overlap
                    or extr1.num_coeffs != extr2.num_coeffs):
                raise ValueError(
                    f"Analysis settings for {cfg.meta_input1} and "
                    f"{cfg.meta_input2} differ.")

            norm = load_norm(cfg.database_folder, extr1.num_coeffs) \
                if cfg.normalize else None

            f1, spec1 = af.read(extr1.feature_output)
            f2 = read_features(extr2)
            s1, e1 = _open_span(extr1, cfg.span1, f1.shape[1])
            s2, e2 = _open_span(extr2, cfg.span2, f2.shape[1])
            a1, a2 = f1[:, s1:e1], f2[:, s2:e2]

            # output rate comes from input 1's feature file, pre-swap (:87-89)
            rate1 = spec1.sample_rate

            # shorter span becomes the template (:92-94)
            if a1.shape[1] < a2.shape[1]:
                tmpl_src, sig_src = a1, a2
            else:
                tmpl_src, sig_src = a2, a1
            len1 = tmpl_src.shape[1]
            if len1 == 0 or sig_src.shape[1] == 0:
                raise ValueError("empty span")

            tmpl_block = normalized(tmpl_src, norm)
            template = InputTemplate(tmpl_block)

            xn = normalized(sig_src, norm)
            xs, shift_t, shift_s = K.shift_per_group(xn)
            proc.check_aborted()
            # the reference reports per-output-frame progress
            # (CrossSimilarityImpl.scala:169); the device computes the whole
            # trace in one dispatch, so stage the fractions around it
            proc.set_progress(0.1)

            # sequence-parallel only when there is a real multi-window
            # trace to split (the scan_len < L single-zero-padded-window
            # edge keeps the exact single-device semantics)
            if cls.mesh is not None and sig_src.shape[1] >= len1:
                from ..parallel.sweep import sharded_long_file_trace
                sims, _boosts = sharded_long_file_trace(
                    xs, shift_t, template, cfg.temporal_weight,
                    cfg.max_boost, cls.mesh)
            else:
                sims, _boosts = sliding_traces(
                    xs, shift_t, shift_s, template, sig_src.shape[1],
                    cfg.temporal_weight, cfg.max_boost)
            proc.check_aborted()
            proc.set_progress(0.9)

            af.write(cfg.audio_output, sims[None, :],
                     af.AudioFileSpec(cfg.audio_output_type,
                                      af.SampleFormat.FLOAT, 1, rate1))
            proc.set_progress(1.0)
            return None

        return body
