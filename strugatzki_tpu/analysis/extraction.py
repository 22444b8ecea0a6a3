"""Feature extraction processor.

JAX replacement of the reference's extraction path
(impl/FeatureExtractionImpl.scala + impl/NonRealtimeProcessor.scala): instead
of rendering a synth graph in an scsynth subprocess driven by an OSC command
file, the framed DSP pipeline (dsp/frontend.py) runs in-process as jitted XLA.

Behavioral parity:

* channel collapse Mix (sum) / First / Last (FeatureExtractionImpl.scala:45-49)
* output: float32 AIFC, ``numCoeffs+1`` channels, rate ``sampleRate/stepSize``,
  ``ceil(inFrames/step) − 1`` frames, channel 0 = Loudness/32, 1.. = MFCC
  (NonRealtimeProcessor.scala:93,107-109,164; FeatureExtractionImpl.scala:50-54)
* NaN fixup with per-1024-frame state reset — the reference's stitch loop
  recreates its ``lasts`` array for every 1024-frame temp chunk
  (NonRealtimeProcessor.scala:178-190)
* progress: 80% render / 20% write (NonRealtimeProcessor.scala:158,194)
* XML meta sidecar written when ``meta_output`` is set
  (FeatureExtractionImpl.scala:72-77)
"""

from __future__ import annotations

import numpy as np

from ..config import ChannelsBehavior, ExtractionConfig
from ..dsp.frontend import extract_features, extract_features_streaming
from ..io import audiofile as af
from ..runtime.processor import Processor, ProcessorFactory

__all__ = ["FeatureExtraction", "fix_nans"]

#: files longer than this many samples stream through bounded-memory chunks
STREAMING_THRESHOLD = 1 << 24  # ~6.3 min mono at 44.1k
#: grouped CLI extraction: flush a group at this many files or this many
#: PROJECTED STAGED bytes, whichever first (one fused dispatch + one fetch
#: per group).  The staged batch is power-of-two-padded B × longest-row
#: (dsp/frontend.stage_resident_batch), so the budget must count that
#: padded allocation — raw payload bytes would let one long file after
#: many short ones balloon the host buffer ~B× past the budget
_GROUP_MAX_FILES = 64
_GROUP_MAX_BYTES = 32 << 20


def _group_staged_bytes(group) -> int:
    """Projected host/upload bytes for a pending group: next-pow2 batch ×
    longest padded row × the staged itemsize (int16 rows stay 2 B only
    when the WHOLE batch is int16 — mixed batches widen to f32, matching
    stage_resident_batch's dtype rule)."""
    b_pad = 1 << max(0, (len(group) - 1).bit_length())
    max_len = max(len(t[3]) for t in group)
    item = 2 if all(t[3].dtype == np.int16 for t in group) else 4
    return b_pad * max_len * item


def fix_nans(features: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """Replace NaNs with the last non-NaN per channel, resetting the carried
    value to 0 at every ``chunk`` boundary (NonRealtimeProcessor.scala:178-190:
    ``lasts`` is re-allocated per temp-file chunk)."""
    out = np.array(features, dtype=np.float32, order="C")  # one copy
    from ..io import native as _native
    if _native.fix_nans(out, chunk):
        return out
    num_ch, total = out.shape
    for start in range(0, total, chunk):
        blk = out[:, start:start + chunk]
        mask = np.isnan(blk)
        if not mask.any():
            continue
        n = blk.shape[1]
        # vectorized forward fill: index of the last non-NaN at or before i,
        # −1 (→ fill value 0.0) when none yet in this chunk
        idx = np.where(~mask, np.arange(n)[None, :], -1)
        np.maximum.accumulate(idx, axis=1, out=idx)
        padded = np.concatenate(
            [np.zeros((num_ch, 1), blk.dtype), blk], axis=1)
        out[:, start:start + chunk] = np.take_along_axis(padded, idx + 1, axis=1)
    return out


def _collapse_mono(block: np.ndarray, spec, cfg) -> np.ndarray:
    """Channel collapse (Mix = SUM / First / Last,
    FeatureExtractionImpl.scala:45-49) + the lossless raw-int16 shipping
    path for PCM16 sources (halves the upload bytes, dsp/frontend.py)."""
    if cfg.channels_behavior == ChannelsBehavior.MIX:
        mono = block.sum(axis=0)
    elif cfg.channels_behavior == ChannelsBehavior.FIRST:
        mono = block[0]
    else:
        mono = block[spec.num_channels - 1]
    if (spec.sample_format == af.SampleFormat.INT16
            and (spec.num_channels == 1
                 or cfg.channels_behavior != ChannelsBehavior.MIX)):
        mono = np.round(mono * 32768.0).astype(np.int16)
    return mono


def _stream_body(proc: Processor, cfg: ExtractionConfig, spec) -> None:
    """Bounded-memory path: chunked read → streaming extraction → incremental
    feature-file write (the reference streams through scsynth + a chunked
    stitch, NonRealtimeProcessor.scala:98-200)."""
    step = cfg.step_size
    feat_rate = spec.sample_rate / step

    reader = af.open_read(cfg.audio_input)
    writer = af.open_write(cfg.feature_output,
                           af.feature_spec(cfg.num_features, feat_rate))
    try:
        def read_samples(n):
            proc.check_aborted()
            return _collapse_mono(reader.read_frames(n), spec, cfg)

        def emit(feats):
            writer.write_frames(fix_nans(feats))

        with proc.sub(0.95):
            extract_features_streaming(
                read_samples, spec.num_frames, spec.sample_rate, emit,
                num_coeffs=cfg.num_coeffs, fft_size=cfg.fft_size,
                fft_overlap=cfg.fft_overlap,
                progress=proc.set_progress)
    finally:
        reader.close()
        writer.close()

    if cfg.meta_output:
        cfg.save_xml(cfg.meta_output)
    proc.set_progress(1.0)
    return None


def extract_batch_cli(in_files, target_dir: str, chan_mode: int) -> int:
    """Batch extraction for the CLI ``-f`` sweep.

    Small files are grouped (same sample rate, to a file-count/byte budget) into single
    vmapped device dispatches — per-file dispatch overhead dominates small
    files on remote chips — while large files take the streaming path.
    The transcript interleaves per file exactly like the reference's
    sequential chain (Strugatzki.scala:495-511, :610-631):
    ``Starting extraction…`` / 25-# bar + ``  Success.`` /
    ``success = … - tail? …`` — in grouped mode the first file's
    ``Starting`` line prints before the async device dispatch (overlapping
    the group's compute), then ONE blocking d2h fetch brings the whole
    group back and the per-file lines print from host memory.  The chain
    aborts on the first failure.
    """
    import os
    import traceback

    from ..dsp.frontend import (extract_features_batch, finalize_features,
                                num_output_frames)
    from ..io import audiofile as af_

    in_files = list(in_files)
    group: list = []           # (index, head, cfg, mono, sr)

    # opt-in multi-chip sweep: STRUGATZKI_MESH=1 shards each grouped
    # dispatch over all local devices (data parallel over files)
    from ..parallel.sweep import env_mesh
    mesh = env_mesh()

    def report(idx: int, success: bool) -> None:
        # the reference's whenDone debug line (Strugatzki.scala:507)
        tail = idx + 1 < len(in_files)
        print(f"success = {'true' if success else 'false'} - "
              f"tail? {'true' if tail else 'false'}")

    def flush_group() -> bool:
        """Dispatch and report the pending group; on a per-file failure,
        report it like the reference chain and abort (returns False).
        Always leaves the group empty."""
        if not group:
            return True
        pending = list(group)
        group.clear()
        sr = pending[0][4]
        # announce the first file, then dispatch the whole group async: the
        # transcript below overlaps the device compute
        print(f"Starting extraction... {os.path.basename(pending[0][1])}")
        try:
            audios = [m for _, _, _, m, _ in pending]
            # pad the batch to a power-of-two size: B is a jit-key
            # dimension and remote compiles cost minutes — dummies are
            # 1-sample silence, sliced away below
            b_pad = 1 << max(0, (len(audios) - 1).bit_length())
            audios += [np.zeros(1, audios[0].dtype)] * (b_pad - len(audios))
            # thread the group's extraction parameters explicitly — the
            # frontend defaults happen to equal ExtractionConfig's today,
            # but the write path below uses cfg.step_size/num_features and
            # a silent mismatch would produce wrong frame counts
            head_cfg = pending[0][2]
            feats_dev, _ = extract_features_batch(
                audios, sr, num_coeffs=head_cfg.num_coeffs,
                fft_size=head_cfg.fft_size,
                fft_overlap=head_cfg.fft_overlap, as_device=True,
                mesh=mesh)
        except Exception as e:  # noqa: BLE001 - first file carries the failure
            print("  Failed: ")
            traceback.print_exception(type(e), e, e.__traceback__)
            report(pending[0][0], False)
            return False
        feats_host = np.asarray(feats_dev)   # ONE d2h round trip per group
        for i, (idx, head, cfg, mono, _) in enumerate(pending):
            if i > 0:
                print(f"Starting extraction... {os.path.basename(head)}")
            try:
                total = num_output_frames(len(mono), cfg.step_size)
                feats = fix_nans(finalize_features(feats_host[i], total))
                af_.write(cfg.feature_output, feats,
                          af_.feature_spec(cfg.num_features,
                                           sr / cfg.step_size))
                if cfg.meta_output:
                    cfg.save_xml(cfg.meta_output)
            except Exception as e:  # noqa: BLE001 - abort chain at this file
                print("  Failed: ")
                traceback.print_exception(type(e), e, e.__traceback__)
                report(idx, False)
                return False
            print("#" * 25 + "  Success.")
            report(idx, True)
        return True

    ok = True
    for idx, head in enumerate(in_files):
        name1 = os.path.splitext(os.path.basename(head))[0]
        cfg = ExtractionConfig(
            audio_input=head,
            feature_output=os.path.join(target_dir, f"{name1}_feat.aif"),
            meta_output=os.path.join(target_dir, f"{name1}_feat.xml"),
            channels_behavior=chan_mode).build()
        announced = False
        try:
            spec = af_.read_spec(head)
            if spec.num_frames * spec.num_channels > STREAMING_THRESHOLD:
                if not flush_group():
                    ok = False
                    break
                print(f"Starting extraction... {os.path.basename(head)}")
                announced = True
                proc = FeatureExtraction.run(cfg)
                proc.result()
                print("#" * 25 + "  Success.")
                report(idx, True)
                continue
            audio, spec = af_.read(head)
            mono = _collapse_mono(audio, spec, cfg)
            entry = (idx, head, cfg, mono, spec.sample_rate)
            if group and group[0][4] != spec.sample_rate:
                if not flush_group():
                    ok = False
                    break
            # flush BEFORE appending a file that would blow the projected
            # padded-batch budget (e.g. one near-threshold file after many
            # short ones would otherwise pad every row to its length)
            if group and _group_staged_bytes(group + [entry]) \
                    >= _GROUP_MAX_BYTES:
                if not flush_group():
                    ok = False
                    break
            group.append(entry)
            # flush on a file-count or projected staged-byte budget: bigger
            # groups amortize the per-dispatch latency over more files
            if (len(group) >= _GROUP_MAX_FILES
                    or _group_staged_bytes(group) >= _GROUP_MAX_BYTES):
                if not flush_group():
                    ok = False
                    break
        except Exception as e:  # noqa: BLE001 - per-file failure ends the chain
            if not flush_group():
                ok = False
                break
            if not announced:
                print(f"Starting extraction... {os.path.basename(head)}")
            print("  Failed: ")
            traceback.print_exception(type(e), e, e.__traceback__)
            report(idx, False)
            ok = False
            break
    if ok:
        ok = flush_group()
    return 0 if ok else 1


class FeatureExtraction(ProcessorFactory):
    """``FeatureExtraction.run(config, observer) -> Processor[None]``."""

    name = "feature extraction"
    Config = ExtractionConfig

    @classmethod
    def _make_body(cls, config: ExtractionConfig):
        cfg = config.build()

        def body(proc: Processor):
            spec = af.read_spec(cfg.audio_input)
            if spec.num_frames * spec.num_channels > STREAMING_THRESHOLD:
                return _stream_body(proc, cfg, spec)
            audio, spec = af.read(cfg.audio_input)
            proc.check_aborted()
            mono = _collapse_mono(audio, spec, cfg)

            step = cfg.step_size
            feat_rate = spec.sample_rate / step

            with proc.sub(0.8):
                # one fused dispatch: progress fires once at 1.0 and the
                # abort lands after the device round-trip (there is no
                # host boundary inside the render to poll; the streaming
                # path above is the chunk-granular one).  The reference's
                # incremental 0..0.8 render progress becomes one jump —
                # same terminal weighting (NonRealtimeProcessor.scala:158)
                feats = extract_features(
                    mono, spec.sample_rate,
                    num_coeffs=cfg.num_coeffs, fft_size=cfg.fft_size,
                    fft_overlap=cfg.fft_overlap,
                    progress=lambda f: (proc.check_aborted(),
                                        proc.set_progress(f)))

            proc.check_aborted()
            feats = fix_nans(feats)

            with proc.sub(0.2):
                af.write(cfg.feature_output, feats,
                         af.feature_spec(cfg.num_features, feat_rate))
                proc.set_progress(1.0)

            if cfg.meta_output:
                cfg.save_xml(cfg.meta_output)
            return None

        return body
