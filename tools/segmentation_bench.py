"""Segmentation benchmark — BASELINE.md config 3.

Measures the missing BASELINE benchmark config: novelty segmentation of a
5-minute file with ``corrLen`` 44100 (half-window 86 feature frames at the
default 1024/512 resolution) and 20 breaks, on whatever backend is active
(the GPU by default; ``STRUGATZKI_PLATFORM=cpu`` for a CPU rehearsal).

Reference equivalent: FeatureSegmentationImpl.scala's sliding half-window
loop — O(numWindows x winLen x channels) sequential host work, plus disk
re-reads.  Here the whole novelty curve is one device dispatch
(kernels/corr.py::novelty_trace) and the break selection replays on host.

Reports (stderr), then one JSON line (stdout):
  - end-to-end ``segment_features`` wall (best of 3 after compile),
  - device novelty-trace time with a forced fetch (the honest device share),
  - host selection-replay share.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    from strugatzki_tpu.analysis.segmentation import segment_features
    from strugatzki_tpu.config import SegmentationConfig
    from strugatzki_tpu.kernels import corr as K
    from strugatzki_tpu.span import Span

    import jax
    import jax.numpy as jnp

    print(f"devices: {jax.devices()}", file=sys.stderr)

    sr = 44100.0
    fft, step = 1024, 512
    dur_s = 300.0                       # 5-minute file
    num_frames = int(np.ceil(dur_s * sr / step)) - 1   # extraction frame rule
    channels = 14                       # 1 loudness + 13 MFCC

    # synthesize a feature matrix with real segment structure: 10 sections
    # with distinct channel means, plus noise — so the 20 requested breaks
    # are meaningful minima, not ties
    rng = np.random.default_rng(42)
    feats = rng.standard_normal((channels, num_frames)).astype(np.float32) * 0.1
    bounds = np.linspace(0, num_frames, 11).astype(int)
    for i in range(10):
        feats[:, bounds[i]:bounds[i + 1]] += \
            rng.standard_normal((channels, 1)).astype(np.float32)

    cfg = SegmentationConfig(span=Span.all(), corr_len=44100,
                             temporal_weight=0.5, num_breaks=20,
                             normalize=False).build()

    half_win = 44100 // step            # 86 feature frames
    print(f"config: {num_frames} frames x {channels} ch, half-window "
          f"{half_win}, {cfg.num_breaks} breaks", file=sys.stderr)

    # ---- end-to-end (device trace + host replay), compile then best-of-3 --
    t0 = time.perf_counter()
    breaks = segment_features(feats, None, step, cfg)
    t_compile = time.perf_counter() - t0
    print(f"first call (incl. compile): {t_compile:.2f}s, "
          f"{len(breaks)} breaks", file=sys.stderr)

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        breaks = segment_features(feats, None, step, cfg)
        walls.append(time.perf_counter() - t0)
    wall = min(walls)

    # ---- device-only novelty trace with forced scalar fetch ---------------
    xs, _, _ = K.shift_per_group(feats)
    num_windows = feats.shape[1] - 2 * half_win + 1
    xs_dev = jnp.asarray(xs)
    tw = jnp.float32(cfg.temporal_weight)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        sims = K.novelty_trace(xs_dev, half_win, tw)
        float(sims[-1])                 # dependent fetch defeats async ack
        ts.append(time.perf_counter() - t0)
    t_dev = min(ts)

    print(f"end-to-end: best of 3 {[round(w, 3) for w in walls]}s -> "
          f"{wall * 1e3:.0f} ms for a {dur_s:.0f}s file "
          f"({dur_s / wall:.0f}x realtime); device novelty trace "
          f"{t_dev * 1e3:.0f} ms ({num_windows} windows), host replay+fetch "
          f"{(wall - t_dev) * 1e3:.0f} ms", file=sys.stderr)
    print(f"breaks: {[(round(b.sim, 4), b.pos) for b in breaks[:5]]} ...",
          file=sys.stderr)

    print(json.dumps({
        "metric": "segmentation 5-min file (corrLen 44100, 20 breaks)",
        "value": round(wall * 1e3, 1),
        "unit": "ms",
        "device_ms": round(t_dev * 1e3, 1),
        "x_realtime": round(dur_s / wall, 0),
    }))


if __name__ == "__main__":
    main()
