"""Benchmark: feature extraction on one GPU, end to end and device-resident.

    python bench.py

Extracts 8 mono PCM16 signals of 120 s at 44.1 kHz (BASELINE config 1 as
a batch) two ways, in one process:

* end to end — PCM16 on the host in, features on the host out, through
  ``extract_features_batch`` (upload, one scan dispatch, fetch);
* device-resident — the same scan on input already on the card.

Prints the card (``nvidia-smi`` name and power limit) and the device as
JAX reports it, then one JSON line with the medians of ``ROUNDS`` runs.
A device that is not a GPU is refused: a CPU time is not a device number.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

SR = 44100.0
DUR_S = 120.0
FILES = 8
ROUNDS = 10


def pcm16_batch(seed: int = 0):
    """The benchmark's input: ``FILES`` int16 signals of ``DUR_S``."""
    rng = np.random.default_rng(seed)
    n = int(SR * DUR_S)
    t = np.arange(n) / SR
    x = (0.2 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 1867 * t))
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    return [pcm] * FILES


def main() -> int:
    import jax

    from strugatzki_tpu.dsp import frontend as FE
    from strugatzki_tpu.runtime.platform import card_line, require_gpu

    dev = require_gpu()[0]
    card = card_line()
    print(f"device: {dev.device_kind} ({dev.platform}); nvidia-smi: {card}",
          file=sys.stderr)

    audios = pcm16_batch()
    t0 = time.perf_counter()
    FE.extract_features_batch(audios, SR, block_frames=8192)
    print(f"warmup (incl. compile): {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    e2e = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        FE.extract_features_batch(audios, SR, block_frames=8192)
        e2e.append(time.perf_counter() - t0)

    x_dev, carry0, consts, block, nb = FE.stage_resident_batch(
        audios, SR, block_frames=8192)
    run = lambda: FE._extract_scan_batch(  # noqa: E731
        x_dev, carry0, *consts, num_blocks=nb, block=block, fft_size=1024,
        step=512)
    jax.block_until_ready(run())
    res = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        res.append(time.perf_counter() - t0)

    audio_s = DUR_S * FILES
    print(json.dumps({
        "metric": "feature extraction, 8 x 120 s PCM16",
        "e2e_s_median": float(np.median(e2e)),
        "e2e_realtime_x": audio_s / float(np.median(e2e)),
        "resident_s_median": float(np.median(res)),
        "resident_realtime_x": audio_s / float(np.median(res)),
        "rounds": ROUNDS,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
