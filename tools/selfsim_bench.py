"""Self-similarity benchmark — BASELINE.md config 4.

3-minute piece, corrLen 44100 (half-window 86), decimation 4 → a 3833×3833
matrix (15 M cells).  Measures, on the active backend:

  1. float32 matrix fetch + host colorize (60 MB of f32 sims cross to
     the host),
  2. the fused device colorization (colorWarp == 1 fast path): uint16
     palette indices / uint8 gray cross instead — 2-4× fewer bytes,
  3. full PNG write via each path.

Pixels are asserted identical between the two paths before timing.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _force_group_engine() -> None:
    """--group-engine: run the round-3 per-group engine single-device (the
    mesh path's engine) for an honest A/B against the round-4 fast engine
    — ~10 eager stacks + 1 jit call per 8-pair group vs one jitted call
    per 32 pairs."""
    import strugatzki_tpu.analysis.self_similarity as SS

    def group_engine(x1, x2, half_win, decim, tw, pix, mesh):
        n, nb, b1, b2 = SS._prep_window_blocks(x1, x2, half_win, decim)
        return (n, nb,
                lambda ps: SS._dispatch_group(b1, b2, ps, tw, pix),
                SS._PAIR_GROUP)

    SS._make_engine = group_engine
    print("engine: per-group (round-3 A/B baseline)", file=sys.stderr)


def giant() -> None:
    """--giant [extent]: stream a giant image (default extent 20001;
    ``--giant 46340`` is the reference's hard ceiling, 2.1B cells, where
    its per-cell disk loop is O(weeks)) straight to PNG: device
    colorization, bounded host memory, parallel deflate."""
    from strugatzki_tpu.analysis.self_similarity import self_similarity_to_png
    from strugatzki_tpu.kernels import corr as K

    import jax
    print(f"devices: {jax.devices()}", file=sys.stderr)
    idx = sys.argv.index("--giant")
    n = int(sys.argv[idx + 1]) if len(sys.argv) > idx + 1 \
        and sys.argv[idx + 1].isdigit() else 20001
    half_win = 4
    rng = np.random.default_rng(0)
    x = np.abs(0.5 + 0.1 * rng.standard_normal(
        (2, n + 2 * half_win - 1))).astype(np.float32)
    x, _, _ = K.shift_per_group(x)
    out = "/tmp/selfsim_giant.png"
    t0 = time.perf_counter()
    got = self_similarity_to_png(x, x, half_win, 1, 0.5, out,
                                 colors="psycho", png_level=1)
    el = time.perf_counter() - t0
    print(f"extent {got}: {el:.0f}s end-to-end "
          f"({os.path.getsize(out) / 1e6:.0f} MB PNG)", file=sys.stderr)
    print(json.dumps({
        "metric": f"giant streaming self-similarity (extent {n})",
        "value": round(el, 1), "unit": "s",
        "png_mb": round(os.path.getsize(out) / 1e6, 1)}))


def main() -> None:
    from strugatzki_tpu.analysis.self_similarity import (
        render_image, self_similarity_image, self_similarity_matrix)
    from strugatzki_tpu.kernels import corr as K
    from strugatzki_tpu.util.png import write_png

    import jax
    print(f"devices: {jax.devices()}", file=sys.stderr)

    sr, step = 44100.0, 512
    dur_s = 180.0
    num_frames = int(np.ceil(dur_s * sr / step)) - 1
    half_win, decim, tw = 86, 4, 0.5

    rng = np.random.default_rng(5)
    feats = np.abs(0.5 + 0.1 * rng.standard_normal(
        (14, num_frames))).astype(np.float32)
    x, _, _ = K.shift_per_group(feats)
    n = (num_frames - 2 * half_win + 1) // decim
    print(f"extent {n} ({n * n / 1e6:.0f}M cells)", file=sys.stderr)

    # warm both jit keys
    t0 = time.perf_counter()
    sims = self_similarity_matrix(x, x, half_win, decim, tw)
    t_c1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_dev = self_similarity_image(x, x, half_win, decim, tw, "psycho")
    t_c2 = time.perf_counter() - t0
    print(f"compiles: f32 {t_c1:.1f}s, colorized {t_c2:.1f}s",
          file=sys.stderr)
    np.testing.assert_array_equal(img_dev, render_image(sims, "psycho",
                                                        1.0, 1.0, False))
    print("pixel parity: device-colorized == host path", file=sys.stderr)

    def best3(fn):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return min(ts), ts

    t_f32, ts_f32 = best3(lambda: render_image(
        self_similarity_matrix(x, x, half_win, decim, tw),
        "psycho", 1.0, 1.0, False))
    t_pix, ts_pix = best3(lambda: self_similarity_image(
        x, x, half_win, decim, tw, "psycho"))
    print(f"matrix+host colorize (f32 fetch {n*n*4/1e6:.0f} MB): "
          f"{[round(t, 2) for t in ts_f32]}s",
          file=sys.stderr)
    print(f"device colorized     (u16 fetch {n*n*2/1e6:.0f} MB): "
          f"{[round(t, 2) for t in ts_pix]}s -> {t_f32 / t_pix:.2f}x",
          file=sys.stderr)

    out = "/tmp/selfsim_bench.png"
    t0 = time.perf_counter()
    write_png(out, img_dev := self_similarity_image(
        x, x, half_win, decim, tw, "psycho"))
    t_png = time.perf_counter() - t0
    print(f"full image -> PNG (device path): {t_png:.2f}s "
          f"({os.path.getsize(out) / 1e6:.1f} MB file)", file=sys.stderr)

    print(json.dumps({
        "metric": "self-similarity 3-min (extent 3833) image",
        "value": round(t_pix, 2),
        "unit": "s",
        "f32_path_s": round(t_f32, 2),
        "speedup": round(t_f32 / t_pix, 2),
        "png_s": round(t_png, 2),
    }))


if __name__ == "__main__":
    if "--group-engine" in sys.argv:
        _force_group_engine()
    giant() if "--giant" in sys.argv else main()
