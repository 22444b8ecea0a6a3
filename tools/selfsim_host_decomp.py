"""Host-side decomposition of the giant self-similarity render.

At the 46340 extent ceiling the streaming render's device compute is a
small part of the whole (on the GPU: not measured), so the residual
lives in the HOST half of the stripe pipeline.  This tool
measures that half stage-by-stage with synthetic device outputs — no chip
needed — and extrapolates each stage to the full ceiling render:

    stripe assembly   (triu mirror + transpose writes into [n, block])
    y-flip + contig   (stripe.T[::-1] materialization)
    palette lookup    (_pix_to_rgb u16 -> RGB8)
    PNG filter+deflate (write_png_rows at --levels, default 1 and 6)

Usage:
    python tools/selfsim_host_decomp.py [--extent N] [--stripes K]
                                        [--levels 1,6] [--out PATH]

Defaults: extent 46340 (the reference ceiling, SelfSimilarityImpl.
scala:81-91), 4 sampled stripes, PNG output to a temp file (deleted).
Per-stage times print to stderr; one summary table to stdout.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--extent", type=int, default=46340)
    ap.add_argument("--stripes", type=int, default=4)
    ap.add_argument("--levels", default="1,6")
    ap.add_argument("--gray", action="store_true",
                    help="grayscale path (no palette lookup)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    from strugatzki_tpu.analysis import self_similarity as SS
    from strugatzki_tpu.util.png import write_png_rows

    n = args.extent
    block = SS._BLOCK
    num_blocks = -(-n // block)
    rng = np.random.default_rng(0)

    # synthetic device outputs: one stripe's worth of [block, block] u16
    # sim blocks (palette indices), the same shapes collect_stripe sees
    gsize = SS._PAIRS_PER_CALL
    dtype = np.uint8 if args.gray else np.uint16
    kmax = 255 if args.gray else 252

    def smooth_block():
        # realistic texture: similarity surfaces are smooth with banding
        # (real 46340 render compressed to ~0.28 of raw; pure random u16
        # barely compresses and overstates deflate cost ~2x)
        i = np.arange(block, dtype=np.float32)
        base = (np.sin(i[:, None] / 23.0) * np.cos(i[None, :] / 31.0)
                + 0.15 * rng.standard_normal((block, block)))
        v = (base - base.min()) / np.ptp(base)
        return (v * kmax).astype(dtype)

    sims_groups = [np.stack([smooth_block() for _ in range(gsize)])
                   for _ in range(-(-num_blocks // gsize))]

    t_asm = t_flip = t_rgb = 0.0
    deflate_t = {int(s): 0.0 for s in args.levels.split(",")}
    sizes = {k: 0 for k in deflate_t}
    bj = num_blocks - 1                       # a full-width stripe
    c0, c1 = bj * block, min(bj * block + block, n)

    stripes_rgb = []
    for it in range(args.stripes):
        t0 = time.perf_counter()
        stripe = np.empty((n, c1 - c0), dtype)
        gi = 0
        for g0 in range(0, num_blocks, gsize):
            group = list(range(g0, min(g0 + gsize, num_blocks)))
            sims_g = sims_groups[gi % len(sims_groups)]
            gi += 1
            for q, bi in enumerate(group):
                r0, r1 = bi * block, min(bi * block + block, n)
                sims = sims_g[q]
                if bi == bj:
                    s = sims[:r1 - r0, :c1 - c0]
                    stripe[r0:r1] = np.triu(s) + np.triu(s, 1).T
                elif bi < bj:
                    stripe[r0:r1] = sims[:r1 - r0, :c1 - c0]
                else:
                    stripe[r0:r1] = sims[:c1 - c0, :r1 - r0].T
        t1 = time.perf_counter()
        flipped = np.ascontiguousarray(stripe.T[::-1])
        t2 = time.perf_counter()
        rgb = SS._pix_to_rgb(flipped, args.gray)
        t3 = time.perf_counter()
        t_asm += t1 - t0
        t_flip += t2 - t1
        t_rgb += t3 - t2
        stripes_rgb.append(np.ascontiguousarray(rgb))

    # deflate: feed the sampled stripes through the real writer per level
    for lv in deflate_t:
        path = args.out or os.path.join(tempfile.gettempdir(),
                                        f"decomp_l{lv}.png")
        h = sum(s.shape[0] for s in stripes_rgb)
        t0 = time.perf_counter()
        write_png_rows(path, h, n, iter(stripes_rgb), level=lv)
        deflate_t[lv] = time.perf_counter() - t0
        sizes[lv] = os.path.getsize(path)
        if not args.out:
            os.unlink(path)

    k = args.stripes
    px_per_stripe = n * (c1 - c0)
    scale = num_blocks / k                     # sampled stripes → full image
    print(f"extent {n} ({num_blocks} stripes of {block}); sampled {k}; "
          f"{px_per_stripe / 1e6:.1f} Mpx/stripe", file=sys.stderr)

    def row(name, secs_sampled):
        full = secs_sampled * scale
        mbps = k * px_per_stripe * (3 if name.startswith('deflate')
                                    else dtype().itemsize) / secs_sampled / 1e6
        print(f"{name:<22} {secs_sampled / k * 1e3:8.0f} ms/stripe  "
              f"-> {full / 60:6.2f} min full render  ({mbps:.0f} MB/s)")

    row("stripe assembly", t_asm)
    row("y-flip contiguous", t_flip)
    row("palette->RGB", t_rgb)
    for lv, secs in sorted(deflate_t.items()):
        ratio = sizes[lv] / (k * px_per_stripe * 3)
        row(f"deflate level {lv}", secs)
        print(f"{'':<22} compressed ratio {ratio:.3f} "
              f"({sizes[lv] / 1e6:.0f} MB for the sample)")
    host_total = (t_asm + t_flip + t_rgb + min(deflate_t.values())) * scale
    print(f"host half total (best level): {host_total / 60:.2f} min at "
          f"extent {n}")


if __name__ == "__main__":
    main()
