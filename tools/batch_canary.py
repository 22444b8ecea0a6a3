"""Planted-match canary for the batched serving kernels — run this on
the GPU after any jax/XLA/driver update.

    python tools/batch_canary.py [--spectra] [--compact] [--mesh N]

``--spectra`` caches full complex64 spectra; ``--compact`` uses the
production 10k serving mode (planar bf16 spectra + window-sum table),
which also checks the raw sums-trace sims with the re-rank disabled.

Exits non-zero on FAIL.  Detects silently deflated sims in the
queries-axis-vmapped batched trace programs (a compiler fault seen on the
former accelerator, docs/PARITY.md) by asserting planted exact matches return
sim 1.0 through the PRODUCTION chunked kernels at the validated per-step
lane budget.  See strugatzki_tpu/parallel/canary.py for the shape rationale.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax

    from strugatzki_tpu.parallel.canary import format_report, run_batch_canary

    mesh = None
    if "--mesh" in sys.argv:
        n = int(sys.argv[sys.argv.index("--mesh") + 1])
        mesh = jax.sharding.Mesh(jax.devices()[:n], ("files",))
    print(f"devices: {jax.devices()}", file=sys.stderr)
    cache = ("bf16" if "--compact" in sys.argv
             else "--spectra" in sys.argv)
    report = run_batch_canary(cache_spectra=cache, mesh=mesh)
    print(format_report(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
