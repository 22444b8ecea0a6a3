"""Multi-chip walkthrough: every analysis path over a device mesh.

The reference is single-threaded end-to-end (README.md:83); this framework
scales two ways on a ``jax.sharding.Mesh``:

- a **files axis** (data parallel): batch extraction, the correlation
  search, the resident database, batched segmentation, and the
  self-similarity gram shard independent work over devices;
- a **time axis** (sequence/context parallel): ONE long file's extraction,
  correlation trace, or novelty curve splits into per-device slabs with a
  halo so each shard computes locally — no collectives in the hot path.

No multi-chip hardware is needed to try it — run on a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py

On a multi-GPU host, drop the env vars (the mesh spans the attached
GPUs).  The CLI gets the same behavior from ``STRUGATZKI_MESH=1``
(see README; ``0``/``false``/``off``/unset keep the single-device
programs and their compile cache).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
        import jax
        jax.config.update("jax_platforms", "cpu")   # before backend init
    import jax

    from strugatzki_tpu.analysis.correlation import InputTemplate
    from strugatzki_tpu.dsp.frontend import extract_features_batch
    from strugatzki_tpu.kernels import corr as K
    from strugatzki_tpu.parallel.database import FeatureDatabase
    from strugatzki_tpu.parallel.sweep import (make_files_mesh,
                                               sharded_extract_long,
                                               sharded_long_file_trace,
                                               sharded_long_novelty_trace)

    devs = jax.devices()
    if len(devs) < 2:
        print("need >1 device (see the XLA_FLAGS line in the docstring)")
        return
    mesh = make_files_mesh()
    print(f"mesh: {len(devs)} x {devs[0].platform}")

    rng = np.random.default_rng(0)

    # --- files axis: batch extraction ----------------------------------
    audios = [(0.2 * rng.standard_normal(44100 + 5000 * i)).astype(np.float32)
              for i in range(12)]
    feats = extract_features_batch(audios, 44100.0, mesh=mesh)
    print(f"batch extraction: {len(audios)} files -> {feats.shape} "
          f"(rows sharded over 'files')")

    # --- time axis: ONE long file, extraction + trace + novelty --------
    long_audio = (0.2 * rng.standard_normal(60 * 44100)).astype(np.float32)
    long_feats = sharded_extract_long(long_audio, 44100.0, mesh)
    print(f"sequence-parallel extraction: 60 s -> {long_feats.shape} "
          f"(per-chip slabs, one halo frame)")

    xs, shift_t, _ = K.shift_per_group(np.abs(long_feats))
    tmpl = InputTemplate(np.abs(long_feats[:, 300:380]).copy())
    sims, _ = sharded_long_file_trace(xs, shift_t, tmpl, 0.5, 8.0, mesh)
    print(f"sequence-parallel correlation trace: {sims.shape[0]} windows, "
          f"self-match at {int(np.argmax(sims))} (planted 300), "
          f"sim={sims.max():.4f}")

    nov = sharded_long_novelty_trace(xs, 86, 0.5, mesh)
    print(f"sequence-parallel novelty curve: {nov.shape[0]} windows")

    # --- files axis: the resident serving database ---------------------
    files = []
    for i in range(16):
        base = rng.uniform(0.3, 0.7, size=(14, 1))
        f = np.abs(base + 0.1 * rng.standard_normal((14, 1500)))
        files.append((f"take{i:02d}.aif", f.astype(np.float32)))
    inp = np.abs(0.5 + 0.1 * rng.standard_normal((14, 400))).astype(np.float32)
    files[5][1][:, 700:760] = inp[:, 40:100]
    db = FeatureDatabase(files, norm=None, mesh=mesh)
    hit = db.query(InputTemplate(inp[:, 40:100].copy()), k=1) \
            .matches(punch_len=60, step_size=512, k_total=1)[0]
    print(f"sharded database query: {hit.file} @ frame "
          f"{hit.punch.start // 512} sim={hit.sim:.4f} (planted take05 @ 700)")

    # factory-level: the full correlation search / self-similarity / the
    # segmentation run take the same mesh through their classvars — the
    # CLI sets them from STRUGATZKI_MESH (strugatzki_tpu/cli.py)
    print("ok")


if __name__ == "__main__":
    main()
