"""Resident-database serving walkthrough.

The reference re-reads every feature file from disk for every search; the
serving model here stages the whole database in device memory once and
answers queries in single dispatches.  This example builds a tiny in-memory
database and exercises the full serving surface:

    python examples/serving.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel.database import FeatureDatabase


def main() -> None:
    rng = np.random.default_rng(0)
    step = 512

    # a database of 32 two-minute-ish feature matrices [14, T]
    files = []
    for i in range(32):
        base = rng.uniform(0.3, 0.7, size=(14, 1))
        feats = np.abs(base + 0.1 * rng.standard_normal((14, 2000 + 31 * i)))
        files.append((f"take{i:02d}.aif", feats.astype(np.float32)))
    # plant a punch-in + punch-out pair in take07 (in @400, out @650)
    inp = np.abs(0.5 + 0.1 * rng.standard_normal((14, 900))).astype(np.float32)
    files[7][1][:, 400:460] = inp[:, 100:160]
    files[7][1][:, 650:690] = inp[:, 700:740]

    # one-time staging: normalize + group-shift fused on device
    # (cache_spectra=True additionally keeps every file's forward FFTs
    # resident for ~1.8x the memory; its query speed-up: not measured)
    db = FeatureDatabase(files, norm=None)
    print(f"staged {db.num_files} files on device")

    # 1. single punch query — one dispatch, boost-aware matches
    tmpl = InputTemplate(inp[:, 100:160].copy())
    res = db.query(tmpl, k=3)
    m = res.matches(punch_len=60, step_size=step, k_total=3)[0]
    print(f"query:        {m.file} @ frame {m.punch.start // step} "
          f"sim={m.sim:.3f} boost={m.boost_in:.2f}")

    # 2. punch-in x punch-out search in ONE dispatch: the banded combine
    #    over punch lengths runs on device
    t_out = InputTemplate(inp[:, 700:740].copy())
    pres = db.query_punch(tmpl, t_out, min_punch=200, max_punch=300, k=2)
    pm = pres.matches(step_size=step, k_total=1)[0]
    print(f"query_punch:  {pm.file} frames "
          f"{pm.punch.start // step}..{pm.punch.stop // step} "
          f"sim={pm.sim:.3f} boosts=({pm.boost_in:.2f}, {pm.boost_out:.2f})")

    # 3. many templates, mixed lengths — bucketed into few dispatches
    batch = db.query_batch([tmpl, t_out, InputTemplate(files[3][1][:, :80].copy())])
    print(f"query_batch:  {len(batch)} results; best files: "
          f"{[r.matches(1, step, 1)[0].file for r in batch]}")

    # 3b. a stream of punch-pair searches: per bucket of template shapes,
    #     the per-file forward spectra are computed once for ALL pairs
    pbatch = db.query_punch_batch([(tmpl, t_out, 200, 300),
                                   (tmpl, t_out, 220, 260)])
    print(f"punch_batch:  {len(pbatch)} results; best: "
          f"{pbatch[0].matches(step, 1)[0].file}")

    # 4. compact serving mode: f32 features + PLANAR bf16 spectra cache
    #    (~10.8 GiB at 10k files — fits one chip with every forward FFT
    #    resident); the automatic 4x k-inflation + exact DEVICE re-rank
    #    (over the resident f32 features) makes the RERANK_LIMIT best
    #    returned hits exact on all three query kinds, punch included
    #    (``exact`` marks them).  For raw capacity beyond
    #    HBM, storage_dtype=jnp.bfloat16 halves the features instead
    #    (re-rank then falls back to the host f64 mirror).
    dbc = FeatureDatabase(files, norm=None, cache_spectra="bf16")
    assert dbc._rerank_device
    r16 = dbc.query(tmpl, k=3)
    p16 = dbc.query_punch(tmpl, t_out, min_punch=200, max_punch=300, k=2)
    print(f"compact mode: sim={r16.matches(60, step, 1)[0].sim:.6f}, punch "
          f"sim={p16.matches(step, 1)[0].sim:.6f} (exact after re-rank)")

    # 5. incremental updates: removal tombstones rows in O(1); adds fill
    #    the free slots — only the new files cross the link
    db.remove_files(["take03.aif", "take12.aif"])
    fresh = np.abs(0.5 + 0.1 * rng.standard_normal((14, 1500)))
    db.add_files([("fresh.aif", fresh.astype(np.float32))])
    r_new = db.query(InputTemplate(fresh[:, 50:110].astype(np.float32)), k=1)
    print(f"incremental:  {db.num_files} live files; new file found: "
          f"{r_new.matches(60, step, 1)[0].file}")

    # 6. durable serving artifact: save/load skips per-file parsing.
    #    Both directions stream row-by-row when bounded host RSS matters:
    #    save never materializes a memmap store's raw stack, and
    #    load(raw_store="memmap") decompresses straight into a fresh
    #    disk-backed store (O(one row) peak on top of the store itself)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "db.npz")
        db.save(p, compresslevel=1)
        db2 = FeatureDatabase.load(p)
        r2 = db2.query(tmpl, k=1)
        print(f"save/load:    best frame {int(r2.frames.max(initial=0))} "
              f"(same database, re-staged in one pass)")
        db3 = FeatureDatabase.load(p, raw_store="memmap")
        assert isinstance(db3._raw, np.memmap)
        r3 = db3.query(tmpl, k=1)
        print(f"streamed-load memmap store: same best frame "
              f"{int(r3.frames.max(initial=0))}, bounded host RSS")

    # 7. multi-chip: pass mesh=make_files_mesh() to shard the files axis
    #    (see tests/test_database.py::test_sharded_query_punch_matches_single
    #    and tests/test_multihost.py for the multi-process path)


if __name__ == "__main__":
    main()
