"""The 10k-file north-star scenario, end to end on the GPU: synthesize
10,000 two-minute feature files (5.8 GB), stage them resident (slab-wise),
and answer a 10 s punch query — north star < 1 s (BASELINE.json); with
--punch, the full punch-in × punch-out combined search.  On the H100:
not benchmarked yet (chip_smoke.py prints one run as information).

``--compact`` stages f32 features + a PLANAR bf16 spectra cache
(~10.8 GiB resident vs 5.8 GiB features-only f32): queries then skip
every forward FFT, and the automatic exact re-rank — now a DEVICE kernel
over the resident f32 features (+4x k-inflation, capped at the 4096
globally best candidates) — makes those returned hits exact.
``--bf16`` keeps the bf16-features capacity combo (host re-rank) for
comparison.

``--memmap`` streams per-file synthesized entries straight into the
disk-backed raw store: host RSS stays O(one file) through the whole 10k
staging instead of holding a ~5.8 GB second copy for the life of the
process (the log line prints ru_maxrss as evidence).

``--saveload`` (pairs with ``--memmap``) exercises the streamed
save/load cycle at scale: the archive is written row-by-row (atomic
temp+rename, ``compresslevel=1``), then a FRESH subprocess streams it
back into a memmap store (``load(..., raw_store="memmap")``), re-stages
on device and answers the same query — its own ru_maxrss is the
bounded-RSS evidence for the load direction.

    python tools/db10k_bench.py [--punch] [--compact | --bf16] [--memmap]
                                [--saveload]
"""

import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel.database import FeatureDatabase

n_files, file_frames, punch = 10000, 10336, 861
# smoke-test scale override (e.g. STRUG_BENCH_FILES=64 on CPU); headline
# captures use the 10k default
n_files = int(os.environ.get("STRUG_BENCH_FILES", n_files))
probe = min(77, n_files - 1)
memmap = "--memmap" in sys.argv


def synth(i):
    r = np.random.default_rng(1000 + i)
    base = r.uniform(0.3, 0.7, size=(14, 1)).astype(np.float32)
    return np.abs(base + 0.1 * r.standard_normal(
        (14, file_frames)).astype(np.float32))


if memmap:
    entries = ((f"f{i}.aif", synth(i)) for i in range(n_files))
    tmpl = InputTemplate(synth(probe)[:, 100:100 + punch].copy())
else:
    rng = np.random.default_rng(0)
    base = rng.uniform(0.3, 0.7, size=(n_files, 14, 1)).astype(np.float32)
    feats = np.abs(base + 0.1 * rng.standard_normal(
        (n_files, 14, file_frames)).astype(np.float32))
    entries = [(f"f{i}.aif", feats[i]) for i in range(n_files)]
    tmpl = InputTemplate(feats[probe][:, 100:100 + punch].copy())
kw = dict(raw_store="memmap", time_capacity=file_frames) if memmap else {}
t0 = time.perf_counter()
if "--compact" in sys.argv:
    db = FeatureDatabase(entries, norm=None, cache_spectra="bf16", **kw)
elif "--bf16" in sys.argv:
    import jax.numpy as jnp
    db = FeatureDatabase(entries, norm=None, storage_dtype=jnp.bfloat16,
                         cache_spectra="bf16", **kw)
else:
    db = FeatureDatabase(entries, norm=None, **kw)
stage_s = time.perf_counter() - t0
if memmap:
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"memmap raw store: peak host RSS {rss:.2f} GiB through staging",
          flush=True)
db_bytes = db._xs.nbytes
if db._spectra is not None:
    db_bytes += sum(s.nbytes for s in db._spectra)
stats = getattr(db._xs.device, "memory_stats", lambda: None)() or {}
peak = stats.get("peak_bytes_in_use")
print(f"staged in {stage_s:.0f}s; database {db_bytes/2**30:.2f} GiB resident"
      + (f" ({db._xs.dtype} features + planar {db._spectra[0].dtype} "
         "spectra cache)" if db._spectra is not None else "")
      + (f", peak device memory {peak/2**30:.2f} GiB = "
         f"{peak/db_bytes:.2f}x the resident set (slab-wise donated "
         f"staging)" if peak else ""), flush=True)
t0 = time.perf_counter(); db.query(tmpl)
print(f"compile {time.perf_counter()-t0:.0f}s", flush=True)
ts = []
for _ in range(5):
    t0 = time.perf_counter(); res = db.query(tmpl); ts.append(time.perf_counter()-t0)
    print(f"  query: {ts[-1]*1e3:.0f} ms", flush=True)   # survive timeouts
print(f"10k query (async chunk fetch): {sorted(round(x*1e3) for x in ts)} ms", flush=True)
print(f"hit: {res.frames[probe,0]} sim={res.sims[probe,0]:.4f}", flush=True)
# deflated-sims canary (docs/PARITY.md): the planted self-match must come
# back EXACT, not just top-ranked — a compiler fault of the kind seen on
# the former accelerator deflates values while often keeping the
# ranking, which a frames-only check would miss
assert res.frames[probe, 0] == 100, res.frames[probe, 0]
assert res.sims[probe, 0] > 0.999, res.sims[probe, 0]

if "--saveload" in sys.argv:
    import subprocess
    import tempfile

    arch = os.path.join(tempfile.gettempdir(), "db10k_saveload.npz")
    t0 = time.perf_counter()
    db.save(arch, compresslevel=1)
    save_s = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"streamed save: {save_s:.0f}s, "
          f"{os.path.getsize(arch)/2**30:.2f} GiB archive "
          f"(compresslevel=1); process peak RSS now {rss:.2f} GiB",
          flush=True)
    child = f"""
import os, resource, sys, time
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
import numpy as np
from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel.database import FeatureDatabase
t0 = time.perf_counter()
db = FeatureDatabase.load({arch!r}, raw_store="memmap")
print(f"streamed load + restage: {{time.perf_counter()-t0:.0f}}s", flush=True)
tmpl = InputTemplate(np.asarray(db._raw[{probe}][:, 100:100 + {punch}]).copy())
t0 = time.perf_counter(); res = db.query(tmpl)
print(f"loaded-db query (incl. compile): {{time.perf_counter()-t0:.1f}}s "
      f"hit {{res.frames[{probe},0]}} sim={{res.sims[{probe},0]:.4f}}", flush=True)
# VmHWM: ru_maxrss would carry the fork footprint of the multi-GiB
# bench parent (the subprocess COW-shares its address space pre-exec)
hwm_kb = next(int(ln.split()[1]) for ln in open("/proc/self/status")
              if ln.startswith("VmHWM:"))
print(f"loader subprocess peak RSS {{hwm_kb / 2**20:.2f}} GiB "
      f"(streamed load: no decompressed raw stack was ever resident)",
      flush=True)
assert res.frames[{probe}, 0] == 100, res.frames[{probe}, 0]
assert res.sims[{probe}, 0] > 0.999, res.sims[{probe}, 0]
"""
    r = subprocess.run([sys.executable, "-c", child], text=True)
    os.unlink(arch)
    assert r.returncode == 0, r.returncode

if "--punch" in sys.argv:
    src77 = synth(probe) if memmap else feats[probe]
    t_out = InputTemplate(src77[:, 3000:3430].copy())       # 5 s punch-out
    t0 = time.perf_counter()
    db.query_punch(tmpl, t_out, min_punch=2000, max_punch=3500, k=2)
    print(f"punch compile {time.perf_counter()-t0:.0f}s", flush=True)
    ts = []
    for _ in range(4):
        t0 = time.perf_counter()
        pres = db.query_punch(tmpl, t_out, min_punch=2000, max_punch=3500,
                              k=2)
        ts.append(time.perf_counter() - t0)
        print(f"  punch query: {ts[-1]*1e3:.0f} ms", flush=True)
    m = pres.matches(step_size=512, k_total=1)[0]
    print(f"10k punch-in x punch-out: {sorted(round(x*1e3) for x in ts)} ms; "
          f"hit {m.file} {m.punch.start//512}..{m.punch.stop//512} "
          f"sim={m.sim:.4f}", flush=True)
    # deflated-sims canary: the punch templates are cut from file `probe`
    # (in at 100, out at 3000 -> punch length 2900 inside the band)
    assert m.file == f"f{probe}.aif" and m.punch.start // 512 == 100, m
    assert m.sim > 0.999, m.sim

if "--punchbatch" in sys.argv:
    # batched serving at database scale — Q mixed-
    # length punch pairs against the staged DB, amortized per-query
    # latency + planted-hit correctness (the "10 s punch vs 10k DB"
    # north star, amortized).  Four (l_in, l_out) buckets of q_per pairs
    # each; every pair is cut from a distinct file with its true punch
    # distance inside the band, so each has exactly one exact hit.
    q_per = int(os.environ.get("STRUG_PUNCHBATCH_QPER", "8"))
    buckets = [(861, 430), (689, 345), (517, 258), (345, 172)]
    pairs, planted = [], []
    for b, (li, lo) in enumerate(buckets):
        for q in range(q_per):
            fi = (13 * (b * q_per + q) + 5) % n_files
            src = synth(fi) if memmap else feats[fi]
            o_in = 100 + q
            o_out = o_in + 2900
            pairs.append((InputTemplate(src[:, o_in:o_in + li].copy()),
                          InputTemplate(src[:, o_out:o_out + lo].copy()),
                          2000, 3500))
            planted.append((fi, o_in))
    t0 = time.perf_counter()
    db.query_punch_batch(pairs[:1], k=2)     # bucket-1 compile
    print(f"punch-batch first-bucket compile {time.perf_counter()-t0:.0f}s",
          flush=True)
    t0 = time.perf_counter()
    bres = db.query_punch_batch(pairs, k=2)  # remaining bucket compiles
    print(f"punch-batch all-bucket compile+run {time.perf_counter()-t0:.0f}s",
          flush=True)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        bres = db.query_punch_batch(pairs, k=2)
        ts.append(time.perf_counter() - t0)
        print(f"  punch batch ({len(pairs)} pairs): {ts[-1]*1e3:.0f} ms "
              f"= {ts[-1]/len(pairs)*1e3:.0f} ms/query amortized",
              flush=True)
    for q, (fi, o_in) in enumerate(planted):
        s = float(np.asarray(bres[q].sims)[fi, 0])
        f0 = int(np.asarray(bres[q].frames)[fi, 0])
        assert f0 == o_in and s > 0.999, (q, fi, f0, s)
    # sequential comparison on the first bucket only (each sequential
    # punch is ~1 s at this scale; one bucket bounds the bench time)
    t0 = time.perf_counter()
    for p in pairs[:q_per]:
        db.query_punch(p[0], p[1], min_punch=2000, max_punch=3500, k=2)
    seq_s = time.perf_counter() - t0
    best = min(ts)
    print(f"10k punch batch: {len(pairs)} mixed-length pairs "
          f"({len(buckets)} buckets x {q_per}) best {best:.2f}s = "
          f"{best/len(pairs)*1e3:.0f} ms/query amortized; sequential "
          f"{q_per} queries {seq_s:.2f}s = {seq_s/q_per*1e3:.0f} ms/query "
          f"-> x{seq_s/q_per/(best/len(pairs)):.2f} amortization; all "
          f"{len(pairs)} planted hits exact", flush=True)
