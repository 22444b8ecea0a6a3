"""On-card smoke test: the extraction, search and serving path on one GPU.

    python chip_smoke.py           # one GPU: phases 1-5 below
    python chip_smoke.py --four    # only the files-axis mesh over 4 GPUs

Drives the system through the entry points a user calls — the CLI
(``strugatzki_tpu.cli.main``) and the resident ``FeatureDatabase`` — at the
sizes a deployment runs, and compares every result with a plain reference
in the same process: the CPU backend (under ``jax.default_device``), the
float64 mirror of the reference math (``kernels/mathref.py``) or the host
colorization.  Data is synthetic and made from ``--seed``.

1. extraction through the CLI: 8 mono PCM16 AIFF files of 120 s plus one
   of 5 and one of 3 minutes (``-f``, ``--stats``); features vs CPU;
2. search through the CLI (``-c``, 10 s punch-in and punch-out) with a
   planted copy: the plant ranks first; matches identical to the CPU run;
3. ``-s`` (5-min file, corrLen 1 s, 20 breaks), ``-x`` (3-min file,
   decimation 2) and ``-y`` (30 s of a catalog file across the 5-min
   file) through the CLI vs the CPU run; the ``-x`` PNG vs the host
   colorization of the same sims; ``-s`` on a 5-min file of steady
   sections, where the one-pass window variance loses digits (ROADMAP
   B7): breaks GPU vs CPU, its novelty trace's distance from the f64
   mirror shown on both backends;
4. the resident database at 10,000 files × 14 × 10,336 frames, full
   complex64 and bf16 spectra caches: planted-match canary through all
   four query kernels, float64 re-score of returned windows (each to
   the tolerance of its kind: re-ranked exact, or raw bf16), a repeated
   query bit-identical;
5. kernel parity at real widths against the float64 mirror.

Every check prints what it compared, the worst deviation and the
tolerance; any failure raises and exits non-zero.  The last line of
standard output is one JSON object naming the device.  Without a GPU the
script exits non-zero before any phase and prints no such line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

SR = 44100.0
STEP = 512


class SmokeFailure(AssertionError):
    """A comparison fell outside its tolerance."""


@dataclass(frozen=True)
class Sizes:
    """What one run drives; :data:`FULL` is the deployment size."""
    catalog_files: int = 8          # 2-min files of the extraction batch
    catalog_secs: float = 120.0
    long_secs: float = 300.0        # segmentation input (BASELINE config 3)
    mid_secs: float = 180.0         # self-similarity input (config 4)
    punch_secs: float = 10.0        # punch-in / punch-out length (config 2)
    num_breaks: int = 20
    db_files: int = 10_000          # resident serving (north-star size)
    db_frames: int = 10_336         # 2 min at 86.13 Hz
    tmpl_frames: int = 861          # 10 s template
    queries: int = 8
    rescored: int = 256             # windows re-scored by the f64 mirror
    latency_reps: int = 5


FULL = Sizes()


def check(what: str, worst: float, tol: float) -> None:
    """Print one comparison; raise when ``worst`` is not within ``tol``
    (NaN fails)."""
    ok = bool(worst <= tol)
    print(f"  {what:<58s} worst {worst:.3e}  tol {tol:g}  "
          f"{'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{what}: {worst!r} > {tol!r}")


def check_same(what: str, same: bool, detail: str = "") -> None:
    """Print one exact comparison; raise when it does not hold."""
    print(f"  {what:<58s} {'identical' if same else 'DIFFERENT'}"
          f"{'  ' + detail if detail else ''}", flush=True)
    if not same:
        raise SmokeFailure(f"{what} differs {detail}")


def max_dev(a, b) -> float:
    """Worst absolute deviation; positions where both are NaN or the same
    infinity agree, any other NaN counts as infinite deviation."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    both = (np.isnan(a) & np.isnan(b)) | (a == b)
    with np.errstate(invalid="ignore"):
        d = np.where(both, 0.0, np.abs(a - b))
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max()) if d.size else 0.0


@contextlib.contextmanager
def on_cpu():
    """Make the CPU backend JAX's default device for every thread (the
    analysis processors run on their own threads, which a thread-local
    ``jax.default_device`` scope would not reach)."""
    import jax

    prev = jax.config.jax_default_device
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    try:
        yield
    finally:
        jax.config.update("jax_default_device", prev)


@contextlib.contextmanager
def patched(obj, name: str, value):
    """Temporarily replace ``obj.name``."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def run_cli(args):
    """``strugatzki_tpu.cli.main(args)`` in-process; returns the value of
    the processor result the CLI received (matches, breaks, ...).  The
    CLI's own printing is captured and shown only on failure."""
    from strugatzki_tpu import cli

    got = []
    real_go = cli._go

    def go(factory, config):
        res = real_go(factory, config)
        got.append(res)
        return res

    out = io.StringIO()
    with patched(cli, "_go", go), contextlib.redirect_stdout(out):
        rc = cli.main(list(args))
    if rc != 0:
        print(out.getvalue())
        raise SmokeFailure(f"cli {args[0]} exited {rc}")
    return got[-1].value if got else None


# ---------------------------------------------------------------------------
# synthetic audio
# ---------------------------------------------------------------------------

def _pcm16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -1.0, 32767 / 32768).astype(np.float32)


def catalog_signal(rng, secs: float) -> np.ndarray:
    """Noise plus two tones: the extraction benchmark's material."""
    n = int(SR * secs)
    t = np.arange(n) / SR
    f1, f2 = rng.uniform(100.0, 2000.0, 2)
    return _pcm16(0.2 * rng.standard_normal(n)
                  + 0.3 * np.sin(2 * np.pi * f1 * t)
                  + 0.1 * np.sin(2 * np.pi * f2 * t))


def sectioned_signal(rng, secs: float, mean_section: float,
                     tremolo: bool = True) -> np.ndarray:
    """Sections of distinct tone, level and noise: material with clear
    segment boundaries and block structure in its self-similarity.  With
    ``tremolo`` the loudness keeps moving inside a section as music's
    does; without it a section is steady, the input ROADMAP B7 is about."""
    n = int(SR * secs)
    out = np.empty(n, np.float64)
    pos = 0
    while pos < n:
        m = min(n - pos, int(SR * mean_section * rng.uniform(0.5, 1.5)))
        t = np.arange(m) / SR
        f = rng.uniform(80.0, 3000.0)
        rate = rng.uniform(0.5, 4.0)
        trem = 1.0 + 0.5 * np.sin(2 * np.pi * rate * t) if tremolo else 1.0
        out[pos:pos + m] = trem * (
            rng.uniform(0.05, 0.5) * np.sin(2 * np.pi * f * t)
            + rng.uniform(0.02, 0.2) * rng.standard_normal(m))
        pos += m
    return _pcm16(out)


def write_pcm16(path: str, x: np.ndarray) -> None:
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.io.audiofile import AudioFileSpec, SampleFormat
    from strugatzki_tpu.io.formats import AIFF

    af.write(path, x[None, :], AudioFileSpec(AIFF, SampleFormat.INT16, 1, SR))


# ---------------------------------------------------------------------------
# phases 1-3: the CLI
# ---------------------------------------------------------------------------

def phase_extraction(work: str, sizes: Sizes, seed: int) -> dict:
    """Write the catalog and the two long recordings, plant the punch,
    extract each set into its own database through ``-f`` and ``--stats``;
    compare one file's features with the CPU backend.

    The recordings get their own database: the reference's search admits
    a NaN sim (the square root of a negative punch-in x punch-out product,
    FeatureCorrelationImpl.scala:370), ranks it first and lets it poison
    the admission gate, and sectioned material yields such products — the
    catalog search is the one whose answer the plant fixes."""
    from strugatzki_tpu.dsp.frontend import extract_features
    from strugatzki_tpu.io import audiofile as af

    print("phase 1: extraction through the CLI (-f, --stats)", flush=True)
    rng = np.random.default_rng(seed)
    dirs = {k: (os.path.join(work, "snd", k), os.path.join(work, "db", k))
            for k in ("cat", "rec")}
    for d in dirs.values():
        for sub in d:
            os.makedirs(sub)
    p = sizes.punch_secs
    names = [f"a{i:02d}" for i in range(sizes.catalog_files)]
    sig = {n: catalog_signal(rng, sizes.catalog_secs) for n in names}
    # the punch source is a00 [2p, 6p); a copy lands in a03 at a sample
    # offset frame-aligned with the source, so its features repeat
    src0 = int(2 * p * SR)
    dst0 = src0 + STEP * int(5 * p * SR / STEP)
    n_copy = int(4 * p * SR)
    if dst0 + n_copy > len(sig["a03"]):
        raise ValueError("catalog files too short for the planted punch")
    sig["a03"][dst0:dst0 + n_copy] = sig["a00"][src0:src0 + n_copy]
    sig["long"] = sectioned_signal(rng, sizes.long_secs, 8.0)
    sig["mid"] = sectioned_signal(rng, sizes.mid_secs, 8.0)
    sig["steady"] = sectioned_signal(rng, sizes.long_secs, 8.0,
                                     tremolo=False)
    rec = ("long", "mid", "steady")
    for n, x in sig.items():
        write_pcm16(os.path.join(dirs["rec" if n in rec else "cat"][0],
                                 f"{n}.aif"), x)

    t0 = time.perf_counter()
    for snd, db in dirs.values():
        run_cli(["-f", "-d", db, snd])
    t_f = time.perf_counter() - t0
    for _, db in dirs.values():
        run_cli(["--stats", "-d", db])
    audio_s = sum(len(x) for x in sig.values()) / SR
    print(f"  extracted {len(sig)} files ({audio_s:.0f} s of audio) in "
          f"{t_f:.2f} s incl. compile; feat_norms.aif written", flush=True)

    snd, db = dirs["cat"]
    feats, _ = af.read(os.path.join(db, "a00_feat.aif"))
    audio, _ = af.read(os.path.join(snd, "a00.aif"))
    with on_cpu():
        ref = extract_features(audio[0], SR)
    check("a00 loudness row, GPU CLI vs CPU", max_dev(feats[:1], ref[:1]),
          2e-4)
    check("a00 MFCC rows, GPU CLI vs CPU", max_dev(feats[1:], ref[1:]), 2e-4)
    return {"db": db, "rec": dirs["rec"][1], "plant_start": dst0,
            "plant_dist": int(3 * p * SR)}


def phase_search(ctx: dict, sizes: Sizes) -> None:
    """``-c`` punch-in × punch-out search, GPU vs CPU, twice: with the
    reference's selection (a NaN sim — the square root of a negative
    in x out product, FeatureCorrelationImpl.scala:370 — ranks first and
    poisons the admission gate, so whether the plant survives depends on
    the visiting order), and with the ``skip_nan`` extension, where the
    planted match must rank first."""
    from strugatzki_tpu.analysis.correlation import FeatureCorrelation

    print("phase 2: search through the CLI (-c)", flush=True)
    p = sizes.punch_secs
    args = ["-c", "-d", ctx["db"],
            "--in-start", f"{2 * p}", "--in-stop", f"{3 * p}",
            "--out-start", f"{5 * p}", "--out-stop", f"{6 * p}",
            "--dur-min", f"{2 * p}", "--dur-max", f"{4 * p}", "-m", "5",
            os.path.join(ctx["db"], "a00_feat.xml")]
    for skip_nan in (False, True):
        tag = "skip_nan" if skip_nan else "reference"
        with patched(FeatureCorrelation, "skip_nan", skip_nan):
            t0 = time.perf_counter()
            gpu = run_cli(args)
            t_c = time.perf_counter() - t0
            with on_cpu():
                cpu = run_cli(args)
        n_nan = sum(np.isnan(m.sim) for m in gpu)
        print(f"  [{tag}] {len(gpu)} matches ({n_nan} NaN) in {t_c:.2f} s "
              f"incl. compile", flush=True)
        key = [(os.path.basename(m.file), m.punch.start, m.punch.stop)
               for m in gpu]
        check_same(f"[{tag}] match list (file, punch), GPU vs CPU",
                   key == [(os.path.basename(m.file), m.punch.start,
                            m.punch.stop) for m in cpu])
        check(f"[{tag}] match sims, GPU vs CPU",
              max_dev([m.sim for m in gpu], [m.sim for m in cpu]), 2e-5)
    best = gpu[0]
    start_ok = abs(best.punch.start - ctx["plant_start"]) <= STEP
    len_ok = abs(best.punch.length - ctx["plant_dist"]) <= STEP
    check_same("[skip_nan] planted match ranks first (a03, punch)",
               os.path.basename(best.file) == "a03.aif" and start_ok
               and len_ok, f"{os.path.basename(best.file)} {best.punch}")


def phase_similarity(ctx: dict, sizes: Sizes) -> dict:
    """``-s``, ``-x`` and ``-y`` through the CLI vs the CPU run; the ``-x``
    PNG also vs the host colorization of the same similarity matrix."""
    import jax.numpy as jnp

    from strugatzki_tpu.analysis import self_similarity as SS
    from strugatzki_tpu.analysis.common import full_to_feat
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.kernels import corr as K

    print("phase 3: segmentation and similarity through the CLI "
          "(-s, -x, -y)", flush=True)
    db = ctx["rec"]
    meta = lambda n: os.path.join(db, f"{n}_feat.xml")  # noqa: E731
    h = full_to_feat(int(SR), STEP)             # corrLen 1 s (config 3)

    # the breaks are the check; their sims are shown beside the f64 mirror
    # of the novelty window centred on each break: the one-pass FFT
    # variance loses digits where a section's loudness barely moves (both
    # backends alike, ROADMAP B7), so the sims are information
    for name in ("long", "steady"):
        seg = ["-s", "-d", db, "--length", "1.0", "-m",
               str(sizes.num_breaks), meta(name)]
        b_gpu = run_cli(seg)
        with on_cpu():
            b_cpu = run_cli(seg)
        check_same(f"-s {name}: break positions ({len(b_gpu)}), GPU vs CPU",
                   [b.pos for b in b_gpu] == [b.pos for b in b_cpu])
        feats = _prepared(db, name)
        ref = [_novelty_mirror(feats, b.pos // STEP - h, h) for b in b_gpu]
        s_gpu, s_cpu = [b.sim for b in b_gpu], [b.sim for b in b_cpu]
        print(f"  -s {name}: break sims (information) GPU vs CPU "
              f"{max_dev(s_gpu, s_cpu):.3e}; vs f64 mirror GPU "
              f"{max_dev(s_gpu, ref):.3e}, CPU {max_dev(s_cpu, ref):.3e}",
              flush=True)
    # B7 on the steady file: the whole novelty trace on both backends
    xs = K.shift_per_group(feats)[0]
    nov = {}
    for dev, scope in (("GPU", contextlib.nullcontext), ("CPU", on_cpu)):
        with scope():
            nov[dev] = np.asarray(K.novelty_trace(jnp.asarray(xs), h,
                                                  jnp.float32(0.5)))
    W = feats.shape[1] - 2 * h + 1
    ref = [_novelty_mirror(feats, t, h) for t in range(W)]
    print(f"  -s steady: novelty_trace ({W} windows) vs f64 mirror, open "
          f"defect ROADMAP B7 (information): GPU "
          f"{max_dev(nov['GPU'][:W], ref):.3e}, CPU "
          f"{max_dev(nov['CPU'][:W], ref):.3e}; GPU vs CPU "
          f"{max_dev(nov['GPU'][:W], nov['CPU'][:W]):.3e}", flush=True)

    # -x: device colorization (the default) and host colorization of the
    # SAME gram program's sims (device colorization switched off), on both
    # backends; the write_png / render_image hooks keep the rasters and
    # the float sims the host path colorized
    def render(tag: str, host: bool):
        out = os.path.join(db, f"mid_{tag}.png")
        kept = {}
        real_write, real_render = SS.write_png, SS.render_image

        def write_png(path, rgb, *a, **k):
            kept["rgb"] = rgb
            return real_write(path, rgb, *a, **k)

        def render_image(sims, *a, **k):
            kept["sims"] = sims
            return real_render(sims, *a, **k)

        with contextlib.ExitStack() as st:
            st.enter_context(patched(SS, "write_png", write_png))
            st.enter_context(patched(SS, "render_image", render_image))
            if host:
                st.enter_context(patched(SS, "_device_pix",
                                         lambda *a, **k: None))
            run_cli(["-x", "-d", db, "-m", "2", meta("mid"), out])
        with open(out, "rb") as f:
            kept["png"] = f.read()
        return kept

    g_dev = render("gpu_device", host=False)
    g_host = render("gpu_host", host=True)
    with on_cpu():
        c_dev = render("cpu_device", host=False)
        c_host = render("cpu_host", host=True)
    n = g_host["sims"].shape[0]
    check_same(f"-x PNG ({n}x{n}), GPU device vs host colorization",
               g_dev["png"] == g_host["png"])
    check_same("-x PNG, CPU device vs host colorization",
               c_dev["png"] == c_host["png"])
    # two compiled programs: the repo's cross-plan budget (each side is
    # within 1e-5 of the f64 mirror, phase 5)
    check("-x similarity matrix, GPU vs CPU",
          max_dev(g_host["sims"], c_host["sims"]), 2e-5)
    px_mask = np.any(g_dev["rgb"] != c_dev["rgb"], axis=-1)
    px = int(px_mask.sum())
    sims_equal = np.array_equal(g_host["sims"], c_host["sims"],
                                equal_nan=True)
    print(f"  -x PNG GPU vs CPU run: "
          f"{'byte-identical' if g_dev['png'] == c_dev['png'] else 'differs'}"
          f" ({px} of {n * n} pixels differ; sims bit-identical: "
          f"{sims_equal})", flush=True)
    # each backend's PNG is its own sims colorized bit-exactly (above), so
    # a pixel may differ only where the two backends' sims differ; image
    # pixel (y, x) is sims cell (x, n-1-y) (render_image)
    as_image = lambda s: s.T[::-1]  # noqa: E731
    check_same("-x pixels differing GPU vs CPU run lie where sims differ",
               px_mask.shape == (n, n) and not np.any(
                   px_mask & (as_image(g_host["sims"])
                              == as_image(c_host["sims"]))))

    p = sizes.punch_secs
    cross = ["-y", "-d", db, "--span1-start", f"{p}", "--span1-stop",
             f"{4 * p}", os.path.join(ctx["db"], "a01_feat.xml"),
             meta("long")]
    out_g = os.path.join(db, "cross_gpu.aif")
    out_c = os.path.join(db, "cross_cpu.aif")
    run_cli(cross + [out_g])
    with on_cpu():
        run_cli(cross + [out_c])
    y_g, _ = af.read(out_g)
    y_c, _ = af.read(out_c)
    check(f"-y cross-similarity ({y_g.shape[-1]} frames), GPU vs CPU",
          max_dev(y_g, y_c), 2e-5)
    return {"png_identical_to_cpu": g_dev["png"] == c_dev["png"],
            "png_pixels_differing": px}


# ---------------------------------------------------------------------------
# phase 4: resident serving
# ---------------------------------------------------------------------------

def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _same_result(a, b) -> bool:
    """Every array field of two query results equal, bit for bit."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) and not np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f"):
            return False
    return True


def _median_time(fn, reps: int = 5) -> float:
    import jax

    jax.block_until_ready(fn())                 # compile and warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def prep_timing(entries, card: str) -> None:
    """Staging's normalize + group-shift pass (``prepare_database_xla``)
    over the whole stack, beside a device-to-device copy of the same
    bytes: both read and write the stack once."""
    import jax
    import jax.numpy as jnp

    from strugatzki_tpu.kernels.prep import prepare_database_xla
    from strugatzki_tpu.parallel.sweep import pad_stack

    raw, lens = pad_stack([f for _, f in entries], multiple=512)
    x = jax.device_put(raw)
    lens = jax.device_put(lens)
    del raw
    norm = jnp.stack([jnp.zeros(x.shape[1]), jnp.ones(x.shape[1])], axis=1)
    t_prep = _median_time(lambda: prepare_database_xla(x, norm, lens))
    t_copy = _median_time(lambda: jnp.copy(x))
    moved = 2 * x.size * x.dtype.itemsize
    print(f"  prep (XLA) on {tuple(x.shape)}: median {t_prep * 1e3:.1f} ms "
          f"= {moved / t_prep / 1e9:.0f} GB/s read+write; device copy of "
          f"the same bytes {t_copy * 1e3:.1f} ms = "
          f"{moved / t_copy / 1e9:.0f} GB/s ({card})", flush=True)
    del x


def rescore_sample(db, res, tmpl, name: str, n: int, planted: int,
                   rng) -> None:
    """Re-score returned hits with the float64 mirror, each to the
    tolerance of its kind.  A hit the exact re-rank re-scored
    (``res.exact``) or one of a full-precision store must be within 1e-5;
    with the bf16 cache only the ``RERANK_LIMIT`` best candidates are
    re-scored, and the rest keep their raw compact sims (4e-3).  Up to
    ``n`` files of each kind are drawn — every hit re-scored, every hit
    raw, and both — plus the planted file, and all their live hits
    checked."""
    live = np.isfinite(res.sims)
    exact = np.ones(live.shape, bool) if res.exact is None else res.exact
    n_ex, n_raw = (exact & live).sum(1), (~exact & live).sum(1)
    full = "f32" if res.exact is None else "re-scored"
    kinds = {full: (n_ex > 0) & (n_raw == 0),
             "raw": (n_raw > 0) & (n_ex == 0),
             "mixed": (n_ex > 0) & (n_raw > 0)}
    rows = [np.asarray([planted])]
    for mask in kinds.values():
        cand = np.flatnonzero(mask)
        rows.append(rng.choice(cand, min(n, len(cand)), replace=False))
    rows = np.unique(np.concatenate(rows))
    fi, fj = np.nonzero(live[rows])
    fi = rows[fi]
    ref, _ = db._exact_window_scores(fi, res.frames[fi, fj], tmpl, 0.5, 8.0)
    got, is_exact = res.sims[fi, fj], exact[fi, fj]
    drawn = ", ".join(f"{int(np.isin(rows, np.flatnonzero(m)).sum())} {k}"
                      for k, m in kinds.items())
    print(f"  [{name}] f64 re-score of {len(rows)} files ({drawn})",
          flush=True)
    for want, tol, what in ((True, 1e-5, full), (False, 4e-3, "raw")):
        sel = is_exact == want
        if sel.any():
            check(f"[{name}] {what} query hits vs f64 ({int(sel.sum())} "
                  f"windows)", max_dev(got[sel], ref[sel]), tol)


def phase_serving(sizes: Sizes, seed: int, card: str) -> None:
    """The resident database at ``sizes.db_files``: canary, float64
    re-score and determinism, for the full and the bf16 spectra cache."""
    from strugatzki_tpu.parallel import canary
    from strugatzki_tpu.parallel.database import FeatureDatabase

    print(f"phase 4: resident serving, {sizes.db_files} files x 14 x "
          f"{sizes.db_frames} frames", flush=True)
    t0 = time.perf_counter()
    layout = canary.planted_layout(
        sizes.db_files, sizes.db_frames, sizes.queries, sizes.tmpl_frames,
        sizes.tmpl_frames // 2, seed)
    print(f"  features generated on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prep_timing(layout["entries"], card)
    tmpl = layout["tmpls"][0]
    pin, pout, lo, hi = layout["pairs"][0]
    rng = np.random.default_rng(seed + 1)
    for mode in (True, "bf16"):
        name = "complex64" if mode is True else "bf16"
        t0 = time.perf_counter()
        db = FeatureDatabase(layout["entries"], norm=None,
                             cache_spectra=mode)
        t_stage = time.perf_counter() - t0

        report = canary.check_planted(db, layout)
        for fam, worst in sorted(report["families"].items()):
            check(f"[{name}] planted {fam} |sim-1|", worst,
                  report["tols"][fam])
        check_same(f"[{name}] planted frames and punch lengths",
                   report["frames_ok"])

        res = db.query(tmpl, k=2)
        rescore_sample(db, res, tmpl, name, sizes.rescored,
                       layout["planted"][0][0], rng)

        # determinism: the host selection replay dedups by exact sim, so a
        # repeated query must return the same bits
        check_same(f"[{name}] query repeated, bit-identical",
                   _same_result(res, db.query(tmpl, k=2)))
        pb = [db.query_punch_batch(layout["pairs"], k=2) for _ in range(2)]
        check_same(f"[{name}] query_punch_batch repeated, bit-identical",
                   all(_same_result(a, b) for a, b in zip(*pb)))

        lat = []
        for _ in range(sizes.latency_reps):
            t0 = time.perf_counter()
            db.query(tmpl, k=2)
            lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        db.query_punch(pin, pout, min_punch=lo, max_punch=hi, k=2)
        t_punch = time.perf_counter() - t0
        print(f"  [{name}] information, not a claim ({card}): staging "
              f"{t_stage:.2f} s incl. compile; query median "
              f"{np.median(lat) * 1e3:.1f} ms of {len(lat)} "
              f"(min {min(lat) * 1e3:.1f}); query_punch "
              f"{t_punch * 1e3:.1f} ms; peak_bytes_in_use "
              f"{_peak_bytes()}", flush=True)
        del db, res, pb
        gc.collect()


# ---------------------------------------------------------------------------
# phase 5: kernel parity at real widths
# ---------------------------------------------------------------------------

def _novelty_mirror(feats: np.ndarray, t: int, h: int) -> float:
    """The f64 mirror of the novelty sim of the ``2h`` window at ``t``
    (temporal and spectral halves weighted 0.5 each)."""
    from strugatzki_tpu.kernels import mathref as M

    buf = feats[:, t:t + 2 * h]
    return (0.5 * M.correlate_half(1, h, buf, 0, 0)
            + 0.5 * M.correlate_half(feats.shape[0] - 1, h, buf, 0, 1))


def _prepared(db_dir: str, name: str) -> np.ndarray:
    """A catalog file's features, normalized with the database's norms."""
    from strugatzki_tpu.analysis.common import load_norm, normalized
    from strugatzki_tpu.io import audiofile as af

    feats, _ = af.read(os.path.join(db_dir, f"{name}_feat.aif"))
    return normalized(feats, load_norm(db_dir, feats.shape[0] - 1))


def phase_kernels(ctx: dict, sizes: Sizes) -> None:
    """correlation_trace, novelty_trace, gram_similarity_block and the fast
    pair engine vs the float64 mirror, on the extracted catalog features."""
    import jax.numpy as jnp

    from strugatzki_tpu.analysis import self_similarity as SS
    from strugatzki_tpu.analysis.common import full_to_feat
    from strugatzki_tpu.analysis.correlation import InputTemplate
    from strugatzki_tpu.kernels import corr as K
    from strugatzki_tpu.kernels import mathref as M

    print("phase 5: kernel parity vs the f64 mirror", flush=True)
    feats = _prepared(ctx["db"], "a00")
    C, T = feats.shape
    L = min(sizes.tmpl_frames, T // 4)
    o = full_to_feat(int(2 * sizes.punch_secs * SR), STEP)
    tmpl = InputTemplate(feats[:, o:o + L].copy())
    xs, sh_t, _ = K.shift_per_group(feats)
    sims, _ = K.correlation_trace(
        jnp.asarray(xs), tmpl.device_temporal(), tmpl.device_spectral(),
        jnp.float32(tmpl.temporal_std), jnp.float32(tmpl.spectral_std),
        jnp.float32(tmpl.ln_avg_loudness), jnp.float32(sh_t),
        jnp.float32(0.5), jnp.float32(8.0))
    W = T - L + 1
    sims = np.asarray(sims)[:W]
    ref = np.empty(W, np.float32)
    tc = tmpl.temporal_centered + np.float32(tmpl.temporal_mean)
    sc = tmpl.spectral_centered + np.float32(tmpl.spectral_mean)
    for t in range(W):
        win = feats[:, t:t + L]
        bm_t, bs_t = M.stat(win, 0, L, 0, 1)
        bm_s, bs_s = M.stat(win, 0, L, 1, C - 1)
        c_t = M.correlate(tc, tmpl.temporal_mean, tmpl.temporal_std, L, 1,
                          win, bm_t, bs_t, 0, 0)
        c_s = M.correlate(sc, tmpl.spectral_mean, tmpl.spectral_std, L,
                          C - 1, win, bm_s, bs_s, 0, 1)
        with np.errstate(divide="ignore"):
            boost = np.exp((tmpl.ln_avg_loudness
                            - np.log(np.float64(M.avg(win[0], 0, L)))) / 0.6)
        ref[t] = (0.5 * c_t + 0.5 * c_s) if boost <= 8.0 else 0.0
    check(f"correlation_trace (C={C}, T={T}, L={L}, {W} windows)",
          max_dev(sims, ref), 1e-5)

    h = full_to_feat(int(SR), STEP)             # corrLen 1 s (config 3)
    nov = np.asarray(K.novelty_trace(jnp.asarray(xs), h, jnp.float32(0.5)))
    W_n = T - 2 * h + 1
    ref_n = np.array([_novelty_mirror(feats, t, h) for t in range(W_n)],
                     np.float32)
    check(f"novelty_trace (half window {h}, {W_n} windows)",
          max_dev(nov[:W_n], ref_n), 1e-5)

    # the 3-min file's gram at the -x default half window (corrLen 1 s)
    mid = _prepared(ctx["rec"], "mid")
    xg, _, _ = K.shift_per_group(mid)
    hw = full_to_feat(int(SR), STEP)
    n, nb, res1, res2 = SS._prep_resident(xg, xg, hw, 1)
    B = SS._BLOCK
    pairs = [(0, 0), (0, nb - 1), (nb // 2, nb - 1), (nb - 1, nb - 1)]
    pairs += [pairs[-1]] * (SS._PAIRS_PER_CALL - len(pairs))
    fast = np.asarray(SS._dispatch_pairs_fast(res1, res2, pairs,
                                              jnp.float32(0.5)))
    w_all, st_all, _ = res1
    wa, wb = w_all[:B], w_all[(nb - 1) * B:nb * B]
    sa = tuple(st_all[i, :B] for i in range(4))
    sb = tuple(st_all[i, (nb - 1) * B:nb * B] for i in range(4))
    block = np.asarray(K.gram_similarity_block(wa, wb, sa, sb,
                                               jnp.float32(0.5)))

    def mirror(i, j):
        return _novelty_mirror(np.concatenate(
            [mid[:, i:i + hw], mid[:, j:j + hw]], axis=1), 0, hw)

    rng = np.random.default_rng(5)
    cells = 4096 if n > 2048 else 256
    worst_fast = worst_block = 0.0
    for p_i, (bi, bj) in enumerate(pairs[:4]):
        ii = rng.integers(0, B, cells)
        jj = rng.integers(0, B, cells)
        keep = (bi * B + ii < n) & (bj * B + jj < n)
        for i, j in zip(ii[keep], jj[keep]):
            r = mirror(bi * B + i, bj * B + j)
            worst_fast = max(worst_fast, max_dev(fast[p_i, i, j], r))
            if (bi, bj) == (0, nb - 1):
                worst_block = max(worst_block, max_dev(block[i, j], r))
    check(f"gram_similarity_block ({B}x{B}, half window {hw}, sampled)",
          worst_block, 1e-5)
    check(f"fast pair engine (extent {n}, 4 block pairs, sampled)",
          worst_fast, 1e-5)
    print(f"  fast engine vs direct block kernel: "
          f"{'bit-equal' if np.array_equal(fast[1], block) else 'max |d| %.3e' % max_dev(fast[1], block)}",
          flush=True)


# ---------------------------------------------------------------------------
# --four: the files-axis mesh over four cards
# ---------------------------------------------------------------------------

def four_path(sizes: Sizes, seed: int, n_dev: int = 4) -> None:
    """Every mesh stage against the same work on one card: extraction,
    the resident database (query, punch, device re-rank), the correlation
    search, the time-sharded traces and the sharded gram and novelty."""
    import jax
    import jax.numpy as jnp

    from strugatzki_tpu.analysis.correlation import correlate_database
    from strugatzki_tpu.analysis.self_similarity import \
        self_similarity_matrix
    from strugatzki_tpu.config import (CorrelationConfig, ExtractionConfig,
                                       Punch)
    from strugatzki_tpu.dsp import frontend as FE
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.kernels import corr as K
    from strugatzki_tpu.parallel import canary
    from strugatzki_tpu.parallel.database import FeatureDatabase
    from strugatzki_tpu.parallel.sweep import (batched_novelty_traces,
                                               make_files_mesh,
                                               sharded_long_file_trace,
                                               sharded_long_novelty_trace)
    from strugatzki_tpu.span import Span

    if len(jax.devices()) < n_dev:
        raise SmokeFailure(f"--four needs {n_dev} devices, JAX sees "
                           f"{len(jax.devices())}")
    mesh = make_files_mesh(jax.devices()[:n_dev])
    rng = np.random.default_rng(seed)
    print(f"mesh: files axis over {n_dev} devices", flush=True)

    audios = [np.round(catalog_signal(rng, sizes.catalog_secs) * 32768)
              .astype(np.int16) for _ in range(sizes.catalog_files)]
    f_mesh = FE.extract_features_batch(audios, SR, mesh=mesh)
    f_one = FE.extract_features_batch(audios, SR)
    check(f"extract_features_batch(mesh=) {f_mesh.shape} vs one device",
          max_dev(f_mesh, f_one), 2e-5)

    layout = canary.planted_layout(
        sizes.db_files, sizes.db_frames, sizes.queries, sizes.tmpl_frames,
        sizes.tmpl_frames // 2, seed)
    tmpl = layout["tmpls"][0]
    pin, pout, lo, hi = layout["pairs"][0]
    t0 = time.perf_counter()
    db_m = FeatureDatabase(layout["entries"], norm=None, mesh=mesh)
    t_m = time.perf_counter() - t0
    t0 = time.perf_counter()
    db_1 = FeatureDatabase(layout["entries"], norm=None)
    t_1 = time.perf_counter() - t0
    print(f"  staging {sizes.db_files} files: mesh {t_m:.2f} s, one device "
          f"{t_1:.2f} s (incl. compile)", flush=True)
    for what, run in (
            ("query", lambda d: d.query(tmpl, k=4)),
            ("query_punch", lambda d: d.query_punch(
                pin, pout, min_punch=lo, max_punch=hi, k=4)),
            ("query_batch", lambda d: d.query_batch(layout["tmpls"], k=2)),
            ("query_punch_batch",
             lambda d: d.query_punch_batch(layout["pairs"], k=2))):
        rm, r1 = run(db_m), run(db_1)
        rm = rm if isinstance(rm, list) else [rm]
        r1 = r1 if isinstance(r1, list) else [r1]
        # a hit may trade rank with a runner-up whose sim differs by less
        # than the two programs' rounding; count such swaps, never hide them
        swaps, tied = 0, True
        for a, b in zip(rm, r1):
            diff = a.frames != b.frames
            if getattr(a, "punch_lens", None) is not None:
                diff |= a.punch_lens != b.punch_lens
            swaps += int(diff.sum())
            tied &= max_dev(a.sims[diff], b.sims[diff]) <= 2e-5
        check_same(f"FeatureDatabase(mesh=) {what}: files and frames",
                   all(a.files == b.files for a, b in zip(rm, r1))
                   and tied, f"({swaps} rank swaps within 2e-5)"
                   if swaps else "")
        check(f"FeatureDatabase(mesh=) {what}: sims vs one device",
              max(max_dev(a.sims, b.sims) for a, b in zip(rm, r1)), 2e-5)
    live = np.asarray([i for i, f in enumerate(db_m.files)
                       if f is not None], np.int32)
    fi = rng.choice(live, min(4096, len(live)), replace=False).astype(
        np.int32)
    fr = rng.integers(0, sizes.db_frames - sizes.tmpl_frames,
                      len(fi)).astype(np.int32)
    dev_m = db_m._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    dev_1 = db_1._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    host = db_1._exact_window_scores(fi, fr, tmpl, 0.5, 8.0)
    check(f"device re-rank (mesh) vs one device, {len(fi)} windows",
          max_dev(dev_m[0], dev_1[0]), 2e-5)
    check("device re-rank (mesh) vs f64 mirror", max_dev(dev_m[0], host[0]),
          2e-5)
    del db_m, db_1
    gc.collect()

    # correlation search over a slice of the catalog; the template file
    # itself is in the database, so its own punch is the planted match
    n_search = min(256, sizes.db_files)
    src_f, o_in = layout["planted"][0]
    src = layout["entries"][src_f][1]
    L_in, L_out = pin.num_frames, pout.num_frames
    o_out = o_in + layout["d_punch"]
    with tempfile.TemporaryDirectory() as td:
        feat_path = os.path.join(td, "in_feat.aif")
        af.write(feat_path, src, af.feature_spec(14, SR / STEP))
        meta = ExtractionConfig(audio_input=os.path.join(td, "in.aif"),
                                feature_output=feat_path, num_coeffs=13,
                                fft_size=1024, fft_overlap=2)
        entries = [(ExtractionConfig(audio_input=n, feature_output=n),
                    (lambda f_=f: f_))
                   for n, f in layout["entries"][:n_search]]
        ccfg = CorrelationConfig(
            database_folder=td, meta_input=feat_path,
            punch_in=Punch(Span(o_in * STEP, (o_in + L_in) * STEP), 0.5),
            punch_out=Punch(Span(o_out * STEP, (o_out + L_out) * STEP), 0.5),
            min_punch=lo * STEP, max_punch=hi * STEP,
            num_matches=5, normalize=False).build()
        m_1 = correlate_database(meta, entries, None, ccfg, skip_nan=True)
        m_m = correlate_database(meta, entries, None, ccfg, skip_nan=True,
                                 mesh=mesh)
    check_same(f"correlate_database(mesh=) over {n_search} files: "
               f"(file, punch)",
               [(m.file, m.punch) for m in m_m]
               == [(m.file, m.punch) for m in m_1]
               and bool(m_1) and m_1[0].file == f"f{src_f}.aif")
    check("correlate_database(mesh=) sims vs one device",
          max_dev([m.sim for m in m_m], [m.sim for m in m_1]), 2e-5)

    # time-sharded traces of one long recording (20 minutes at full size)
    long_t = int(4 * sizes.long_secs * SR / STEP)
    long_x = np.abs(0.5 + 0.1 * rng.standard_normal(
        (14, long_t), dtype=np.float32))
    plant = long_t // 3
    long_x[:, plant:plant + L_in] = src[:, o_in:o_in + L_in]
    xs_long, sh_long, _ = K.shift_per_group(long_x)
    s_m, _ = sharded_long_file_trace(xs_long, sh_long, pin, 0.5, 8.0, mesh)
    s_1, _ = K.correlation_trace(
        jnp.asarray(xs_long), pin.device_temporal(), pin.device_spectral(),
        jnp.float32(pin.temporal_std), jnp.float32(pin.spectral_std),
        jnp.float32(pin.ln_avg_loudness), jnp.float32(sh_long),
        jnp.float32(0.5), jnp.float32(8.0))
    check_same(f"sharded_long_file_trace ({long_t} frames): planted peak",
               int(np.argmax(s_m)) == plant)
    check("sharded_long_file_trace vs one device",
          max_dev(s_m, np.asarray(s_1)[:len(s_m)]), 2e-5)
    h = 43
    n_m = sharded_long_novelty_trace(xs_long, h, 0.5, mesh)
    n_1 = np.asarray(K.novelty_trace(jnp.asarray(xs_long), h,
                                     jnp.float32(0.5)))
    check("sharded_long_novelty_trace vs one device", max_dev(n_m, n_1),
          2e-5)

    nov_b = np.stack([K.shift_per_group(f)[0]
                      for _, f in layout["entries"][:64]])
    b_m = batched_novelty_traces(nov_b, h, 0.5, mesh=mesh)
    b_1 = batched_novelty_traces(nov_b, h, 0.5)
    check(f"batched_novelty_traces(mesh=) {b_m.shape} vs one device",
          max_dev(b_m, b_1), 2e-5)

    mid_t = int(sizes.mid_secs * SR / STEP)
    xg = K.shift_per_group(long_x[:, :mid_t])[0]
    g_m = self_similarity_matrix(xg, xg, half_win=86, decim=2,
                                 temp_weight=0.5, mesh=mesh)
    g_1 = self_similarity_matrix(xg, xg, half_win=86, decim=2,
                                 temp_weight=0.5)
    check(f"self_similarity_matrix(mesh=) {g_m.shape} vs one device",
          max_dev(g_m, g_1), 2e-5)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def result_line(devs) -> str:
    """The last line of a passing run: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the files-axis mesh over four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    ns = ap.parse_args(argv)

    import jax

    from strugatzki_tpu.runtime.platform import (card_line,
                                                 compile_cache_dir,
                                                 require_gpu)

    devs = require_gpu()
    from strugatzki_tpu.io import native

    card = card_line()
    print(f"device: {devs[0].device_kind} x {len(devs)} "
          f"({devs[0].platform})")
    print(f"nvidia-smi: {card}")
    print(f"jax {jax.__version__}; compile cache {compile_cache_dir()}")
    print(f"native codec loaded: {native.lib() is not None}", flush=True)

    t0 = time.perf_counter()
    if ns.four:
        four_path(FULL, ns.seed)
    else:
        with tempfile.TemporaryDirectory() as work:
            ctx = phase_extraction(work, FULL, ns.seed)
            phase_search(ctx, FULL)
            phase_similarity(ctx, FULL)
            phase_kernels(ctx, FULL)
        phase_serving(FULL, ns.seed, card)
    print(f"all phases passed in {time.perf_counter() - t0:.0f} s "
          f"({card})")
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    # the CPU reference runs in this process: keep the CPU backend
    # available when the platform list is pinned
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.exit(main())
