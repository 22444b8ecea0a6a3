"""Mesh-sharded batch extraction: the public ``extract_features_batch
(mesh=)`` API and the CLI's ``STRUGATZKI_MESH`` opt-in gate.

The sharded program and the single-device program are different compiled
programs (XLA chooses FMA contractions per program), so equality is pinned
to the framework's standing plan-invariance budget (2e-5), not bitwise —
same policy as the sharded gram/novelty paths (tests/test_sharded_gram_
novelty.py)."""

import numpy as np

from strugatzki_tpu.dsp.frontend import extract_features_batch
from strugatzki_tpu.parallel.sweep import make_files_mesh

ATOL = 2e-5


def _batch(rng, n):
    # mixed lengths, none a multiple of the step
    lens = [3000 + 517 * i for i in range(n)]
    return [(0.1 * rng.standard_normal(L)).astype(np.float32) for L in lens]


def test_mesh_batch_matches_unsharded_nondivisible():
    rng = np.random.default_rng(42)
    audios = _batch(rng, 13)          # 13 rows over 8 devices: pad + trim
    base = extract_features_batch(audios, 44100.0, block_frames=256)
    out = extract_features_batch(audios, 44100.0, block_frames=256,
                                 mesh=make_files_mesh())
    assert out.shape == base.shape
    np.testing.assert_allclose(out, base, rtol=0.0, atol=ATOL)


def test_mesh_batch_int16_rows():
    """All-int16 batches keep the int16 upload path under a mesh (the
    silent pad rows must adopt the batch dtype, not flip it to f32)."""
    rng = np.random.default_rng(7)
    audios = [rng.integers(-2000, 2000, 4096 + 777 * i).astype(np.int16)
              for i in range(5)]
    base = extract_features_batch(audios, 44100.0, block_frames=256)
    out = extract_features_batch(audios, 44100.0, block_frames=256,
                                 mesh=make_files_mesh())
    assert out.shape == base.shape
    np.testing.assert_allclose(out, base, rtol=0.0, atol=ATOL)


def test_mesh_as_device_keeps_padded_rows_and_real_totals():
    rng = np.random.default_rng(3)
    audios = _batch(rng, 3)
    feats, totals = extract_features_batch(
        audios, 44100.0, block_frames=256, as_device=True,
        mesh=make_files_mesh())
    assert feats.shape[0] == 8, feats.shape   # padded to the device count
    assert len(totals) == 3                   # one per REAL file


def test_correlate_database_mesh_matches(monkeypatch):
    """correlate_database(mesh=) shards each chunk's prep + trace dispatch;
    the host replay must select the same matches (sims within the plan
    budget) as the single-device path — punch-in only and punch-in×out."""
    from strugatzki_tpu.analysis import correlation as corr_mod
    from strugatzki_tpu.config import (CorrelationConfig, ExtractionConfig,
                                       Punch)
    from strugatzki_tpu.span import Span

    STEP = 512
    rng = np.random.default_rng(11)
    C, T = 14, 400
    files = []
    for i in range(10):    # chunk of 10 over 8 devices: padded rows live
        base = rng.uniform(0.3, 0.7, size=(C, 1))
        x = np.abs(base + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
        files.append((f"db{i}.aif", x))
    inp = np.abs(0.5 + 0.1 * rng.standard_normal((C, 200))).astype(np.float32)
    files[3][1][:, 120:160] = inp[:, 20:60]    # planted punch-in
    files[3][1][:, 200:230] = inp[:, 100:130]  # planted punch-out

    meta = ExtractionConfig(audio_input="in.aif", feature_output="mem",
                            num_coeffs=13, fft_size=1024, fft_overlap=2)
    entries = [(ExtractionConfig(audio_input=n, feature_output=n),
                (lambda f_=f: f_)) for n, f in files]
    monkeypatch.setattr(corr_mod, "read_features", lambda m: inp)

    for punch_out in (None, Punch(Span(100 * STEP, 130 * STEP), 0.5)):
        cfg = CorrelationConfig(
            database_folder="db", meta_input="in_feat.xml",
            punch_in=Punch(Span(20 * STEP, 60 * STEP), 0.5),
            punch_out=punch_out, min_punch=30 * STEP, max_punch=120 * STEP,
            num_matches=4, num_per_file=2, normalize=False).build()
        base = corr_mod.correlate_database(meta, entries, None, cfg)
        sharded = corr_mod.correlate_database(meta, entries, None, cfg,
                                              mesh=make_files_mesh())
        assert [(m.file, m.punch) for m in sharded] == \
            [(m.file, m.punch) for m in base]
        for a, b in zip(sharded, base):
            if np.isnan(b.sim):   # the reference's own √(neg·product) NaN
                assert np.isnan(a.sim), (a, b)
            else:
                assert abs(a.sim - b.sim) < 3e-5, (a, b)
        if punch_out is None:
            assert base and base[0].file == "db3.aif"
        # (with punch-out the faithful replay lets a NaN √(neg·product)
        # rank first — reference Float.compare order; both paths agree)


def test_mesh_vs_single_fuzz():
    """Randomized differential soak over the round-4 mesh paths: batch
    extraction, the time-sharded novelty curve, and the sharded
    correlation-search chunk — each at random shapes vs its single-device
    program, plan budget.  STRUG_FUZZ_SEEDS=N scales it; STRUG_FUZZ_BASE
    shifts the window (tests/conftest.py)."""
    import jax.numpy as jnp

    from conftest import FUZZ_BASE, FUZZ_SEEDS, soak_hygiene
    from strugatzki_tpu.analysis import correlation as corr_mod
    from strugatzki_tpu.config import (CorrelationConfig, ExtractionConfig,
                                       Punch)
    from strugatzki_tpu.kernels import corr as K
    from strugatzki_tpu.parallel.sweep import sharded_long_novelty_trace
    from strugatzki_tpu.span import Span

    mesh = make_files_mesh()
    for seed in range(FUZZ_BASE, FUZZ_BASE + (FUZZ_SEEDS or 3)):
        soak_hygiene(seed)
        rng = np.random.default_rng(seed)

        # --- batch extraction ------------------------------------------
        n = int(rng.integers(1, 14))
        audios = [(0.2 * rng.standard_normal(int(rng.integers(600, 9000))))
                  .astype(np.float32) for _ in range(n)]
        base = extract_features_batch(audios, 44100.0, block_frames=256)
        out = extract_features_batch(audios, 44100.0, block_frames=256,
                                     mesh=mesh)
        np.testing.assert_allclose(out, base, rtol=0.0, atol=ATOL,
                                   err_msg=f"extraction seed {seed}")

        # --- time-sharded novelty --------------------------------------
        C = int(rng.integers(2, 15))
        h = int(rng.integers(2, 60))
        T = 2 * h + int(rng.integers(1, 900))
        x = np.abs(0.5 + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
        xs, _, _ = K.shift_per_group(x)
        single = np.asarray(K.novelty_trace(jnp.asarray(xs), h,
                                            jnp.float32(0.5)))
        sharded = sharded_long_novelty_trace(xs, h, 0.5, mesh)
        np.testing.assert_allclose(sharded, single, rtol=0.0, atol=3e-5,
                                   err_msg=f"novelty seed {seed}")

        # --- sharded correlation-search chunk --------------------------
        STEP = 512
        nf = int(rng.integers(2, 12))
        Tf = int(rng.integers(120, 400))
        L = int(rng.integers(8, min(60, Tf // 2)))
        files = []
        for i in range(nf):
            b0 = rng.uniform(0.3, 0.7, size=(C, 1))
            files.append((f"db{i}.aif", np.abs(
                b0 + 0.1 * rng.standard_normal((C, Tf))).astype(np.float32)))
        inp = np.abs(0.5 + 0.1 * rng.standard_normal((C, 3 * L))) \
            .astype(np.float32)
        pos = int(rng.integers(0, Tf - L))
        files[int(rng.integers(0, nf))][1][:, pos:pos + L] = inp[:, L:2 * L]
        meta = ExtractionConfig(audio_input="in.aif", feature_output="mem",
                                num_coeffs=C - 1, fft_size=1024,
                                fft_overlap=2)
        entries = [(ExtractionConfig(audio_input=nm, feature_output=nm),
                    (lambda f_=f: f_)) for nm, f in files]
        cfg = CorrelationConfig(
            database_folder="db", meta_input="in_feat.xml",
            punch_in=Punch(Span(L * STEP, 2 * L * STEP), 0.5),
            num_matches=3, num_per_file=2, normalize=False).build()
        orig = corr_mod.read_features
        corr_mod.read_features = lambda m: inp
        try:
            base_m = corr_mod.correlate_database(meta, entries, None, cfg)
            shard_m = corr_mod.correlate_database(meta, entries, None, cfg,
                                                  mesh=mesh)
        finally:
            corr_mod.read_features = orig
        assert [(m.file, m.punch) for m in shard_m] == \
            [(m.file, m.punch) for m in base_m], f"correlation seed {seed}"
        for a, b in zip(shard_m, base_m):
            if np.isnan(b.sim):
                assert np.isnan(a.sim), (seed, a, b)
            else:
                assert abs(a.sim - b.sim) < 3e-5, (seed, a, b)


def test_cli_env_gate_selfsim_cross(tmp_path, monkeypatch):
    """STRUGATZKI_MESH=1 routes -x through the mesh gram engine and -y
    through the time-sharded trace (classvar wiring; numeric equality of
    the sharded engines is pinned in test_sharded_gram_novelty /
    test_long_file_sharding)."""
    from strugatzki_tpu import cli
    from strugatzki_tpu.analysis.cross_similarity import CrossSimilarity
    from strugatzki_tpu.analysis.extraction import extract_batch_cli
    from strugatzki_tpu.analysis.self_similarity import SelfSimilarity
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.io.audiofile import AudioFileSpec, SampleFormat
    from strugatzki_tpu.io.formats import AIFF

    rng = np.random.default_rng(5)
    paths = []
    for name in ("xa", "xb"):
        x = (0.2 * rng.standard_normal(24000)).astype(np.float32)
        p = tmp_path / f"{name}.aif"
        af.write(p, x[None],
                 AudioFileSpec(AIFF, SampleFormat.INT16, 1, 44100.0))
        paths.append(str(p))
    db = tmp_path / "db"
    db.mkdir()
    assert extract_batch_cli(paths, str(db), 0) == 0

    from strugatzki_tpu.analysis.segmentation import FeatureSegmentation
    monkeypatch.setattr(SelfSimilarity, "mesh", None)
    monkeypatch.setattr(CrossSimilarity, "mesh", None)
    monkeypatch.setattr(FeatureSegmentation, "mesh", None)
    monkeypatch.setenv("STRUGATZKI_MESH", "1")
    assert cli.feature_segm(["--no-norm", "--length", "0.05", "-m", "2",
                             str(db / "xa_feat.xml")]) == 0
    assert FeatureSegmentation.mesh is not None
    png = tmp_path / "xa.png"
    assert cli.feature_self(["--no-norm", "--length", "0.05",
                             str(db / "xa_feat.xml"), str(png)]) == 0
    assert SelfSimilarity.mesh is not None     # the gate engaged
    assert png.stat().st_size > 0
    out_aif = tmp_path / "xab.aif"
    assert cli.feature_cross(["--no-norm", str(db / "xa_feat.xml"),
                              str(db / "xb_feat.xml"), str(out_aif)]) == 0
    assert CrossSimilarity.mesh is not None
    assert out_aif.stat().st_size > 0


def test_cli_env_gate(tmp_path, monkeypatch):
    """STRUGATZKI_MESH=1 shards the CLI -f grouped dispatch; the written
    feature files must match the unsharded run within the plan budget."""
    from strugatzki_tpu.analysis.extraction import extract_batch_cli
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.io.audiofile import AudioFileSpec, SampleFormat
    from strugatzki_tpu.io.formats import AIFF

    snd = tmp_path / "snd"
    snd.mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        x = (0.2 * rng.standard_normal(20000 + 3000 * i)).astype(np.float32)
        p = snd / f"s{i}.aif"
        af.write(p, x[None],
                 AudioFileSpec(AIFF, SampleFormat.INT16, 1, 44100.0))
        paths.append(str(p))
    db0 = tmp_path / "db0"
    db0.mkdir()
    db1 = tmp_path / "db1"
    db1.mkdir()
    monkeypatch.delenv("STRUGATZKI_MESH", raising=False)
    assert extract_batch_cli(paths, str(db0), 0) == 0
    monkeypatch.setenv("STRUGATZKI_MESH", "1")
    assert extract_batch_cli(paths, str(db1), 0) == 0
    for i in range(3):
        a, _ = af.read(db0 / f"s{i}_feat.aif")
        b, _ = af.read(db1 / f"s{i}_feat.aif")
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0.0, atol=ATOL)


def test_env_mesh_off_spellings(monkeypatch):
    """Conventional 'off' values must DISABLE the gate — a user exporting
    STRUGATZKI_MESH=0 asked for the single-device programs (review fix:
    any non-empty string used to enable)."""
    from strugatzki_tpu.parallel.sweep import env_mesh

    for off in ("", "0", "false", "False", "no", "off", "  0  "):
        monkeypatch.setenv("STRUGATZKI_MESH", off)
        assert env_mesh() is None, repr(off)
    monkeypatch.delenv("STRUGATZKI_MESH")
    assert env_mesh() is None
    for on in ("1", "true", "2", "yes"):
        monkeypatch.setenv("STRUGATZKI_MESH", on)
        assert env_mesh() is not None, repr(on)


def test_cli_env_gate_clears(tmp_path, monkeypatch):
    """The CLI mesh gate is authoritative per invocation: a run WITHOUT
    STRUGATZKI_MESH clears a previous run's classvar instead of silently
    keeping the process sharded (review fix: the gate only ever set)."""
    from strugatzki_tpu import cli
    from strugatzki_tpu.analysis.extraction import extract_batch_cli
    from strugatzki_tpu.analysis.segmentation import FeatureSegmentation
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.io.audiofile import AudioFileSpec, SampleFormat
    from strugatzki_tpu.io.formats import AIFF

    rng = np.random.default_rng(7)
    x = (0.2 * rng.standard_normal(24000)).astype(np.float32)
    p = tmp_path / "g.aif"
    af.write(p, x[None], AudioFileSpec(AIFF, SampleFormat.INT16, 1, 44100.0))
    db = tmp_path / "db"
    db.mkdir()
    assert extract_batch_cli([str(p)], str(db), 0) == 0

    monkeypatch.setattr(FeatureSegmentation, "mesh", None)
    args = ["--no-norm", "--length", "0.05", "-m", "2",
            str(db / "g_feat.xml")]
    monkeypatch.setenv("STRUGATZKI_MESH", "1")
    assert cli.feature_segm(args) == 0
    assert FeatureSegmentation.mesh is not None
    monkeypatch.delenv("STRUGATZKI_MESH")
    assert cli.feature_segm(args) == 0
    assert FeatureSegmentation.mesh is None


def test_sharded_long_traces_bucket_jit_keys():
    """The time-sharded trace slabs are bucketed: nearby input lengths
    must reuse one compiled program (every fresh jit key is a compile),
    and values still match the
    single-device trace within the plan budget."""
    import jax.numpy as jnp

    from strugatzki_tpu.analysis.correlation import InputTemplate
    from strugatzki_tpu.kernels import corr as K
    from strugatzki_tpu.parallel import sweep as SW

    mesh = make_files_mesh()
    rng = np.random.default_rng(3)
    C, h = 6, 9

    def novelty_single(xs):
        return np.asarray(K.novelty_trace(jnp.asarray(xs), h,
                                          jnp.float32(0.5)))

    sizes_before = SW._batched_novelty._cache_size()
    outs = []
    for T in (700, 740, 780):   # same per-shard bucket
        x = np.abs(0.5 + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
        xs, _, _ = K.shift_per_group(x)
        sp = SW.sharded_long_novelty_trace(xs, h, 0.5, mesh)
        np.testing.assert_allclose(sp, novelty_single(xs)[:T - 2 * h + 1],
                                   rtol=0.0, atol=ATOL)
        outs.append(sp)
    assert SW._batched_novelty._cache_size() - sizes_before <= 1, \
        "nearby lengths must share one bucketed jit key"

    # the correlation-trace analog: same bucket → at most one new key
    tmpl = InputTemplate(np.abs(
        0.5 + 0.1 * rng.standard_normal((C, 16))).astype(np.float32))
    before = SW._batched_traces._cache_size()
    for T in (700, 760):
        x = np.abs(0.5 + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
        xs, sh_t, _ = K.shift_per_group(x)
        sims, _ = SW.sharded_long_file_trace(xs, sh_t, tmpl, 0.5, 8.0, mesh)
        assert sims.shape == (T - 16 + 1,)
    assert SW._batched_traces._cache_size() - before <= 1
