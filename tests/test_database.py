"""Device-resident FeatureDatabase serving tests."""

import numpy as np
import pytest

from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel.database import FeatureDatabase
from strugatzki_tpu.parallel.sweep import make_files_mesh


@pytest.fixture(scope="module")
def db_entries():
    rng = np.random.default_rng(0)
    entries = []
    for i in range(12):
        feats = np.abs(0.5 + 0.1 * rng.standard_normal((14, 150 + 13 * i)))
        entries.append((f"file{i}.aif", feats.astype(np.float32)))
    return entries


def test_query_finds_planted(db_entries):
    entries = [(n, f.copy()) for n, f in db_entries]
    tmpl_block = entries[5][1][:, 40:90].copy()
    db = FeatureDatabase(entries, norm=None, pad_multiple=64)
    res = db.query(InputTemplate(tmpl_block), k=3)
    assert res.sims.shape == (12, 3)
    assert res.frames[5, 0] == 40
    assert abs(res.sims[5, 0] - 1.0) < 1e-3
    matches = res.matches(punch_len=50, step_size=512, k_total=5)
    assert matches[0].file == "file5.aif"
    assert matches[0].punch.start == 40 * 512


def test_query_masks_padding(db_entries):
    db = FeatureDatabase(db_entries, norm=None, pad_multiple=256)
    tmpl = InputTemplate(db_entries[0][1][:, :30].copy())
    res = db.query(tmpl, k=4)
    # every reported frame index must be a valid window start for its file
    for i, (_, feats) in enumerate(db_entries):
        w = feats.shape[1] - 30 + 1
        valid = res.frames[i][np.isfinite(res.sims[i])]
        assert (valid < w).all()


def test_sharded_database_matches_single(db_entries):
    tmpl = InputTemplate(db_entries[3][1][:, 10:60].copy())
    db1 = FeatureDatabase(db_entries[:8], norm=None, pad_multiple=64)
    mesh = make_files_mesh()
    db2 = FeatureDatabase(db_entries[:8], norm=None, pad_multiple=64,
                          mesh=mesh)
    r1 = db1.query(tmpl, k=2)
    r2 = db2.query(tmpl, k=2)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-5)
    np.testing.assert_array_equal(r1.frames, r2.frames)


def test_traces_match_per_file_path(db_entries):
    """Dense traces from the resident DB equal the per-file trace path used
    by the exact FeatureCorrelation replay."""
    import jax.numpy as jnp
    from strugatzki_tpu.kernels import corr as K

    tmpl = InputTemplate(db_entries[2][1][:, 20:70].copy())
    db = FeatureDatabase(db_entries[:4], norm=None, pad_multiple=64)
    _, (sims_b, boosts_b, lens) = db.query(tmpl, with_traces=True)
    for i in range(4):
        feats = db_entries[i][1]
        xs, sh, _ = K.shift_per_group(
            feats.astype(np.float32))
        sims, boosts = K.correlation_trace(
            jnp.asarray(xs), tmpl.device_temporal(), tmpl.device_spectral(),
            jnp.float32(tmpl.temporal_std), jnp.float32(tmpl.spectral_std),
            jnp.float32(tmpl.ln_avg_loudness), jnp.float32(sh),
            jnp.float32(0.5), jnp.float32(8.0))
        w = feats.shape[1] - 50 + 1
        np.testing.assert_allclose(sims_b[i, :w], np.asarray(sims)[:w],
                                   atol=3e-5)


def test_save_load_roundtrip(tmp_path, db_entries):
    tmpl = InputTemplate(db_entries[2][1][:, 20:70].copy())
    db = FeatureDatabase(db_entries[:6], norm=None, pad_multiple=64)
    r1 = db.query(tmpl, k=2)
    p = tmp_path / "db.npz"
    db.save(p)
    db2 = FeatureDatabase.load(p)
    assert db2.files == db.files
    assert db2.step_size == db.step_size
    r2 = db2.query(tmpl, k=2)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-6)
    np.testing.assert_array_equal(r1.frames, r2.frames)


def test_query_batch_matches_single(db_entries):
    tmpls = [InputTemplate(db_entries[i][1][:, 10 + 7 * i:60 + 7 * i].copy())
             for i in (0, 2, 4)]
    db = FeatureDatabase(db_entries[:8], norm=None, pad_multiple=64)
    batch = db.query_batch(tmpls, k=3)
    assert len(batch) == 3
    for q, tmpl in enumerate(tmpls):
        single = db.query(tmpl, k=3)
        np.testing.assert_allclose(batch[q].sims, single.sims, atol=1e-6)
        np.testing.assert_array_equal(batch[q].frames, single.frames)
    # each planted template finds itself in its own file
    for q, i in enumerate((0, 2, 4)):
        assert batch[q].frames[i, 0] == 10 + 7 * i
        assert abs(batch[q].sims[i, 0] - 1.0) < 1e-3


def test_query_batch_buckets_mixed_lengths(db_entries):
    db = FeatureDatabase(db_entries[:4], norm=None, pad_multiple=64)
    t1 = InputTemplate(db_entries[0][1][:, :40].copy())
    t2 = InputTemplate(db_entries[0][1][:, :50].copy())
    rs = db.query_batch([t1, t2], k=2)
    assert len(rs) == 2
    assert rs[0].frames[0, 0] == 0 and rs[1].frames[0, 0] == 0


def test_bfloat16_storage_mode(db_entries):
    import jax.numpy as jnp
    tmpl = InputTemplate(db_entries[5][1][:, 40:90].copy())
    db32 = FeatureDatabase(db_entries, norm=None, pad_multiple=64)
    db16 = FeatureDatabase(db_entries, norm=None, pad_multiple=64,
                           storage_dtype=jnp.bfloat16)
    r32 = db32.query(tmpl, k=2)
    # raw bf16 sims (re-rank off): half the HBM, top hits preserved, ~1e-2
    r16_raw = db16.query(tmpl, k=2, exact_rerank=False)
    assert r16_raw.frames[5, 0] == r32.frames[5, 0] == 40
    np.testing.assert_allclose(r16_raw.sims, r32.sims, atol=2e-2)
    # automatic exact re-rank (default for bf16): values exact again
    r16 = db16.query(tmpl, k=2)
    assert r16.frames[5, 0] == 40
    np.testing.assert_allclose(r16.sims[5], r32.sims[5], atol=3e-5)
    assert abs(r16.sims[5, 0] - 1.0) < 3e-5
    np.testing.assert_allclose(r16.boosts[5, 0], 1.0, atol=1e-3)


def test_from_folder(tmp_path, db_entries):
    from strugatzki_tpu.io import audiofile as af
    from strugatzki_tpu.config import ExtractionConfig, NORMALIZE_NAME
    for i, (name, feats) in enumerate(db_entries[:4]):
        fp = tmp_path / f"e{i}_feat.aif"
        af.write(fp, feats, af.feature_spec(14, 44100 / 512))
        ExtractionConfig(audio_input=f"/snd/{name}", feature_output=str(fp)
                         ).save_xml(tmp_path / f"e{i}_feat.xml")
    # norm file
    allf = np.concatenate([f for _, f in db_entries[:4]], axis=1)
    norm = np.stack([allf.min(axis=1) - 1e-3, allf.max(axis=1) + 1e-3], axis=1)
    af.write(tmp_path / NORMALIZE_NAME, norm.astype(np.float32),
             af.AudioFileSpec(num_channels=14, sample_rate=44100.0))
    db = FeatureDatabase.from_folder(str(tmp_path))
    assert db.num_files == 4
    assert db.files == [f"/snd/{db_entries[i][0]}" for i in range(4)]
    tmpl_block = db_entries[1][1][:, 20:60].astype(np.float32).copy()
    from strugatzki_tpu.kernels import mathref as M
    M.normalize(norm.astype(np.float32), tmpl_block, 0, 40)
    res = db.query(InputTemplate(tmpl_block), k=1)
    assert res.frames[1, 0] == 20
    assert abs(res.sims[1, 0] - 1.0) < 1e-3


def test_sharded_query_punch_matches_single(db_entries):
    """query_punch runs SPMD over a files mesh unchanged (the kernel's vmap
    shards with the inputs); results must match the single-device path."""
    from strugatzki_tpu.analysis.correlation import InputTemplate as IT

    entries = [(n, f.copy()) for n, f in db_entries[:8]]
    entries[5][1][:, 30:60] = entries[3][1][:, 10:40]
    entries[5][1][:, 110:130] = entries[3][1][:, 100:120]
    t_in = IT(entries[3][1][:, 10:40].copy())
    t_out = IT(entries[3][1][:, 100:120].copy())
    db1 = FeatureDatabase(entries, norm=None, pad_multiple=64)
    db2 = FeatureDatabase(entries, norm=None, pad_multiple=64,
                          mesh=make_files_mesh())
    # punch range excludes file3's own in..out distance (90) so the
    # planted pair in file5 (distance 80) is the unique perfect hit
    r1 = db1.query_punch(t_in, t_out, min_punch=70, max_punch=85, k=2)
    r2 = db2.query_punch(t_in, t_out, min_punch=70, max_punch=85, k=2)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-5)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    np.testing.assert_array_equal(r1.punch_lens, r2.punch_lens)
    m = r2.matches(step_size=512, k_total=1)[0]
    assert m.file == entries[5][0]
    assert m.punch.start == 30 * 512 and m.punch.stop == 110 * 512


def test_cached_spectra_query_matches(db_entries):
    """cache_spectra=True keeps the forward FFTs resident; queries must
    return identical results."""
    tmpl = InputTemplate(db_entries[4][1][:, 15:65].copy())
    db1 = FeatureDatabase(db_entries[:8], norm=None, pad_multiple=64)
    db2 = FeatureDatabase(db_entries[:8], norm=None, pad_multiple=64,
                          cache_spectra=True)
    r1 = db1.query(tmpl, k=3)
    r2 = db2.query(tmpl, k=3)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-5)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    np.testing.assert_allclose(r1.boosts, r2.boosts, rtol=1e-5)


def test_cached_spectra_punch_and_batch_match(db_entries):
    from strugatzki_tpu.analysis.correlation import InputTemplate as IT

    entries = [(n, f.copy()) for n, f in db_entries[:8]]
    entries[5][1][:, 30:60] = entries[3][1][:, 10:40]
    entries[5][1][:, 110:130] = entries[3][1][:, 100:120]
    t_in = IT(entries[3][1][:, 10:40].copy())
    t_out = IT(entries[3][1][:, 100:120].copy())
    db1 = FeatureDatabase(entries, norm=None, pad_multiple=64)
    db2 = FeatureDatabase(entries, norm=None, pad_multiple=64,
                          cache_spectra=True)
    p1 = db1.query_punch(t_in, t_out, min_punch=70, max_punch=85, k=2)
    p2 = db2.query_punch(t_in, t_out, min_punch=70, max_punch=85, k=2)
    np.testing.assert_allclose(p1.sims, p2.sims, atol=1e-5)
    np.testing.assert_array_equal(p1.frames, p2.frames)
    np.testing.assert_array_equal(p1.punch_lens, p2.punch_lens)
    b1 = db1.query_batch([t_in, t_out], k=2)
    b2 = db2.query_batch([t_in, t_out], k=2)
    for r1, r2 in zip(b1, b2):
        np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-5)
        np.testing.assert_array_equal(r1.frames, r2.frames)


def test_chunked_query_dispatch_matches(db_entries, monkeypatch):
    """Databases past _QUERY_CHUNK files pad the staged axis and answer in
    equal chunks (bounded per-dispatch HBM); results must equal the
    single-dispatch path, including punch, batch and traces."""
    from strugatzki_tpu.analysis.correlation import InputTemplate as IT
    from strugatzki_tpu.parallel import database as D

    entries = [(n, f.copy()) for n, f in db_entries]   # 12 files
    entries[5][1][:, 30:60] = entries[3][1][:, 10:40]
    entries[5][1][:, 110:130] = entries[3][1][:, 100:120]
    tmpl = IT(entries[3][1][:, 10:40].copy())
    t_out = IT(entries[3][1][:, 100:120].copy())

    ref_db = D.FeatureDatabase(entries, norm=None, pad_multiple=64)
    r_ref = ref_db.query(tmpl, k=3)
    p_ref = ref_db.query_punch(tmpl, t_out, min_punch=70, max_punch=85, k=2)
    b_ref = ref_db.query_batch([tmpl, t_out], k=2)
    _, (sims_ref, _, lens_ref) = ref_db.query(tmpl, with_traces=True)

    monkeypatch.setattr(D, "_QUERY_CHUNK", 5)          # 12 files → pad to 15
    db = D.FeatureDatabase(entries, norm=None, pad_multiple=64,
                           cache_spectra=True)
    assert db._xs.shape[0] == 15 and db.num_files == 12
    r = db.query(tmpl, k=3)
    assert r.sims.shape == (12, 3)
    np.testing.assert_allclose(r.sims, r_ref.sims, atol=1e-5)
    np.testing.assert_array_equal(r.frames, r_ref.frames)
    p = db.query_punch(tmpl, t_out, min_punch=70, max_punch=85, k=2)
    np.testing.assert_allclose(p.sims, p_ref.sims, atol=1e-5)
    np.testing.assert_array_equal(p.frames, p_ref.frames)
    b = db.query_batch([tmpl, t_out], k=2)
    for r1, r2 in zip(b, b_ref):
        np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-5)
        np.testing.assert_array_equal(r1.frames, r2.frames)
    _, (sims, _, lens) = db.query(tmpl, with_traces=True)
    assert sims.shape[0] == 12 and len(lens) == 12
    np.testing.assert_allclose(sims, sims_ref, atol=1e-5)


def test_bf16_spectra_cache_matches_f32(db_entries, monkeypatch):
    """cache_spectra="bf16" halves the resident spectra (what lets a
    10k-file database keep cached-spectra latency on one chip); with the
    automatic exact re-rank + k-inflation, all three query kinds must
    return the f32 database's frames and exact sims.  Runs chunked too
    (the preallocated donated spectra buffers)."""
    import jax.numpy as jnp
    from strugatzki_tpu.analysis.correlation import InputTemplate as IT
    from strugatzki_tpu.parallel import database as D

    entries = [(n, f.copy()) for n, f in db_entries]   # 12 files
    entries[5][1][:, 30:60] = entries[3][1][:, 10:40]
    entries[5][1][:, 110:130] = entries[3][1][:, 100:120]
    tmpl = IT(entries[3][1][:, 10:40].copy())
    t_out = IT(entries[3][1][:, 100:120].copy())

    ref_db = D.FeatureDatabase(entries, norm=None, pad_multiple=64)
    r_ref = ref_db.query(tmpl, k=3, exact_rerank=True)
    p_ref = ref_db.query_punch(tmpl, t_out, min_punch=70, max_punch=85,
                               k=2, exact_rerank=True)
    b_ref = ref_db.query_batch([tmpl, t_out], k=2, exact_rerank=True)

    monkeypatch.setattr(D, "_QUERY_CHUNK", 5)
    db = D.FeatureDatabase(entries, norm=None, pad_multiple=64,
                           storage_dtype=jnp.bfloat16, cache_spectra="bf16")
    assert db._spectra_reduced
    assert len(db._spectra) == 2        # planar (re, im); sums on the fly
    assert db._spectra[0].dtype == jnp.bfloat16
    assert db._spectra[1].dtype == jnp.bfloat16
    assert db._spectra[0].shape == db._spectra[1].shape

    r = db.query(tmpl, k=3)
    np.testing.assert_array_equal(r.frames, r_ref.frames)
    np.testing.assert_allclose(r.sims, r_ref.sims, atol=2e-5)
    p = db.query_punch(tmpl, t_out, min_punch=70, max_punch=85, k=2)
    # punch candidates at near-ties (≲1e-4 exact-sim gaps between different
    # offsets) may resolve differently under reduced spectra (documented
    # j-choice caveat, _rerank_exact_punch docstring): top-1 must agree
    # exactly, every returned sim within tolerance of the f32 ranking
    np.testing.assert_array_equal(p.frames[:, 0], p_ref.frames[:, 0])
    np.testing.assert_allclose(p.sims, p_ref.sims, atol=1e-4)
    np.testing.assert_allclose(p.boosts_in[:, 0], p_ref.boosts_in[:, 0],
                               atol=1e-4)
    np.testing.assert_allclose(p.boosts_out[:, 0], p_ref.boosts_out[:, 0],
                               atol=1e-4)
    for r1, r2 in zip(db.query_batch([tmpl, t_out], k=2), b_ref):
        np.testing.assert_array_equal(r1.frames, r2.frames)
        np.testing.assert_allclose(r1.sims, r2.sims, atol=2e-5)


def test_punch_rerank_for_bf16_storage(db_entries):
    """query_punch on a reduced-precision database re-scores candidates
    exactly on host (new in round 3 — punch previously returned raw
    device sims for bf16 databases)."""
    import jax.numpy as jnp
    from strugatzki_tpu.analysis.correlation import InputTemplate as IT

    entries = [(n, f.copy()) for n, f in db_entries[:8]]
    entries[5][1][:, 30:60] = entries[3][1][:, 10:40]
    entries[5][1][:, 110:130] = entries[3][1][:, 100:120]
    tmpl = IT(entries[3][1][:, 10:40].copy())
    t_out = IT(entries[3][1][:, 100:120].copy())
    db32 = FeatureDatabase(entries, norm=None, pad_multiple=64)
    db16 = FeatureDatabase(entries, norm=None, pad_multiple=64,
                           storage_dtype=jnp.bfloat16)
    p32 = db32.query_punch(tmpl, t_out, min_punch=70, max_punch=85, k=2,
                           exact_rerank=True)
    p16 = db16.query_punch(tmpl, t_out, min_punch=70, max_punch=85, k=2)
    np.testing.assert_array_equal(p16.frames, p32.frames)
    np.testing.assert_allclose(p16.sims, p32.sims, atol=2e-5)
    np.testing.assert_allclose(p16.in_sims, p32.in_sims, atol=2e-5)


def test_device_rerank_matches_host_oracle(db_entries):
    """The device re-rank kernel must reproduce the host f64 mirror's
    window scores to ≤1e-5 (the parity budget) on every candidate — with
    and without a normalization matrix — and the compact serving mode
    (f32 features + planar bf16 spectra) must route re-ranks through it."""
    allf = np.concatenate([f for _, f in db_entries], axis=1)
    norm = np.stack([allf.min(axis=1) - 1e-3, allf.max(axis=1) + 1e-3],
                    axis=1).astype(np.float32)
    for nm in (None, norm):
        entries = [(n, f.copy()) for n, f in db_entries]
        tmpl_block = entries[5][1][:, 40:90].astype(np.float32).copy()
        if nm is not None:
            from strugatzki_tpu.kernels import mathref as M
            M.normalize(nm, tmpl_block, 0, 50)
        tmpl = InputTemplate(tmpl_block)
        db = FeatureDatabase(entries, nm, pad_multiple=64,
                             cache_spectra="bf16")  # the compact mode
        assert db._rerank_device and db._spectra_reduced
        assert db._xs.dtype == np.float32           # f32 features resident
        res = db.query(tmpl, k=3)                   # auto re-rank (device)
        assert res.frames[5, 0] == 40
        assert abs(res.sims[5, 0] - 1.0) < 3e-5
        finite = np.argwhere(np.isfinite(res.sims))
        fi = finite[:, 0]
        fr = res.frames[finite[:, 0], finite[:, 1]]
        d_sims, d_boosts = db._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
        h_sims, h_boosts = db._exact_window_scores(fi, fr, tmpl, 0.5, 8.0)
        np.testing.assert_allclose(d_sims, h_sims, atol=1e-5)
        np.testing.assert_allclose(d_boosts, h_boosts, rtol=1e-5)


def test_device_rerank_punch_matches_host(db_entries):
    """query_punch through the device re-rank must match a host-rerank run
    of the same compact database (both windows re-scored per candidate)."""
    entries = [(n, f.copy()) for n, f in db_entries]
    entries[5][1][:, 30:60] = entries[3][1][:, 10:40]
    entries[5][1][:, 110:130] = entries[3][1][:, 100:120]
    t_in = InputTemplate(entries[3][1][:, 10:40].copy())
    t_out = InputTemplate(entries[3][1][:, 100:120].copy())
    dbd = FeatureDatabase(entries, norm=None, pad_multiple=64,
                          cache_spectra="bf16")
    dbh = FeatureDatabase(entries, norm=None, pad_multiple=64,
                          cache_spectra="bf16", rerank_device=False)
    assert dbd._rerank_device and not dbh._rerank_device
    pd = dbd.query_punch(t_in, t_out, min_punch=70, max_punch=85, k=2)
    ph = dbh.query_punch(t_in, t_out, min_punch=70, max_punch=85, k=2)
    np.testing.assert_array_equal(pd.frames[:, 0], ph.frames[:, 0])
    np.testing.assert_allclose(pd.sims, ph.sims, atol=1e-5)
    np.testing.assert_allclose(pd.boosts_in[:, 0], ph.boosts_in[:, 0],
                               rtol=1e-5)
    m = pd.matches(step_size=512, k_total=1)[0]
    assert m.file == entries[5][0]


def test_rerank_device_flag_validation(db_entries):
    """Explicit rerank_device=True on an ineligible configuration (reduced
    features, where a device re-rank would not be exact) must raise; the
    auto default must fall back to the host mirror there."""
    import jax.numpy as jnp
    with pytest.raises(ValueError, match="float32 features"):
        FeatureDatabase(db_entries[:2], norm=None, pad_multiple=64,
                        storage_dtype=jnp.bfloat16, rerank_device=True)
    db = FeatureDatabase(db_entries[:2], norm=None, pad_multiple=64,
                         storage_dtype=jnp.bfloat16)
    assert not db._rerank_device


def test_rerank_gather_is_scan_stacked():
    """Structure pin: the device re-rank's window gather must stay STACKED
    THROUGH lax.scan.  A jax.vmap(dynamic_slice) gather fused into the
    consuming reductions returned silently wrong sims on the former
    accelerator's compiler from 128 windows up, a fault invisible on CPU
    (docs/PARITY.md); the device re-score checks of chip_smoke.py decide
    whether the GPU still needs the guard.  This pins the jaxpr so a
    refactor back to the vmap form is a decision, not an accident."""
    import jax
    import jax.numpy as jnp

    from strugatzki_tpu.parallel import database as DBM

    xs = jnp.zeros((4, 6, 64), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda fi, fr, tt, ts: DBM._rerank_window_math(
            xs, jnp.zeros((4,), jnp.float32), fi, fr, tt, ts,
            jnp.float32(1.0), jnp.float32(1.0), jnp.float32(0.0),
            jnp.float32(0.5), jnp.float32(8.0)))(
        jnp.zeros((8,), jnp.int32), jnp.zeros((8,), jnp.int32),
        jnp.zeros((1, 16), jnp.float32), jnp.zeros((5, 16), jnp.float32))
    assert "scan" in str(jaxpr), "re-rank gather no longer scan-stacked"


def test_sharded_query_punch_batch_matches_single(db_entries):
    """query_punch_batch runs SPMD over a files mesh unchanged; results
    must match the single-device batch."""
    entries = [(n, f.copy()) for n, f in db_entries[:8]]
    entries[5][1][:, 30:60] = entries[3][1][:, 10:40]
    entries[5][1][:, 110:130] = entries[3][1][:, 100:120]
    pairs = [(InputTemplate(entries[3][1][:, 10:40].copy()),
              InputTemplate(entries[3][1][:, 100:120].copy()), 70, 85),
             (InputTemplate(entries[2][1][:, 5:35].copy()),
              InputTemplate(entries[6][1][:, 50:70].copy()), 40, 90)]
    db1 = FeatureDatabase(entries, norm=None, pad_multiple=64)
    db2 = FeatureDatabase(entries, norm=None, pad_multiple=64,
                          mesh=make_files_mesh())
    b1 = db1.query_punch_batch(pairs, k=2)
    b2 = db2.query_punch_batch(pairs, k=2)
    for r1, r2 in zip(b1, b2):
        np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-5)
        np.testing.assert_array_equal(r1.frames, r2.frames)
    m = b2[0].matches(step_size=512, k_total=1)[0]
    assert m.file == entries[5][0] and m.punch.start == 30 * 512
