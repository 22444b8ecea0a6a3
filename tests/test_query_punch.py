"""query_punch: the one-dispatch device punch-in × punch-out combine must
reproduce the reference-semantics search (validated against the exact
correlate_database replay, which is itself validated match-for-match
against the FeatureCorrelationImpl transcription in test_correlation.py)."""

import numpy as np
import pytest

from strugatzki_tpu.analysis.correlation import (InputTemplate,
                                                 correlate_database)
from strugatzki_tpu.config import (CorrelationConfig, ExtractionConfig,
                                   Punch)
from strugatzki_tpu.parallel.database import FeatureDatabase
from strugatzki_tpu.span import Span

STEP = 512


def _make_db(seed, num_files=5, T=420, C=14):
    rng = np.random.default_rng(seed)
    files = []
    for i in range(num_files):
        base = rng.uniform(0.3, 0.7, size=(C, 1))
        x = np.abs(base + 0.1 * rng.standard_normal(
            (C, T + 31 * i))).astype(np.float32)
        files.append((f"db{i}.aif", x))
    inp = np.abs(0.5 + 0.1 * rng.standard_normal((C, 200))).astype(np.float32)
    # plant punch-in material in file 2 and punch-out material further on
    files[2][1][:, 137:137 + 30] = inp[:, 20:50]
    files[2][1][:, 230:230 + 25] = inp[:, 160:185]
    return inp, files


def _run_exact(inp, files, cfg):
    meta = ExtractionConfig(audio_input="in.aif", feature_output="mem",
                            num_coeffs=13, fft_size=1024, fft_overlap=2)
    entries = [(ExtractionConfig(audio_input=name, feature_output=name),
                (lambda f_=f: f_)) for name, f in files]
    import strugatzki_tpu.analysis.correlation as corr_mod
    orig = corr_mod.read_features
    corr_mod.read_features = lambda m: inp
    try:
        return correlate_database(meta, entries, None, cfg, skip_nan=True)
    finally:
        corr_mod.read_features = orig


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 11])
def test_query_punch_matches_exact_replay(seed):
    inp, files = _make_db(seed)
    # num_matches = num_files keeps the reference's order-dependent
    # trace-open pruning inert (entryHasSpace is true at every file open,
    # FeatureCorrelationImpl.scala:213), so the exact replay covers the
    # full candidate space the device kernel searches
    cfg = CorrelationConfig(
        punch_in=Punch(Span(20 * STEP, 50 * STEP), 0.5),
        punch_out=Punch(Span(160 * STEP, 185 * STEP), 0.5),
        min_punch=60 * STEP, max_punch=120 * STEP,
        normalize=False, num_matches=5, num_per_file=1,
        min_spacing=0).build()
    exact = _run_exact(inp, files, cfg)

    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    t_in = InputTemplate.from_features(inp, None, 20, 50)
    t_out = InputTemplate.from_features(inp, None, 160, 185)
    res = db.query_punch(t_in, t_out, min_punch=60, max_punch=120,
                         temp_weight_in=0.5, temp_weight_out=0.5, k=2)
    ours = res.matches(step_size=STEP, k_total=5, num_per_file=1)

    assert len(ours) == len(exact), (ours, exact)
    for a, b in zip(ours, exact):
        assert a.file == b.file, (seed, a, b)
        assert a.punch == b.punch, (seed, a, b)
        assert abs(a.sim - b.sim) < 3e-5, (seed, a, b)
        assert abs(a.boost_in - b.boost_in) < 1e-3 * max(1, abs(b.boost_in))
        assert abs(a.boost_out - b.boost_out) < 1e-3 * max(1, abs(b.boost_out))


def test_query_punch_planted_pair():
    inp, files = _make_db(0)
    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    t_in = InputTemplate.from_features(inp, None, 20, 50)
    t_out = InputTemplate.from_features(inp, None, 160, 185)
    # the plant: in @137, out @230 → punch length 230−137 = 93 ∈ [60, 120]
    res = db.query_punch(t_in, t_out, min_punch=60, max_punch=120, k=2)
    m = res.matches(step_size=STEP, k_total=1)[0]
    assert m.file == "db2.aif"
    assert m.punch.start == 137 * STEP
    assert m.punch.stop == 230 * STEP
    assert m.sim > 0.98
    assert np.isfinite(m.boost_in) and np.isfinite(m.boost_out)


def test_query_returns_boosts():
    inp, files = _make_db(3)
    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    tmpl = InputTemplate(files[2][1][:, 137:167].copy())
    res = db.query(tmpl, k=2)
    assert res.boosts is not None and res.boosts.shape == res.sims.shape
    m = res.matches(punch_len=30, step_size=STEP, k_total=1)[0]
    # self-match: identical loudness → boost 1
    assert abs(m.boost_in - 1.0) < 1e-3
    assert m.boost_out == 1.0


def test_query_batch_mixed_lengths():
    inp, files = _make_db(4)
    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    t_a = InputTemplate(files[1][1][:, 10:48].copy())   # 38 frames
    t_b = InputTemplate(files[3][1][:, 60:115].copy())  # 55 frames
    t_c = InputTemplate(files[2][1][:, 5:43].copy())    # 38 frames
    rs = db.query_batch([t_a, t_b, t_c], k=2)
    assert len(rs) == 3
    # each self-plant found at its own offset
    assert rs[0].frames[1, 0] == 10 and abs(rs[0].sims[1, 0] - 1) < 1e-3
    assert rs[1].frames[3, 0] == 60 and abs(rs[1].sims[3, 0] - 1) < 1e-3
    assert rs[2].frames[2, 0] == 5 and abs(rs[2].sims[2, 0] - 1) < 1e-3
    # bucketed results must equal per-template queries
    for t, r in zip([t_a, t_b, t_c], rs):
        single = db.query(t, k=2)
        np.testing.assert_allclose(r.sims, single.sims, atol=1e-6)
        np.testing.assert_array_equal(r.frames, single.frames)


def test_query_batch_boosts_and_bf16_rerank():
    """query_batch must return boosts and apply the automatic exact re-rank
    for reduced-precision storage, matching query()."""
    import jax.numpy as jnp
    inp, files = _make_db(6)
    tmpl = InputTemplate(files[2][1][:, 137:167].copy())
    db16 = FeatureDatabase(files, norm=None, pad_multiple=64,
                           storage_dtype=jnp.bfloat16)
    [rb] = db16.query_batch([tmpl], k=2)
    rq = db16.query(tmpl, k=2)
    assert rb.boosts is not None
    np.testing.assert_allclose(rb.sims, rq.sims, atol=1e-6)
    np.testing.assert_array_equal(rb.frames, rq.frames)
    np.testing.assert_allclose(rb.boosts, rq.boosts, atol=1e-6)
    assert abs(rb.sims[2, 0] - 1.0) < 3e-5  # exact after re-rank


def test_query_punch_with_normalization():
    """The device prep normalizes with feat_norms ranges; results must match
    the exact replay under the same norm."""
    inp, files = _make_db(8)
    allf = np.concatenate([f for _, f in files] + [inp], axis=1)
    norm = np.stack([allf.min(axis=1) - 1e-3, allf.max(axis=1) + 1e-3],
                    axis=1).astype(np.float32)

    meta = ExtractionConfig(audio_input="in.aif", feature_output="mem",
                            num_coeffs=13, fft_size=1024, fft_overlap=2)
    entries = [(ExtractionConfig(audio_input=n, feature_output=n),
                (lambda f_=f: f_)) for n, f in files]
    cfg = CorrelationConfig(
        punch_in=Punch(Span(20 * STEP, 50 * STEP), 0.5),
        punch_out=Punch(Span(160 * STEP, 185 * STEP), 0.5),
        min_punch=60 * STEP, max_punch=120 * STEP,
        normalize=True, num_matches=5, num_per_file=1, min_spacing=0).build()
    import strugatzki_tpu.analysis.correlation as corr_mod
    orig = corr_mod.read_features
    corr_mod.read_features = lambda m: inp
    try:
        exact = correlate_database(meta, entries, norm, cfg, skip_nan=True)
    finally:
        corr_mod.read_features = orig

    db = FeatureDatabase(files, norm=norm, pad_multiple=64)
    t_in = InputTemplate.from_features(inp, norm, 20, 50)
    t_out = InputTemplate.from_features(inp, norm, 160, 185)
    res = db.query_punch(t_in, t_out, min_punch=60, max_punch=120, k=2)
    ours = res.matches(step_size=STEP, k_total=5, num_per_file=1)
    assert len(ours) == len(exact)
    for a, b in zip(ours, exact):
        assert a.file == b.file, (a, b)
        assert a.punch == b.punch, (a, b)
        assert abs(a.sim - b.sim) < 5e-5, (a, b)
        assert abs(a.boost_in - b.boost_in) < 1e-3 * max(1, abs(b.boost_in))


# ---------------------------------------------------------------------------
# round 3: exact selection replay on the serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 7, 11, 13])
def test_punch_serving_replay_num_per_file_spacing(seed):
    """With num_per_file=2 and min_spacing>0 the serving result must equal
    the full FeatureCorrelation replay — PunchQueryResult.matches now runs
    the reference's stateful selection (analysis.topk.replay_selection)
    over the device candidates instead of a greedy descending-sim cap.
    num_matches ≥ files·num_per_file keeps the reference's trace-open
    pruning inert so the device kernel's candidate space matches."""
    inp, files = _make_db(seed)
    cfg = CorrelationConfig(
        punch_in=Punch(Span(20 * STEP, 50 * STEP), 0.5),
        punch_out=Punch(Span(160 * STEP, 185 * STEP), 0.5),
        min_punch=60 * STEP, max_punch=120 * STEP,
        normalize=False, num_matches=10, num_per_file=2,
        min_spacing=40 * STEP).build()
    exact = _run_exact(inp, files, cfg)

    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    t_in = InputTemplate.from_features(inp, None, 20, 50)
    t_out = InputTemplate.from_features(inp, None, 160, 185)
    # exactness needs the COMPLETE candidate set: the reference's collapse
    # chain steps through low-sim candidates too, so k = every window
    k_all = db._xs.shape[2] - 30 + 1
    res = db.query_punch(t_in, t_out, min_punch=60, max_punch=120,
                         temp_weight_in=0.5, temp_weight_out=0.5, k=k_all)
    ours = res.matches(step_size=STEP, k_total=10, num_per_file=2,
                       min_spacing=40 * STEP)

    assert len(ours) == len(exact), (seed, ours, exact)
    for a, b in zip(ours, exact):
        assert a.file == b.file, (seed, a, b)
        assert a.punch == b.punch, (seed, a, b)
        assert abs(a.sim - b.sim) < 3e-5, (seed, a, b)


@pytest.mark.parametrize("seed", [0, 2, 4, 6, 9])
def test_punchin_serving_replay_num_per_file_spacing(seed):
    """Punch-in-only serving (QueryResult.matches) under the same exact
    replay, against the analysis path's inline-scan selection."""
    inp, files = _make_db(seed)
    cfg = CorrelationConfig(
        punch_in=Punch(Span(20 * STEP, 50 * STEP), 0.5),
        punch_out=None, normalize=False, num_matches=10, num_per_file=2,
        min_spacing=35 * STEP).build()
    exact = _run_exact(inp, files, cfg)

    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    tmpl = InputTemplate.from_features(inp, None, 20, 50)
    res = db.query(tmpl, k=db._xs.shape[2] - 30 + 1)   # complete set
    ours = res.matches(punch_len=30, step_size=STEP, k_total=10,
                       num_per_file=2, min_spacing=35 * STEP)

    assert len(ours) == len(exact), (seed, ours, exact)
    for a, b in zip(ours, exact):
        assert a.file == b.file, (seed, a, b)
        assert a.punch == b.punch, (seed, a, b)
        assert abs(a.sim - b.sim) < 3e-5, (seed, a, b)


def _plant_graded(base, tmpl_mat, off, deficit, rng):
    """Plant a copy of ``tmpl_mat`` at ``off`` whose exact correlation sim
    is 1 − ``deficit`` by construction: per channel group (temporal ch 0 /
    spectral 1..13, the kernel's Pearson groups), add noise centered and
    orthogonalized against the centered template, scaled to the target
    deficit — so the true sim gap between plants is deterministic while
    each plant's bf16 quantization noise stays independent."""
    C, L = tmpl_mat.shape
    t0 = tmpl_mat[0] - tmpl_mat[0].mean()
    ts = (tmpl_mat[1:] - tmpl_mat[1:].mean()).ravel()
    e0, es = float((t0 ** 2).sum()), float((ts ** 2).sum())
    n0 = rng.standard_normal(L)
    n0 -= n0.mean()
    n0 -= (n0 @ t0) / e0 * t0
    n0 /= np.linalg.norm(n0)
    ns = rng.standard_normal((C - 1) * L)
    ns -= ns.mean()
    ns -= (ns @ ts) / es * ts
    ns /= np.linalg.norm(ns)
    p = tmpl_mat.copy()
    p[0] += np.sqrt(2 * e0 * deficit) * n0
    p[1:] += (np.sqrt(2 * es * deficit) * ns).reshape(C - 1, L)
    base[:, off:off + L] = p.astype(np.float32)


def test_bf16_k_inflation_recovers_misordered_topk():
    """bf16 storage quantizes the (group-shifted) features: its device sims
    carry ~1e-5 noise, so candidates with true sim gaps of ~1.5e-6 get
    misordered out of a small top-k.  The automatic 4× device-k inflation +
    exact re-rank must recover the f32 database's exact top-k on every
    seed — and the construction must genuinely misorder the plain bf16
    device ranking on several."""
    import jax.numpy as jnp
    misordered = 0
    for seed in range(12):
        rng = np.random.default_rng(seed)
        C, T = 14, 420
        base = np.abs(0.5 + 5.0 * rng.standard_normal((C, T))).astype(np.float32)
        tmpl_mat = np.abs(0.5 + 5.0 * rng.standard_normal((C, 30))).astype(np.float32)
        # exact sims 0.9990015 > 0.9990000 > 0.9989985 at offsets 100/200/300
        for i, off in enumerate((100, 200, 300)):
            _plant_graded(base, tmpl_mat, off, 1e-3 + i * 1.5e-6, rng)
        files = [("probe.aif", base)]
        tmpl = InputTemplate(tmpl_mat)
        db32 = FeatureDatabase(files, norm=None, pad_multiple=64)
        db16 = FeatureDatabase(files, norm=None, pad_multiple=64,
                               storage_dtype=jnp.bfloat16)
        r32 = db32.query(tmpl, k=2, exact_rerank=True)
        r16 = db16.query(tmpl, k=2)                     # inflation + rerank
        raw16 = db16.query(tmpl, k=2, exact_rerank=False)
        assert r16.sims.shape == (1, 2)
        np.testing.assert_array_equal(np.asarray(r32.frames), [[100, 200]])
        np.testing.assert_array_equal(r16.frames, r32.frames, err_msg=str(seed))
        np.testing.assert_allclose(r16.sims, r32.sims, atol=2e-5,
                                   err_msg=str(seed))
        if not np.array_equal(np.asarray(raw16.frames),
                              np.asarray(r32.frames)):
            misordered += 1
    # the adversarial construction must actually bite for the test to mean
    # anything (measured: 4-6 of 12 seeds misorder)
    assert misordered >= 3, misordered


def test_chunked_bf16_staging_matches(monkeypatch):
    """Chunked slab staging with reduced-precision storage writes each
    prepared slab into the preallocated bf16 buffer; results must equal the
    unchunked bf16 database."""
    import jax.numpy as jnp
    from strugatzki_tpu.parallel import database as D
    inp, files = _make_db(1, num_files=7)
    tmpl = InputTemplate(files[2][1][:, 137:167].copy())
    ref = D.FeatureDatabase(files, norm=None, pad_multiple=64,
                            storage_dtype=jnp.bfloat16)
    monkeypatch.setattr(D, "_QUERY_CHUNK", 3)
    db = D.FeatureDatabase(files, norm=None, pad_multiple=64,
                           storage_dtype=jnp.bfloat16)
    assert db._xs.dtype == jnp.bfloat16
    assert db._xs.shape[0] == 9 and db.num_files == 7
    r1 = ref.query(tmpl, k=2)
    r2 = db.query(tmpl, k=2)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-6)


def test_query_punch_batch_matches_sequential():
    """query_punch_batch must reproduce query_punch pair-for-pair across
    mixed template-shape buckets and mixed punch bands (the band is traced,
    so pairs with different bands share one bucket), on an f32 database and
    on the compact mode (planar bf16 spectra + device re-rank)."""
    inp, files = _make_db(3, num_files=6)
    t_in30 = InputTemplate(inp[:, 20:50].copy())
    t_out25 = InputTemplate(inp[:, 160:185].copy())
    t_in40 = InputTemplate(files[1][1][:, 50:90].copy())
    t_out25b = InputTemplate(files[4][1][:, 200:225].copy())
    pairs = [
        (t_in30, t_out25, 80, 100),       # bucket (30, 25), planted hit
        (t_in40, t_out25b, 60, 90),       # bucket (40, 25)
        (t_in30, t_out25b, 70, 120),      # bucket (30, 25), other band
        (t_in30, t_out25, 85, 95),        # bucket (30, 25), narrow band
    ]
    for kw in (dict(), dict(cache_spectra="bf16")):
        db = FeatureDatabase(files, norm=None, pad_multiple=64, **kw)
        batch = db.query_punch_batch(pairs, k=3)
        assert len(batch) == 4
        for q, (p_in, p_out, mp, xp) in enumerate(pairs):
            single = db.query_punch(p_in, p_out, min_punch=mp, max_punch=xp,
                                    k=3)
            np.testing.assert_allclose(batch[q].sims, single.sims,
                                       atol=1e-6, err_msg=str((q, kw)))
            np.testing.assert_array_equal(batch[q].frames, single.frames)
            np.testing.assert_array_equal(batch[q].punch_lens,
                                          single.punch_lens)
            np.testing.assert_allclose(batch[q].boosts_in, single.boosts_in,
                                       rtol=1e-6)
            assert batch[q].min_punch == mp
    # the planted pair must surface as the global best of pair 0
    m = batch[0].matches(step_size=STEP, k_total=1)[0]
    assert m.file == "db2.aif" and m.punch.start == 137 * STEP


def test_query_punch_batch_validates_band():
    inp, files = _make_db(4, num_files=3)
    t_in = InputTemplate(inp[:, 20:50].copy())
    t_out = InputTemplate(inp[:, 160:185].copy())
    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    with pytest.raises(ValueError, match="min_punch"):
        db.query_punch_batch([(t_in, t_out, 90, 80)])


def test_query_punch_batch_fuzz_seeds():
    """Fuzz parity for the batched punch path: random databases, random
    pair shapes/bands (bucketed arbitrarily), random storage mode — every
    pair must equal its sequential query_punch (STRUG_FUZZ_SEEDS=N runs a
    longer soak)."""
    from conftest import FUZZ_SEEDS, FUZZ_BASE, soak_hygiene
    for seed in range(FUZZ_BASE, FUZZ_BASE + (FUZZ_SEEDS or 8)):
        soak_hygiene(seed)
        rng = np.random.default_rng(100 + seed)
        n_files = int(rng.integers(3, 7))
        files = []
        for i in range(n_files):
            T = int(rng.integers(200, 380))
            base = rng.uniform(0.3, 0.7, size=(14, 1))
            files.append((f"s{seed}f{i}.aif",
                          np.abs(base + 0.1 * rng.standard_normal((14, T))
                                 ).astype(np.float32)))
        kw = dict(cache_spectra="bf16") if seed % 2 else {}
        db = FeatureDatabase(files, norm=None, pad_multiple=64, **kw)
        pairs = []
        for _ in range(int(rng.integers(2, 5))):
            src = files[int(rng.integers(0, n_files))][1]
            li = int(rng.integers(16, 40))
            lo = int(rng.integers(16, 40))
            t0 = int(rng.integers(0, src.shape[1] - li))
            t1 = int(rng.integers(0, src.shape[1] - lo))
            mp = int(rng.integers(10, 60))
            pairs.append((InputTemplate(src[:, t0:t0 + li].copy()),
                          InputTemplate(src[:, t1:t1 + lo].copy()),
                          mp, mp + int(rng.integers(0, 50))))
        batch = db.query_punch_batch(pairs, k=3)
        for q, (p_in, p_out, mp, xp) in enumerate(pairs):
            single = db.query_punch(p_in, p_out, min_punch=mp,
                                    max_punch=xp, k=3)
            np.testing.assert_array_equal(batch[q].frames, single.frames,
                                          err_msg=f"seed={seed} q={q}")
            np.testing.assert_allclose(batch[q].sims, single.sims,
                                       atol=1e-6,
                                       err_msg=f"seed={seed} q={q}")
            np.testing.assert_array_equal(batch[q].punch_lens,
                                          single.punch_lens)


def test_batched_kernels_chunked_files_path(monkeypatch):
    """The validated-batch files chunking in the batched kernels
    (``_chunked_files_vmap`` — the guard against the batched-kernel
    fault documented in docs/PARITY.md) must be result-identical to the plain
    files vmap, including a ragged zero-padded tail chunk, on both the f32
    and the compact (planar bf16 spectra) storage modes."""
    from strugatzki_tpu.parallel import database as D

    inp, files = _make_db(5, num_files=7)
    tmpls = [InputTemplate(files[i][1][:, 30 + i:60 + i].copy())
             for i in range(3)]
    pairs = [(InputTemplate(inp[:, 20:50].copy()),
              InputTemplate(inp[:, 160:185].copy()), 80, 100),
             (InputTemplate(files[1][1][:, 50:80].copy()),
              InputTemplate(files[4][1][:, 200:225].copy()), 60, 90)]
    kernels = (D._multi_query_kernel, D._multi_query_kernel_spectra,
               D._multi_punch_kernel, D._multi_punch_kernel_spectra)
    for kw in (dict(), dict(cache_spectra="bf16")):
        db = FeatureDatabase(files, norm=None, pad_multiple=64, **kw)
        ref_q = db.query_batch(tmpls, k=3)
        ref_p = db.query_punch_batch(pairs, k=3)
        # query: Q=3 -> bc = 8//3 -> 2 -> 4 chunks of 2 with one
        # zero-padded tail file; punch: Q=2 -> lanes 2*Q=4 -> bc=2 ->
        # likewise 4 chunks of 2 with one padded tail file
        for kern in kernels:
            kern.clear_cache()
        monkeypatch.setattr(D, "_VALIDATED_QB_BATCH", 8)
        try:
            got_q = db.query_batch(tmpls, k=3)
            got_p = db.query_punch_batch(pairs, k=3)
        finally:
            monkeypatch.undo()
            for kern in kernels:
                kern.clear_cache()
        for q in range(len(tmpls)):
            np.testing.assert_array_equal(got_q[q].frames, ref_q[q].frames,
                                          err_msg=str((q, kw)))
            np.testing.assert_allclose(got_q[q].sims, ref_q[q].sims,
                                       atol=1e-6, err_msg=str((q, kw)))
        for q in range(len(pairs)):
            np.testing.assert_array_equal(got_p[q].frames, ref_p[q].frames,
                                          err_msg=str((q, kw)))
            np.testing.assert_allclose(got_p[q].sims, ref_p[q].sims,
                                       atol=1e-6, err_msg=str((q, kw)))
            np.testing.assert_array_equal(got_p[q].punch_lens,
                                          ref_p[q].punch_lens)


def test_files_chunk_budget_is_not_shard_scaled():
    """Round-5 fix of a round-4 advisor finding: the chunk budget used to
    scale by the mesh shard count, assuming GSPMD splits each chunk step
    evenly over the mesh.  Inspecting the partitioned program showed
    GSPMD tiles the (nc, bc) reshape two-dimensionally (e.g. [2, 4] over
    8 devices), putting bc/4 files on a chip per step — at the scaled
    budget that is 2·_VALIDATED_QB_BATCH = 2048 trace lanes, exactly the
    silently-deflating regime.  The unscaled budget bounds per-chip lanes
    under ANY partitioning; pin it."""
    from strugatzki_tpu.parallel import database as D

    for lanes in (1, 2, 8, 16, 100):
        base = D._files_chunk(lanes, shards=1)
        assert D._files_chunk(lanes, shards=8) == base
        assert lanes * base <= D._VALIDATED_QB_BATCH
        assert base & (base - 1) == 0        # power of two


def test_mesh_chunked_batches_match_single_device(monkeypatch):
    """The mesh × chunked-files combination (previously only reachable at
    10k scale): with a downscaled budget forcing chunking, the sharded
    batched kernels must equal the single-device batch."""
    from strugatzki_tpu.parallel import database as D
    from strugatzki_tpu.parallel.sweep import make_files_mesh

    inp, files = _make_db(9, num_files=7)
    tmpls = [InputTemplate(files[i][1][:, 30 + i:60 + i].copy())
             for i in range(3)]
    pairs = [(InputTemplate(inp[:, 20:50].copy()),
              InputTemplate(inp[:, 160:185].copy()), 80, 100)]
    db1 = FeatureDatabase(files, norm=None, pad_multiple=64)
    ref_q = db1.query_batch(tmpls, k=3)
    ref_p = db1.query_punch_batch(pairs, k=3)
    kernels = (D._multi_query_kernel, D._multi_query_kernel_spectra,
               D._multi_punch_kernel, D._multi_punch_kernel_spectra)
    for kern in kernels:
        kern.clear_cache()
    monkeypatch.setattr(D, "_VALIDATED_QB_BATCH", 8)
    try:
        db2 = FeatureDatabase(files, norm=None, pad_multiple=64,
                              mesh=make_files_mesh())
        got_q = db2.query_batch(tmpls, k=3)
        got_p = db2.query_punch_batch(pairs, k=3)
    finally:
        monkeypatch.undo()
        for kern in kernels:
            kern.clear_cache()
    for q in range(len(tmpls)):
        np.testing.assert_array_equal(got_q[q].frames, ref_q[q].frames)
        np.testing.assert_allclose(got_q[q].sims, ref_q[q].sims, atol=2e-5)
    np.testing.assert_array_equal(got_p[0].frames, ref_p[0].frames)
    np.testing.assert_allclose(got_p[0].sims, ref_p[0].sims, atol=2e-5)
    np.testing.assert_array_equal(got_p[0].punch_lens, ref_p[0].punch_lens)


def test_batch_bucket_splitting(monkeypatch):
    """Oversized same-shape buckets split into _MAX_BATCH_QUERIES-sized
    sub-dispatches (the files-chunking cannot bound the fused step once
    the chunk floors at one file); results must stay in input order and
    equal the unsplit dispatch."""
    from strugatzki_tpu.parallel import database as D

    inp, files = _make_db(6, num_files=5)
    tmpls = [InputTemplate(files[i % 5][1][:, 30 + i:60 + i].copy())
             for i in range(7)]            # one length bucket of 7
    pairs = [(InputTemplate(files[i % 5][1][:, 20:50].copy()),
              InputTemplate(files[(i + 2) % 5][1][:, 160:185].copy()),
              60 + i, 110 + i) for i in range(5)]
    db = FeatureDatabase(files, norm=None, pad_multiple=64)
    ref_q = db.query_batch(tmpls, k=3)
    ref_p = db.query_punch_batch(pairs, k=3)
    monkeypatch.setattr(D, "_MAX_BATCH_QUERIES", 3)
    got_q = db.query_batch(tmpls, k=3)     # sub-dispatches of 3, 3, 1
    got_p = db.query_punch_batch(pairs, k=3)
    for q in range(len(tmpls)):
        np.testing.assert_array_equal(got_q[q].frames, ref_q[q].frames)
        np.testing.assert_allclose(got_q[q].sims, ref_q[q].sims, atol=1e-6)
    for q in range(len(pairs)):
        np.testing.assert_array_equal(got_p[q].frames, ref_p[q].frames)
        np.testing.assert_allclose(got_p[q].sims, ref_p[q].sims, atol=1e-6)
        assert got_p[q].min_punch == pairs[q][2]
