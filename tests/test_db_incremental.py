"""Incremental FeatureDatabase updates: add_files / remove_files must be
indistinguishable (matches and sims) from a freshly built database over the
same live entries, across storage modes, slot reuse, and restage fallbacks."""

import numpy as np
import pytest

import jax.numpy as jnp

from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel.database import FeatureDatabase


def _feats(rng, T=200, C=6):
    return np.abs(0.5 + 0.2 * rng.standard_normal((C, T))).astype(np.float32)


def _entries(seed, n, T=200, C=6):
    rng = np.random.default_rng(seed)
    return [(f"f{seed}_{i}.aif", _feats(rng, T + 7 * i, C))
            for i in range(n)]


def _tmpl(entries, i=0, start=20, L=60):
    return InputTemplate(entries[i][1][:, start:start + L].copy())


def _match_tuples(res, k=6, punch_len=60, step=512):
    return [(m.file, m.punch.start, round(m.sim, 6), round(m.boost_in, 6))
            for m in res.matches(punch_len, step, k)]


def _assert_equiv(db, fresh_entries, tmpl, **kw):
    fresh = FeatureDatabase(fresh_entries, norm=None, **kw)
    got = db.query(tmpl, k=3)
    want = fresh.query(tmpl, k=3)
    assert _match_tuples(got) == _match_tuples(want)


def test_add_files_appends():
    base = _entries(1, 4)
    extra = _entries(2, 3, T=150)
    db = FeatureDatabase(base, norm=None)
    db.add_files(extra)
    assert db.num_files == 7
    _assert_equiv(db, base + extra, _tmpl(extra, 1))


def test_remove_tombstones_then_query():
    ents = _entries(3, 5)
    db = FeatureDatabase(ents, norm=None)
    db.remove_files([ents[1][0], ents[3][0]])
    assert db.num_files == 3
    live = [e for i, e in enumerate(ents) if i not in (1, 3)]
    # the removed file's own template must no longer hit it
    _assert_equiv(db, live, _tmpl(ents, 1))
    with pytest.raises(KeyError):
        db.remove_files([ents[1][0]])


def test_add_reuses_tombstone_slots():
    ents = _entries(4, 5)
    db = FeatureDatabase(ents, norm=None)
    rows_before = db._xs.shape[0]
    db.remove_files([ents[0][0], ents[2][0]])
    extra = _entries(5, 2, T=120)
    db.add_files(extra)
    assert db._xs.shape[0] == rows_before          # no growth
    assert db.num_files == 5
    live = [e for i, e in enumerate(ents) if i not in (0, 2)] + extra
    _assert_equiv(db, live, _tmpl(extra, 0))


def test_add_longer_file_restages():
    ents = _entries(6, 3, T=100)
    db = FeatureDatabase(ents, norm=None)
    long = [("long.aif", _feats(np.random.default_rng(9), T=900))]
    db.add_files(long)
    assert db._raw.shape[2] >= 900
    _assert_equiv(db, ents + long, _tmpl(long, 0))


def test_add_overflow_restages():
    ents = _entries(7, 2)
    db = FeatureDatabase(ents, norm=None)
    extra = _entries(8, 4, T=150)
    db.add_files(extra)                            # no free slots -> restage
    assert db.num_files == 6
    _assert_equiv(db, ents + extra, _tmpl(extra, 2))


def test_add_failure_before_commit_leaves_db_intact(monkeypatch):
    """An ASYNC device failure in the add batch's prep kernels surfaces at
    the pre-commit ``jax.block_until_ready`` — which must run BEFORE any
    host metadata mutates (the all-or-nothing commit contract): the
    database stays fully usable with its pre-add contents.  Simulated by
    making the first ``block_until_ready`` of the add raise (the way a
    deferred RESOURCE_EXHAUSTED would surface)."""
    import jax

    ents = _entries(20, 4)
    kw = dict(cache_spectra=True)
    db = FeatureDatabase(ents, norm=None, **kw)
    files_before = list(db.files)
    lens_before = np.array(db._lens)
    raw_before = np.array(db._raw)

    def boom(*a, **k):
        raise RuntimeError("simulated deferred device failure")

    monkeypatch.setattr(jax, "block_until_ready", boom)
    with pytest.raises(RuntimeError, match="simulated deferred"):
        db.add_files(_entries(21, 1, T=150))
    monkeypatch.undo()

    assert db.files == files_before
    np.testing.assert_array_equal(np.array(db._lens), lens_before)
    np.testing.assert_array_equal(np.array(db._raw), raw_before)
    assert db.num_files == 4
    _assert_equiv(db, ents, _tmpl(ents, 1), **kw)


def test_duplicate_add_rejected():
    ents = _entries(10, 3)
    db = FeatureDatabase(ents, norm=None)
    with pytest.raises(ValueError):
        db.add_files([ents[0]])


def test_incremental_compact_mode_spectra():
    ents = _entries(11, 4)
    kw = dict(storage_dtype=jnp.bfloat16, cache_spectra="bf16")
    db = FeatureDatabase(ents, norm=None, **kw)
    db.remove_files([ents[2][0]])
    extra = _entries(12, 2, T=180)
    db.add_files(extra)
    live = [e for i, e in enumerate(ents) if i != 2] + extra
    _assert_equiv(db, live, _tmpl(extra, 1), **kw)
    # punch query exercises the updated spectra cache rows
    t_in = _tmpl(extra, 1, start=10, L=40)
    t_out = _tmpl(extra, 1, start=90, L=30)
    fresh = FeatureDatabase(live, norm=None, **kw)
    got = db.query_punch(t_in, t_out, min_punch=60, max_punch=100, k=2)
    want = fresh.query_punch(t_in, t_out, min_punch=60, max_punch=100, k=2)
    gm, wm = got.matches(512, 3), want.matches(512, 3)
    assert [(m.file, m.punch.start, round(m.sim, 6)) for m in gm] == \
        [(m.file, m.punch.start, round(m.sim, 6)) for m in wm]


def test_save_compacts_tombstones(tmp_path):
    ents = _entries(13, 4)
    db = FeatureDatabase(ents, norm=None)
    db.remove_files([ents[1][0]])
    extra = _entries(14, 1, T=160)
    db.add_files(extra)                            # fills the tombstone
    p = tmp_path / "db.npz"
    db.save(p)
    db2 = FeatureDatabase.load(p)
    assert sorted(db2.files) == sorted(
        [e[0] for i, e in enumerate(ents) if i != 1] + [extra[0][0]])
    live = [e for i, e in enumerate(ents) if i != 1] + extra
    _assert_equiv(db2, live, _tmpl(extra, 0))


def test_rerank_limit_preserves_top_matches(monkeypatch):
    """With more finite candidates than RERANK_LIMIT, the capped exact
    re-rank must return the same top matches as an unlimited one."""
    rng = np.random.default_rng(99)
    ents = [(f"r{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((4, 60))).astype(
                 np.float32)) for i in range(600)]
    tmpl = InputTemplate(ents[123][1][:, 10:40].copy())
    kw = dict(norm=None, storage_dtype=jnp.bfloat16)

    db = FeatureDatabase(ents, **kw)
    monkeypatch.setattr(FeatureDatabase, "RERANK_LIMIT", 100)
    capped = db.query(tmpl, k=2)
    assert np.isfinite(capped.sims).sum() > 100      # the cap actually bit
    monkeypatch.setattr(FeatureDatabase, "RERANK_LIMIT", 10**9)
    full = db.query(tmpl, k=2)
    want = [(m.file, m.punch.start, round(m.sim, 6))
            for m in full.matches(30, 512, 10)]
    got = [(m.file, m.punch.start, round(m.sim, 6))
           for m in capped.matches(30, 512, 10)]
    assert got == want


def _run_query(db, kind, ents):
    """One result of the named query path over ``ents``' template(s)."""
    t_in = _tmpl(ents, 5, start=10, L=40)
    t_out = _tmpl(ents, 5, start=90, L=30)
    if kind == "query":
        return db.query(t_in, k=2)
    if kind == "query_batch":
        return db.query_batch([t_in, t_out], k=2)[0]
    if kind == "query_punch":
        return db.query_punch(t_in, t_out, min_punch=60, max_punch=100, k=2)
    return db.query_punch_batch([(t_in, t_out, 60, 100)], k=2)[0]


@pytest.mark.parametrize("kind", ["query", "query_batch", "query_punch",
                                  "query_punch_batch"])
def test_exact_mask_marks_rescored_hits(monkeypatch, kind):
    """``exact`` marks the hits the capped re-rank re-scored: they carry
    the same sims as an uncapped re-rank, the rest keep raw device sims;
    the mask follows the re-sort and the trim to ``k`` columns."""
    ents = _entries(40, 40, C=14)
    db = FeatureDatabase(ents, norm=None, cache_spectra="bf16")
    assert _run_query(FeatureDatabase(ents, norm=None), kind,
                      ents).exact is None        # f32 store: no re-rank
    monkeypatch.setattr(FeatureDatabase, "RERANK_LIMIT", 20)
    capped = _run_query(db, kind, ents)
    monkeypatch.setattr(FeatureDatabase, "RERANK_LIMIT", 10**9)
    full = _run_query(db, kind, ents)
    live = np.isfinite(capped.sims)
    assert capped.exact.shape == capped.sims.shape == (40, 2)
    assert 0 < (capped.exact & live).sum() <= 20
    assert (~capped.exact & live).any()
    assert full.exact[np.isfinite(full.sims)].all()
    lens = getattr(capped, "punch_lens", np.zeros_like(capped.frames))
    f_lens = getattr(full, "punch_lens", np.zeros_like(full.frames))
    for i, j in np.argwhere(capped.exact & live):
        same = (full.frames[i] == capped.frames[i, j]) & \
            (f_lens[i] == lens[i, j])
        assert same.any()
        np.testing.assert_allclose(full.sims[i][same][0], capped.sims[i, j],
                                   atol=1e-6)


def test_concurrent_queries_thread_safe():
    """Serving reads are side-effect-free: many threads querying one
    resident database concurrently get identical results."""
    import threading

    ents = _entries(30, 6)
    db = FeatureDatabase(ents, norm=None)
    tmpl = _tmpl(ents, 2)
    want = _match_tuples(db.query(tmpl, k=3))
    results, errors = [None] * 8, []

    def worker(j):
        try:
            results[j] = _match_tuples(db.query(tmpl, k=3))
        except Exception as e:  # noqa: BLE001 - surface in the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert all(r == want for r in results)


def test_incremental_new_compact_mode():
    """Round-4 compact combo (f32 features + PLANAR bf16 spectra + device
    re-rank): incremental add/remove must stay match-identical to a fresh
    build, exercising the planar (re, im) spectra scatter and the device
    re-rank over updated rows (C=14 so the InputTemplate channel layout
    holds)."""
    ents = _entries(21, 9, C=14)
    kw = dict(cache_spectra="bf16")
    db = FeatureDatabase(ents, norm=None, **kw)
    assert db._rerank_device and len(db._spectra) == 2
    db.remove_files([ents[4][0]])
    extra = _entries(22, 2, T=170, C=14)
    db.add_files(extra)
    assert len(db._spectra) == 2
    live = [e for i, e in enumerate(ents) if i != 4] + extra
    _assert_equiv(db, live, _tmpl(extra, 0), **kw)
    t_in = _tmpl(extra, 1, start=10, L=40)
    t_out = _tmpl(extra, 1, start=90, L=30)
    fresh = FeatureDatabase(live, norm=None, **kw)
    got = db.query_punch(t_in, t_out, min_punch=60, max_punch=100, k=2)
    want = fresh.query_punch(t_in, t_out, min_punch=60, max_punch=100, k=2)
    assert [(m.file, m.punch.start, round(m.sim, 6))
            for m in got.matches(512, 3)] == \
        [(m.file, m.punch.start, round(m.sim, 6))
         for m in want.matches(512, 3)]
