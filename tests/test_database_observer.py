"""Serving-layer observer protocol: FeatureDatabase
staging, incremental adds, restages and save/load report progress and honor
cooperative abort — the same contract the six analysis factories follow
(the reference's checkAborted/progress pattern,
FeatureCorrelationImpl.scala:164,402)."""

import numpy as np
import pytest

from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel import database as D
from strugatzki_tpu.parallel.database import FeatureDatabase
from strugatzki_tpu.runtime.processor import Aborted, Progress, Result


def _entries(n=8, seed=0, T=200):
    rng = np.random.default_rng(seed)
    return [(f"f{i}.aif",
             np.abs(0.5 + 0.1 * rng.standard_normal((14, T + 5 * i))
                    ).astype(np.float32)) for i in range(n)]


def test_staging_progress_events(monkeypatch):
    """Chunked (slab-wise) staging emits monotone progress ending at 1.0,
    with intermediate fractions per slab; the spectra-cache pass continues
    the scale."""
    monkeypatch.setattr(D, "_QUERY_CHUNK", 3)
    fracs = []
    db = FeatureDatabase(_entries(8), norm=None, pad_multiple=64,
                         cache_spectra="bf16", progress=fracs.append)
    assert db.num_files == 8
    assert fracs[-1] == 1.0
    assert all(b >= a for a, b in zip(fracs, fracs[1:]))
    assert any(0.0 < f < 0.7 for f in fracs)      # feature slabs
    assert any(0.7 <= f < 1.0 for f in fracs)     # spectra chunks


def test_staging_abort_mid_slab(monkeypatch):
    """Abort between slabs fails construction cleanly (no object escapes
    half-staged)."""
    monkeypatch.setattr(D, "_QUERY_CHUNK", 3)
    calls = {"n": 0}

    def check():
        calls["n"] += 1
        if calls["n"] >= 2:
            raise Aborted()

    with pytest.raises(Aborted):
        FeatureDatabase(_entries(9), norm=None, pad_multiple=64,
                        check_aborted=check)
    assert calls["n"] >= 2


def test_stage_processor_observer_and_result():
    """FeatureDatabase.stage drives the full Processor surface: Progress
    events then a successful Result carrying the database."""
    events = []
    proc = FeatureDatabase.stage(_entries(5), None, observer=events.append,
                                 pad_multiple=64)
    db = proc.result(timeout=120)
    assert db.num_files == 5
    tmpl = InputTemplate(_entries(5)[2][1][:, 20:60].copy())
    assert db.query(tmpl, k=1).frames[2, 0] == 20
    assert any(isinstance(e, Progress) for e in events)
    res = [e for e in events if isinstance(e, Result)]
    assert len(res) == 1 and res[0].is_success


def test_stage_processor_abort(monkeypatch):
    """Aborting the staging processor from its first progress event (the
    observer runs on the body thread, so the next slab's checkAborted
    sees it deterministically) yields an Aborted failure result."""
    monkeypatch.setattr(D, "_QUERY_CHUNK", 2)
    entries = _entries(10)

    def observer(e):
        if isinstance(e, Progress) and e.fraction < 1.0:
            e.processor.abort()

    proc = FeatureDatabase.stage(entries, None, observer=observer,
                                 pad_multiple=64)
    res = proc.ready(timeout=120)
    assert res.failure is not None
    assert res.is_aborted


def test_restage_abort_leaves_old_state_usable():
    """An aborted add_files-triggered restage must leave the previous
    resident database fully answering queries with its old content."""
    entries = _entries(4)
    db = FeatureDatabase(entries, norm=None, pad_multiple=32)
    old_files = list(db.files)
    rng = np.random.default_rng(9)
    # longer than the time capacity → restage path
    big = np.abs(0.5 + 0.1 * rng.standard_normal((14, 2000))
                 ).astype(np.float32)

    def abort_now():
        raise Aborted()

    with pytest.raises(Aborted):
        db.add_files([("big.aif", big)], check_aborted=abort_now)
    assert db.files == old_files
    assert "big.aif" not in db.files
    tmpl = InputTemplate(entries[1][1][:, 30:70].copy())
    assert db.query(tmpl, k=1).frames[1, 0] == 30


def test_incremental_add_abort_before_commit(monkeypatch):
    """The in-place add path only mutates after its last abort point; an
    abort raised there leaves the database unchanged."""
    entries = _entries(4)
    db = FeatureDatabase(entries, norm=None, pad_multiple=32)
    before = list(db.files)
    calls = {"n": 0}

    def check():
        calls["n"] += 1
        raise Aborted()

    rng = np.random.default_rng(10)
    new = np.abs(0.5 + 0.1 * rng.standard_normal((14, 150))
                 ).astype(np.float32)
    with pytest.raises(Aborted):
        db.add_files([("new.aif", new)], check_aborted=check)
    assert db.files == before and db.num_files == 4


def test_save_load_observer(tmp_path):
    db = FeatureDatabase(_entries(3), norm=None, pad_multiple=32)
    fracs = []
    db.save(tmp_path / "db.npz", progress=fracs.append)
    assert fracs == [0.0, 1.0]
    # the streamed writer stays byte-compatible with np.savez semantics
    z = np.load(tmp_path / "db.npz", allow_pickle=False)
    assert set(z.files) == {"raw", "lens", "norm", "files",
                            "step_size", "num_temporal"}
    np.testing.assert_array_equal(z["raw"], db._raw)
    lfr = []
    db2 = FeatureDatabase.load(tmp_path / "db.npz", progress=lfr.append)
    assert db2.files == db.files and lfr[-1] == 1.0
    with pytest.raises(Aborted):
        db.save(tmp_path / "x.npz",
                check_aborted=lambda: (_ for _ in ()).throw(Aborted()))


def test_save_abort_mid_rows_leaves_no_torn_file(tmp_path):
    """An abort between raw rows must remove the temp file and never
    produce the target path (the atomic temp+rename contract)."""
    db = FeatureDatabase(_entries(3), norm=None, pad_multiple=32)
    calls = []

    def check():
        calls.append(1)
        if len(calls) == 3:          # top-of-save + two rows, then abort
            raise Aborted()

    with pytest.raises(Aborted):
        db.save(tmp_path / "torn.npz", check_aborted=check)
    assert len(calls) == 3           # the abort really fired mid-rows
    leftovers = sorted(p.name for p in tmp_path.iterdir())
    assert leftovers == []           # no target, no .npz.tmp residue
    # overwriting an existing archive aborts without touching it
    db.save(tmp_path / "db.npz")
    before = (tmp_path / "db.npz").read_bytes()
    calls.clear()
    with pytest.raises(Aborted):
        db.save(tmp_path / "db.npz", check_aborted=check)
    assert (tmp_path / "db.npz").read_bytes() == before
