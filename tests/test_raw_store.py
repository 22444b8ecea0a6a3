"""Memmap-backed raw feature store: staging from a
one-shot generator keeps host RSS O(one file); every serving surface —
queries, exact re-ranks (host + device), incremental updates, restage,
save/load — works unchanged on the disk-backed store."""

import numpy as np
import pytest

from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel.database import FeatureDatabase


def _entries(n=6, seed=0, T=180):
    rng = np.random.default_rng(seed)
    return [(f"f{i}.aif",
             np.abs(0.5 + 0.1 * rng.standard_normal((14, T + 9 * i))
                    ).astype(np.float32)) for i in range(n)]


def test_memmap_matches_memory():
    entries = _entries()
    tmpl = InputTemplate(entries[3][1][:, 40:90].copy())
    db_m = FeatureDatabase(entries, norm=None, pad_multiple=32)
    db_f = FeatureDatabase(entries, norm=None, pad_multiple=32,
                           raw_store="memmap")
    assert isinstance(db_f._raw, np.memmap)
    r1 = db_m.query(tmpl, k=2)
    r2 = db_f.query(tmpl, k=2)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-6)
    # host exact re-rank gathers windows from the memmap
    h1 = db_m._exact_window_scores(np.array([3]), np.array([40]), tmpl,
                                   0.5, 8.0)
    h2 = db_f._exact_window_scores(np.array([3]), np.array([40]), tmpl,
                                   0.5, 8.0)
    np.testing.assert_array_equal(h1[0], h2[0])


def test_memmap_generator_entries_with_capacity():
    """A one-shot generator stages when time_capacity bounds the frames —
    the streaming mode that keeps a 10k build at O(one file) RSS."""
    entries = _entries(5)

    def gen():
        yield from entries

    db = FeatureDatabase(gen(), norm=None, pad_multiple=32,
                         raw_store="memmap", time_capacity=250)
    assert db.files == [n for n, _ in entries]
    tmpl = InputTemplate(entries[2][1][:, 10:60].copy())
    assert db.query(tmpl, k=1).frames[2, 0] == 10


def test_memmap_capacity_validation():
    entries = _entries(3)
    with pytest.raises(ValueError, match="capacity"):
        FeatureDatabase(iter(entries), norm=None, pad_multiple=32,
                        raw_store="memmap", time_capacity=64)
    with pytest.raises(ValueError, match="raw_store"):
        FeatureDatabase(entries, norm=None, raw_store="mmap")


def test_memmap_incremental_and_restage():
    entries = _entries(5)
    db = FeatureDatabase(entries, norm=None, pad_multiple=32,
                         raw_store="memmap")
    db.remove_files(["f1.aif"])
    rng = np.random.default_rng(7)
    new = np.abs(0.5 + 0.1 * rng.standard_normal((14, 150))
                 ).astype(np.float32)
    db.add_files([("new.aif", new)])          # fills the tombstone
    assert db.files[1] == "new.aif"
    tmpl = InputTemplate(new[:, 30:70].copy())
    assert db.query(tmpl, k=1).frames[1, 0] == 30
    # longer than capacity → restage; the store stays memmap-backed
    big = np.abs(0.5 + 0.1 * rng.standard_normal((14, 1200))
                 ).astype(np.float32)
    db.add_files([("big.aif", big)])
    assert db._raw_store == "memmap" and isinstance(db._raw, np.memmap)
    assert "big.aif" in db.files
    tb = InputTemplate(big[:, 500:560].copy())
    res = db.query(tb, k=1)
    assert res.frames[db.files.index("big.aif"), 0] == 500


def test_memmap_save_load(tmp_path):
    entries = _entries(4)
    db = FeatureDatabase(entries, norm=None, pad_multiple=32,
                         raw_store="memmap")
    db.save(tmp_path / "db.npz", compresslevel=1)
    db2 = FeatureDatabase.load(tmp_path / "db.npz")
    assert db2.files == db.files
    tmpl = InputTemplate(entries[1][1][:, 20:60].copy())
    np.testing.assert_array_equal(db.query(tmpl, k=1).frames,
                                  db2.query(tmpl, k=1).frames)


def test_memmap_streamed_load(tmp_path):
    """load(raw_store="memmap") streams the archive row-wise into the
    disk-backed store: raw bytes, lens, norm, files, and query results
    all equal the materializing load path."""
    entries = _entries(5, seed=3)
    norm = np.stack([np.full(14, 0.1, np.float32),
                     np.full(14, 1.2, np.float32)], axis=1)
    db = FeatureDatabase(entries, norm=norm, pad_multiple=32)
    db.save(tmp_path / "db.npz")
    db_mem = FeatureDatabase.load(tmp_path / "db.npz")
    db_mm = FeatureDatabase.load(tmp_path / "db.npz", raw_store="memmap")
    assert isinstance(db_mm._raw, np.memmap)
    assert db_mm._raw_store == "memmap"
    assert db_mm.files == db_mem.files == [n for n, _ in entries]
    assert db_mm.step_size == db_mem.step_size
    np.testing.assert_array_equal(db_mm._lens, db_mem._lens)
    np.testing.assert_array_equal(np.asarray(db_mm._raw), db_mem._raw)
    np.testing.assert_array_equal(db_mm.norm, norm)
    tmpl = InputTemplate(entries[2][1][:, 15:65].copy())
    r1, r2 = db_mem.query(tmpl, k=2), db_mm.query(tmpl, k=2)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-6)


def test_memmap_streamed_load_reads_plain_savez(tmp_path):
    """Archives written by np.savez_compressed itself (the pre-streaming
    writer, same member layout) stream-load into the memmap store."""
    entries = _entries(3, seed=9)
    db = FeatureDatabase(entries, norm=None, pad_multiple=32)
    np.savez_compressed(
        tmp_path / "old.npz", raw=db._raw, lens=db._lens,
        norm=np.zeros((0, 2), np.float32),
        files=np.array(db.files), step_size=db.step_size)
    db2 = FeatureDatabase.load(tmp_path / "old.npz", raw_store="memmap")
    assert isinstance(db2._raw, np.memmap) and db2.files == db.files
    np.testing.assert_array_equal(np.asarray(db2._raw), db._raw)


def test_memmap_streamed_load_pads_and_aborts(tmp_path, monkeypatch):
    """The streamed load pre-pads the files axis to the chunk multiple
    (the constructor's re-pad must be a no-op — a concatenate would
    materialize the store) and honors abort mid-stream."""
    from strugatzki_tpu.parallel import database as D
    entries = _entries(6, seed=1)
    FeatureDatabase(entries, norm=None, pad_multiple=32).save(
        tmp_path / "db.npz")
    monkeypatch.setattr(D, "_QUERY_CHUNK", 4)
    db = FeatureDatabase.load(tmp_path / "db.npz", raw_store="memmap")
    assert isinstance(db._raw, np.memmap)          # no concatenate re-pad
    assert db._raw.shape[0] == 8 and len(db.files) == 6
    assert list(db._lens[6:]) == [0, 0]
    tmpl = InputTemplate(entries[4][1][:, 30:80].copy())
    assert db.query(tmpl, k=1).frames[4, 0] == 30

    calls = []

    def abort():
        calls.append(1)
        if len(calls) > 3:
            raise RuntimeError("aborted")

    with pytest.raises(RuntimeError, match="aborted"):
        FeatureDatabase.load(tmp_path / "db.npz", raw_store="memmap",
                             check_aborted=abort)


def test_memmap_chunked_staging(monkeypatch):
    """Slab-chunked staging from a memmap store (the 10k path: per-slab
    forced drain + MADV_DONTNEED) must produce the same results as the
    in-memory store."""
    from strugatzki_tpu.parallel import database as D
    entries = _entries(9)
    monkeypatch.setattr(D, "_QUERY_CHUNK", 4)
    db_m = FeatureDatabase(entries, norm=None, pad_multiple=32)
    db_f = FeatureDatabase(entries, norm=None, pad_multiple=32,
                           raw_store="memmap")
    tmpl = InputTemplate(entries[6][1][:, 40:90].copy())
    r1 = db_m.query(tmpl, k=2)
    r2 = db_f.query(tmpl, k=2)
    np.testing.assert_array_equal(r1.frames, r2.frames)
    np.testing.assert_allclose(r1.sims, r2.sims, atol=1e-6)
