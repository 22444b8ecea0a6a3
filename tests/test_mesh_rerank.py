"""Device exact re-rank on a mesh-sharded database.

Round 4's device re-rank was gated to single-device f32 databases; under
a mesh — exactly the configuration whose capacity story needs it — every
reduced-precision query fell back to seconds of host-f64 re-scoring.  The
SPMD program (:func:`database._sharded_rerank_fn`) now scores each
candidate on the shard that owns its row and merges the tiny [M] vectors
with one psum.  These tests pin parity against BOTH oracles on the
virtual 8-device mesh: the host f64 mirror and the single-device kernel.
"""

import numpy as np
import pytest

from strugatzki_tpu.analysis.correlation import InputTemplate
from strugatzki_tpu.parallel.database import FeatureDatabase
from strugatzki_tpu.parallel.sweep import make_files_mesh


def _entries(seed, n, T=200, C=6):
    rng = np.random.default_rng(seed)
    return [(f"r{seed}_{i}.aif",
             np.abs(0.5 + 0.2 * rng.standard_normal((C, T))).astype(
                 np.float32)) for i in range(n)]


@pytest.fixture(scope="module")
def mesh_db_pair():
    ents = _entries(7, 13)          # 13 over 8 devices: pad-and-trim case
    norm = np.stack([np.full(6, 0.05, np.float32),
                     np.full(6, 1.6, np.float32)], axis=1)
    mesh = make_files_mesh()
    db_m = FeatureDatabase(ents, norm, pad_multiple=32, mesh=mesh)
    db_s = FeatureDatabase(ents, norm, pad_multiple=32)
    return ents, db_m, db_s


def test_mesh_f32_is_rerank_eligible(mesh_db_pair):
    _, db_m, db_s = mesh_db_pair
    assert db_m._rerank_device and db_s._rerank_device


def test_mesh_device_scores_match_host_mirror(mesh_db_pair):
    ents, db_m, _ = mesh_db_pair
    tmpl = InputTemplate(ents[9][1][:, 40:100].copy())
    rng = np.random.default_rng(3)
    fi = rng.integers(0, len(ents), 37).astype(np.int32)
    fr = rng.integers(0, 200 - 60, 37).astype(np.int32)
    dev = db_m._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    host = db_m._exact_window_scores(fi, fr, tmpl, 0.5, 8.0)
    np.testing.assert_allclose(dev[0], host[0], atol=2e-5)
    np.testing.assert_allclose(dev[1], host[1], rtol=2e-5)


def test_mesh_device_scores_match_single_device(mesh_db_pair):
    ents, db_m, db_s = mesh_db_pair
    tmpl = InputTemplate(ents[2][1][:, 10:90].copy())
    fi = np.arange(13, dtype=np.int32)
    fr = np.full(13, 5, np.int32)
    m = db_m._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    s = db_s._device_window_scores(fi, fr, tmpl, 0.5, 8.0)
    # different programs (SPMD vs single-device) — plan-invariance budget
    np.testing.assert_allclose(m[0], s[0], atol=2e-5)
    np.testing.assert_allclose(m[1], s[1], rtol=2e-5)


def test_mesh_query_exact_rerank_matches_single(mesh_db_pair):
    ents, db_m, db_s = mesh_db_pair
    tmpl = InputTemplate(ents[4][1][:, 60:140].copy())
    rm = db_m.query(tmpl, k=3, exact_rerank=True)
    rs = db_s.query(tmpl, k=3, exact_rerank=True)
    order = np.argsort(rm.files)
    np.testing.assert_allclose(
        np.nan_to_num(np.asarray(rm.sims)[order], neginf=0),
        np.nan_to_num(np.asarray(rs.sims)[np.argsort(rs.files)], neginf=0),
        atol=2e-5)
    # the planted self-match must surface exactly
    assert float(np.asarray(rm.sims)[4, 0]) == pytest.approx(1.0, abs=1e-5)
    assert int(np.asarray(rm.frames)[4, 0]) == 60


def test_mesh_reduced_storage_recovers_exact_results():
    """bf16 storage on a mesh is the configuration that used to pay the
    host fallback; it must now auto-use the device re-rank — but bf16
    features are ineligible (not exact), so the HOST mirror must still
    run: eligibility is about dtype, not mesh."""
    import jax.numpy as jnp

    ents = _entries(11, 9)
    mesh = make_files_mesh()
    db = FeatureDatabase(ents, norm=None, pad_multiple=32, mesh=mesh,
                         storage_dtype=jnp.bfloat16)
    assert not db._rerank_device          # bf16 resident: host mirror
    with pytest.raises(ValueError):
        FeatureDatabase(ents, norm=None, pad_multiple=32, mesh=mesh,
                        storage_dtype=jnp.bfloat16, rerank_device=True)
    tmpl = InputTemplate(ents[3][1][:, 20:80].copy())
    res = db.query(tmpl, k=2)             # exact_rerank defaults on
    assert float(np.asarray(res.sims)[3, 0]) == pytest.approx(1.0, abs=1e-6)


def test_mesh_rerank_vs_host_mirror_fuzz():
    """Randomized differential soak: the SPMD mesh re-rank vs the host
    f64 mirror at random database/template/candidate shapes (plan
    budget).  STRUG_FUZZ_SEEDS=N scales it; STRUG_FUZZ_BASE shifts the
    window (tests/conftest.py)."""
    from conftest import FUZZ_BASE, FUZZ_SEEDS, soak_hygiene

    mesh = make_files_mesh()
    for seed in range(FUZZ_BASE, FUZZ_BASE + (FUZZ_SEEDS or 3)):
        soak_hygiene(seed)
        rng = np.random.default_rng(seed + 9000)
        n = int(rng.integers(2, 20))
        C = int(rng.integers(2, 15))
        T = int(rng.integers(60, 400))
        nt = int(rng.integers(1, min(3, C - 1) + 1))
        ents = [(f"z{i}.aif",
                 np.abs(0.4 + 0.25 * rng.standard_normal((C, T)))
                 .astype(np.float32)) for i in range(n)]
        norm = None
        if rng.random() < 0.5:
            norm = np.stack([np.full(C, 0.02, np.float32),
                             np.full(C, 1.8, np.float32)], axis=1)
        db = FeatureDatabase(ents, norm, pad_multiple=32, mesh=mesh,
                             num_temporal=nt)
        L = int(rng.integers(4, T - 4))
        src = int(rng.integers(0, n))
        o = int(rng.integers(0, T - L))
        block = ents[src][1][:, o:o + L].astype(np.float32).copy()
        if norm is not None:            # reference normalize: (x−min)/range
            block = ((block - norm[:, 0:1])
                     / (norm[:, 1:2] - norm[:, 0:1])).astype(np.float32)
        tmpl = InputTemplate(block, num_temporal=nt)
        m = int(rng.integers(1, 40))
        fi = rng.integers(0, n, m).astype(np.int32)
        fr = rng.integers(0, T - L + 1, m).astype(np.int32)
        tw = float(rng.uniform(0.0, 1.0))
        dev = db._device_window_scores(fi, fr, tmpl, tw, 8.0)
        host = db._exact_window_scores(fi, fr, tmpl, tw, 8.0)
        np.testing.assert_allclose(dev[0], host[0], atol=2e-5,
                                   err_msg=f"seed {seed}")
        np.testing.assert_allclose(dev[1], host[1], rtol=2e-5,
                                   err_msg=f"seed {seed}")


def test_mesh_f32_spectra_cache_uses_device_rerank(mesh_db_pair):
    """cache_spectra='bf16' on an f32 mesh database: reduced spectra force
    the exact re-rank, and it must run the SPMD device program (f32
    features are the re-rank source, so eligibility holds)."""
    ents, _, db_s = mesh_db_pair
    mesh = make_files_mesh()
    norm = np.stack([np.full(6, 0.05, np.float32),
                     np.full(6, 1.6, np.float32)], axis=1)
    db = FeatureDatabase(ents, norm, pad_multiple=32, mesh=mesh,
                         cache_spectra="bf16")
    assert db._rerank_device
    tmpl = InputTemplate(ents[6][1][:, 30:110].copy())
    rm = db.query(tmpl, k=2)              # auto exact re-rank (reduced)
    rs = db_s.query(tmpl, k=2, exact_rerank=True)
    assert float(np.asarray(rm.sims)[6, 0]) == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(
        np.nan_to_num(np.asarray(rm.sims), neginf=0),
        np.nan_to_num(np.asarray(rs.sims), neginf=0), atol=2e-5)
