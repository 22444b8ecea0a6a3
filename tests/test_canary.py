"""The standing planted-match canary for the batched kernels (detector
of silently deflated batched sims — strugatzki_tpu/parallel/canary.py).

CPU is exact at every shape, so the canary must PASS here with rounding-
level deviations; a simulated deflation must flip it to FAIL.  The shape
maths is pinned so the canary keeps exercising the CHUNKED kernel path
(the production mitigation) rather than degenerating to a plain vmap.
"""

import numpy as np
import pytest

from strugatzki_tpu.parallel import canary
from strugatzki_tpu.parallel import database as DBM


@pytest.fixture(scope="module")
def report():
    return canary.run_batch_canary()


def test_canary_passes_on_cpu(report):
    assert report["pass"], canary.format_report(report)
    assert report["frames_ok"]
    # rounding-level only: orders of magnitude inside the verdict tolerance
    assert report["worst"] < 1e-5
    assert set(report["families"]) == {
        "query_batch", "query_punch_batch", "query", "query_punch"}


def test_canary_shapes_take_the_chunked_path():
    """The canary exists to validate the chunked kernels at the per-step
    lane budget; if a default drifts (shape, pad multiple, budget) until
    the whole batch fits one step, it would silently stop testing the
    mitigation."""
    B = 512                       # 256 files padded to pad_multiple=512
    for lanes in (8, 16):         # Q (query), 2·Q (punch)
        bc = max(1, DBM._VALIDATED_QB_BATCH // lanes)
        bc = 1 << (bc.bit_length() - 1)
        assert bc < B, (lanes, bc, B)
        assert lanes * bc <= DBM._VALIDATED_QB_BATCH


def test_canary_passes_on_virtual_mesh():
    """The canary's --mesh mode (the staged hardware validation for any
    future scaled-budget restoration) must pass on the virtual 8-device
    mesh — this also drives the mesh × chunked-files combination through
    the production batched kernels at the canary shapes."""
    from strugatzki_tpu.parallel.sweep import make_files_mesh

    report = canary.run_batch_canary(mesh=make_files_mesh())
    assert report["pass"], canary.format_report(report)
    assert report["worst"] < 1e-5


def test_canary_compact_mode_checks_raw_trace():
    """The compact (bf16 spectra + window-sum table) mode must check BOTH
    the re-ranked results (exact, tol 1e-4) and the raw sums-trace sims
    (re-rank off, reduced tol) — the raw check is what detects a uniform
    trace deflation the exact re-rank would mask."""
    report = canary.run_batch_canary(cache_spectra="bf16")
    assert report["pass"], canary.format_report(report)
    fams = set(report["families"])
    assert {"query", "query_batch", "query_punch",
            "query_punch_batch"} <= fams
    raw = {f for f in fams if f.endswith("[raw]")}
    assert len(raw) == 4
    for f in raw:
        assert report["tols"][f] == canary.REDUCED_TOLERANCE
        # bf16 quantization noise is real on CPU too: nonzero but inside
        # the reduced tolerance and ABOVE the exact families' level
        assert report["families"][f] <= canary.REDUCED_TOLERANCE
    for f in fams - raw:
        assert report["tols"][f] == canary.TOLERANCE
        assert report["families"][f] < 1e-5


def test_canary_compact_fails_on_raw_deflation(monkeypatch):
    """A uniform deflation visible only before the re-rank (the fault's
    signature on the compact path) must still flip the verdict."""
    orig = DBM.FeatureDatabase.query_batch

    def deflated(self, *a, **kw):
        out = orig(self, *a, **kw)
        if kw.get("exact_rerank") is False:   # raw pass only
            for r in out:
                r.sims = np.asarray(r.sims) * 0.95
        return out

    monkeypatch.setattr(DBM.FeatureDatabase, "query_batch", deflated)
    report = canary.run_batch_canary(cache_spectra="bf16")
    assert not report["pass"]
    assert report["families"]["query_batch[raw]"] > canary.REDUCED_TOLERANCE
    assert report["families"]["query_batch"] < 1e-5


def test_canary_fails_on_deflated_sims(monkeypatch):
    """Scale every batched-query sim by the observed fault factor and the
    canary must FAIL."""
    orig = DBM.FeatureDatabase.query_batch

    def deflated(self, *a, **kw):
        out = orig(self, *a, **kw)
        for r in out:
            r.sims = np.asarray(r.sims) * 0.95
        return out

    monkeypatch.setattr(DBM.FeatureDatabase, "query_batch", deflated)
    report = canary.run_batch_canary()
    assert not report["pass"]
    assert report["families"]["query_batch"] > canary.TOLERANCE
    # the untouched families still read clean
    assert report["families"]["query_punch_batch"] < 1e-5


def test_canary_fails_on_wrong_frames(monkeypatch):
    orig = DBM.FeatureDatabase.query_punch_batch

    def shifted(self, *a, **kw):
        out = orig(self, *a, **kw)
        for r in out:
            r.frames = np.asarray(r.frames) + 1
        return out

    monkeypatch.setattr(DBM.FeatureDatabase, "query_punch_batch", shifted)
    report = canary.run_batch_canary()
    assert not report["pass"]
    assert not report["frames_ok"]
