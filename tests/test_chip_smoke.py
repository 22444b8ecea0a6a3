"""chip_smoke.py's phases at tiny sizes on the CPU, its refusal to run
without a GPU, and the same refusal in bench.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

TINY = cs.Sizes(catalog_files=4, catalog_secs=6.0, long_secs=12.0,
                mid_secs=8.0, punch_secs=0.5, num_breaks=5, db_files=64,
                db_frames=1200, tmpl_frames=96, queries=4, rescored=16,
                latency_reps=2)


@pytest.fixture(scope="module")
def cli_ctx(tmp_path_factory):
    work = tmp_path_factory.mktemp("smoke")
    return cs.phase_extraction(str(work), TINY, seed=0)


def test_extraction_phase_writes_database(cli_ctx, capsys):
    assert {"a00_feat.aif", "a03_feat.xml",
            "feat_norms.aif"} <= set(os.listdir(cli_ctx["db"]))
    assert {"long_feat.xml", "mid_feat.aif",
            "feat_norms.aif"} <= set(os.listdir(cli_ctx["rec"]))


def test_search_phase_finds_plant(cli_ctx, capsys):
    cs.phase_search(cli_ctx, TINY)
    out = capsys.readouterr().out
    assert "planted match ranks first" in out and "DIFFERENT" not in out


def test_similarity_phase(cli_ctx, capsys):
    info = cs.phase_similarity(cli_ctx, TINY)
    # one backend here, so the "CPU run" reproduces the same bits
    assert info == {"png_identical_to_cpu": True, "png_pixels_differing": 0}
    out = capsys.readouterr().out
    for name in ("long", "steady"):
        assert f"-s {name}: break positions" in out
    assert "ROADMAP B7" in out and "DIFFERENT" not in out


def test_kernel_phase(cli_ctx, capsys):
    cs.phase_kernels(cli_ctx, TINY)
    out = capsys.readouterr().out
    for name in ("correlation_trace", "novelty_trace",
                 "gram_similarity_block", "fast pair engine"):
        assert name in out
    assert "FAIL" not in out


def test_serving_phase(capsys):
    cs.phase_serving(TINY, seed=0, card="test")
    out = capsys.readouterr().out
    for mode in ("[complex64]", "[bf16]"):
        assert f"{mode} query repeated, bit-identical" in out
        assert f"{mode} planted query_punch_batch |sim-1|" in out
    assert "[bf16] planted query[raw]" in out


@pytest.mark.parametrize("limit,kinds", [
    (None, ("f32",)), (4096, ("re-scored",)),
    (40, ("re-scored", "raw"))])
def test_rescore_sample_holds_each_kind(monkeypatch, capsys, limit, kinds):
    """Each re-scored hit is held to 1e-5 and each raw bf16 hit to 4e-3;
    a small ``RERANK_LIMIT`` leaves files with raw and mixed hits."""
    from strugatzki_tpu.parallel import canary
    from strugatzki_tpu.parallel.database import FeatureDatabase

    layout = canary.planted_layout(64, 1200, 4, 96, 48, 0)
    db = FeatureDatabase(layout["entries"], norm=None,
                         cache_spectra=True if limit is None else "bf16")
    if limit is not None:
        monkeypatch.setattr(FeatureDatabase, "RERANK_LIMIT", limit)
    tmpl = layout["tmpls"][0]
    res = db.query(tmpl, k=2)
    cs.rescore_sample(db, res, tmpl, "t", 8, layout["planted"][0][0],
                      np.random.default_rng(1))
    out = capsys.readouterr().out
    assert "FAIL" not in out
    for kind in kinds:
        assert f"] {kind} query hits vs f64" in out
    if limit == 40:
        assert " 0 mixed" not in out and "mixed" in out


def test_four_path_on_virtual_mesh(capsys):
    """The --four stages over 4 of the virtual CPU devices (file count as
    the canary's: XLA:CPU refuses some smaller batched FFT layouts)."""
    sizes = cs.Sizes(catalog_files=4, catalog_secs=6.0, long_secs=12.0,
                     mid_secs=8.0, punch_secs=0.5, db_files=256,
                     db_frames=1200, tmpl_frames=96, queries=8)
    cs.four_path(sizes, seed=0)
    out = capsys.readouterr().out
    assert "self_similarity_matrix(mesh=)" in out and "FAIL" not in out


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cs.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code not in (0, None)
    assert "{" not in capsys.readouterr().out


def test_bench_input_shape():
    import bench

    audios = bench.pcm16_batch()
    assert len(audios) == bench.FILES
    assert all(a.dtype == np.int16 and a.shape == (int(44100 * 120),)
               for a in audios)


@pytest.mark.parametrize("worst,tol,ok", [
    (0.0, 1e-5, True), (1e-5, 1e-5, True), (2e-5, 1e-5, False),
    (float("nan"), 1e-5, False), (float("inf"), 1e-5, False)])
def test_check_verdict(worst, tol, ok, capsys):
    if ok:
        cs.check("x", worst, tol)
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.check("x", worst, tol)
    assert ("PASS" if ok else "FAIL") in capsys.readouterr().out


@pytest.mark.parametrize("a,b,dev", [
    ([1.0, np.nan], [1.0, np.nan], 0.0),
    ([np.inf, -np.inf], [np.inf, -np.inf], 0.0),
    ([np.nan], [1.0], np.inf),
    ([1.0, 2.0], [1.0], np.inf),
    ([1.0, 2.0], [1.5, 2.0], 0.5)])
def test_max_dev(a, b, dev):
    assert cs.max_dev(a, b) == dev


def test_result_line():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    got = json.loads(cs.result_line([Dev()] * 4))
    assert got == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.gpu
def test_tiny_phases_on_gpu(gpu_card, tmp_path):
    """Phases 1-5 at the tiny sizes with the GPU as the default device, so
    every CPU comparison really crosses backends; in a child process,
    because this one is held to the CPU."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, tempfile, chip_smoke as cs\n"
        "from strugatzki_tpu.runtime.platform import require_gpu\n"
        "require_gpu()\n"
        f"t = cs.Sizes(**{TINY.__dict__!r})\n"
        "with tempfile.TemporaryDirectory() as w:\n"
        "    ctx = cs.phase_extraction(w, t, 0)\n"
        "    cs.phase_search(ctx, t)\n"
        "    cs.phase_similarity(ctx, t)\n"
        "    cs.phase_kernels(ctx, t)\n"
        "cs.phase_serving(t, 0, 'gpu test')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
