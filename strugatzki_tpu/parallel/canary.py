"""Standing planted-match canary for the batched serving kernels.

A batched trace program can return silently deflated sims on a backend
whose compiler mishandles one of its shapes (the files axis is chunked to
a validated lane budget per fused step for that reason,
:func:`.database._chunked_files_vmap`).  Such a fault is invisible on
CPU, so this module is the standing detector: it plants exact matches
(the reference's own ``correlate(a, a) == 1`` guarantee,
impl/MathUtil.scala:195) and pushes them through the PRODUCTION batched
query and punch kernels, asserting every planted sim returns 1.0.  The
GPU run of ``chip_smoke.py`` runs it at the 10k-file serving size; this
canary on the card decides whether the chunking guard is still needed.

    python tools/batch_canary.py          # exits non-zero on FAIL

The default shapes make both batched kernels take the CHUNKED path at
precisely the validated budget boundary:

* query: Q=8 templates → ``bc = 1024/8 = 128`` files per step over
  B=256 files (2 chunks), 8·128 = 1024 trace lanes per fused step;
* punch: 2·Q=16 lanes/file → ``bc = 64`` (4 chunks), 16·64 = 1024 lanes.

A deflation shows up as ``|sim − 1| ≳ 1e-2``; FFT-formulation rounding is
orders of magnitude smaller, so the 1e-4 verdict threshold separates them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["run_batch_canary", "planted_layout", "check_planted",
           "format_report"]

#: FAIL when any planted sim deviates from 1.0 by more than this.  A
#: deflation fault is ≥ 1e-2; kernel rounding is far below — see module doc.
TOLERANCE = 1e-4

#: Tolerance for the RAW device sims of the reduced (compact) spectra
#: cache with the exact re-rank disabled: bf16 spectra quantization puts
#: ~1e-3 noise on the trace, still an order below the ≥ 1e-2 deflation
#: fault.  (The re-ranked results are held to :data:`TOLERANCE`.)
REDUCED_TOLERANCE = 4e-3


def planted_layout(n_files: int = 256, file_frames: int = 1200,
                   num_queries: int = 8, l_in: int = 96, l_out: int = 48,
                   seed: int = 0) -> dict:
    """Synthetic features with planted query templates and punch pairs.

    Returns a dict: ``entries`` (``(name, [14, file_frames])`` pairs),
    ``tmpls``, ``pairs`` (``(in, out, min_punch, max_punch)``),
    ``planted`` (``(file, frame)`` per query) and ``d_punch``.  Pure
    function of ``seed``."""
    from ..analysis.correlation import InputTemplate

    rng = np.random.default_rng(seed)
    base = rng.uniform(0.3, 0.7, size=(n_files, 14, 1)).astype(np.float32)
    # in place, float32 throughout: the 10k-file size is ~6 GB
    feats = rng.standard_normal((n_files, 14, file_frames), dtype=np.float32)
    feats *= np.float32(0.1)
    feats += base
    np.abs(feats, out=feats)
    entries = [(f"f{i}.aif", feats[i]) for i in range(n_files)]

    # plant query templates and punch pairs in distinct, non-adjacent files
    # spread across the chunk boundaries (file q·stride), each at a
    # query-distinct offset so a frame collision can't mask a wrong index
    stride = max(1, n_files // max(1, num_queries) - 1)
    o_in = 100
    o_out = o_in + 2 * l_in + 200              # punch distance D = o_out−o_in
    d_punch = o_out - o_in
    min_punch, max_punch = d_punch - 50, d_punch + 50
    if o_out + l_out + num_queries >= file_frames:
        raise ValueError("file_frames too short for the planted layout")
    tmpls, pairs, planted = [], [], []
    for q in range(num_queries):
        f = (q * stride + 1) % n_files
        src = feats[f]
        tmpls.append(InputTemplate(src[:, o_in + q:o_in + q + l_in].copy()))
        pairs.append((tmpls[-1],
                      InputTemplate(src[:, o_out + q:o_out + q + l_out]
                                    .copy()),
                      min_punch, max_punch))
        planted.append((f, o_in + q))
    return {"entries": entries, "tmpls": tmpls, "pairs": pairs,
            "planted": planted, "d_punch": d_punch}


def check_planted(db, layout: dict) -> dict:
    """Run the production batched and Q=1 kernels of ``db`` (staged from
    ``layout["entries"]``) on the planted templates, and report.

    Returns a dict: ``pass`` (bool), ``worst`` (max ``|sim − 1|`` over
    every planted hit across all four kernel families), per-family worsts
    and tolerances, and ``frames_ok`` (every planted hit surfaced at its
    planted offset)."""
    tmpls, pairs = layout["tmpls"], layout["pairs"]
    planted, d_punch = layout["planted"], layout["d_punch"]
    min_punch, max_punch = pairs[0][2], pairs[0][3]
    report = {"families": {}, "tols": {}, "frames_ok": True}

    def record(name: str, devs, frames_ok: bool,
               tol: float = TOLERANCE) -> None:
        report["families"][name] = float(np.max(devs))
        report["tols"][name] = tol
        report["frames_ok"] = report["frames_ok"] and frames_ok

    def run_families(suffix: str = "", tol: float = TOLERANCE,
                     **kw) -> None:
        # -- batched query -------------------------------------------------
        qb = db.query_batch(tmpls, k=2, **kw)
        devs, f_ok = [], True
        for q, (f, off) in enumerate(planted):
            devs.append(abs(float(qb[q].sims[f, 0]) - 1.0))
            f_ok &= int(qb[q].frames[f, 0]) == off
        record("query_batch" + suffix, devs, f_ok, tol)

        # -- batched punch (2·Q lanes per file — the harder regime) --------
        pb = db.query_punch_batch(pairs, k=2, **kw)
        devs, f_ok = [], True
        for q, (f, off) in enumerate(planted):
            devs.append(abs(float(pb[q].sims[f, 0]) - 1.0))
            # punch_lens is the matched length − min_punch
            f_ok &= (int(pb[q].frames[f, 0]) == off
                     and min_punch + int(pb[q].punch_lens[f, 0]) == d_punch)
        record("query_punch_batch" + suffix, devs, f_ok, tol)

        # -- Q=1 serving kernels (absolute ground truth for the same DB) ---
        sq = db.query(tmpls[0], k=2, **kw)
        f0, off0 = planted[0]
        record("query" + suffix, [abs(float(sq.sims[f0, 0]) - 1.0)],
               int(sq.frames[f0, 0]) == off0, tol)
        sp = db.query_punch(pairs[0][0], pairs[0][1], min_punch=min_punch,
                            max_punch=max_punch, k=2, **kw)
        record("query_punch" + suffix, [abs(float(sp.sims[f0, 0]) - 1.0)],
               int(sp.frames[f0, 0]) == off0
               and min_punch + int(sp.punch_lens[f0, 0]) == d_punch, tol)

    run_families()
    if db._spectra_reduced:
        # Reduced (compact) cache: the default runs above went through the
        # exact re-rank (sims restored to rounding level, tol 1e-4) —
        # which would mask a UNIFORM trace deflation, since deflated-but-
        # correctly-ranked candidates re-rank to exact 1.0.  So also check
        # the raw device trace sims (re-rank off) at the reduced tolerance:
        # bf16 spectra quantization is ~1e-3, the fault deflates ≥ 1e-2.
        run_families(suffix="[raw]", tol=REDUCED_TOLERANCE,
                     exact_rerank=False)

    report["worst"] = max(report["families"].values())
    report["pass"] = bool(report["frames_ok"] and all(
        report["families"][k] <= report["tols"][k]
        for k in report["families"]))
    return report


def run_batch_canary(n_files: int = 256, file_frames: int = 1200,
                     num_queries: int = 8, l_in: int = 96, l_out: int = 48,
                     seed: int = 0, cache_spectra=False,
                     mesh=None) -> dict:
    """Plant exact matches, stage them, run the production batched kernels
    and report (:func:`check_planted`).  ~40 MB of synthetic features at
    the default shapes; no files touched."""
    from .database import FeatureDatabase

    layout = planted_layout(n_files, file_frames, num_queries, l_in, l_out,
                            seed)
    db = FeatureDatabase(layout["entries"], norm=None,
                         cache_spectra=cache_spectra, mesh=mesh)
    return check_planted(db, layout)


def format_report(report: dict) -> str:
    """One status line: ``batch-kernel canary: PASS/FAIL ...``."""
    tols = report.get("tols", {})
    fams = ", ".join(f"{k} |Δ|={v:.2e}"
                     for k, v in sorted(report["families"].items()))
    verdict = "PASS" if report["pass"] else "FAIL"
    extra = "" if report["frames_ok"] else "; PLANTED FRAMES WRONG"
    raw_tols = sorted({t for k, t in tols.items() if k.endswith("[raw]")})
    raw = f"; raw tol {raw_tols[0]:g}" if raw_tols else ""
    return (f"batch-kernel canary: {verdict} worst |sim-1|="
            f"{report['worst']:.2e} (tol {TOLERANCE:g}{raw}) [{fams}]"
            f"{extra}")
