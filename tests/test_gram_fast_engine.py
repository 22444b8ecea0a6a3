"""Fast (resident-stacks, in-jit gather) gram engine vs per-group engine.

The single-device default and the mesh path run the fast engine (the
per-group engine issues ~10 eager dispatches per 8-pair group), leaving
the group engine as the A/B baseline exercised here.  The two are
different compiled programs, so XLA's independent FMA-contraction
choices can scatter results by a few ulp at some shapes — cross-engine
equality is therefore pinned to the plan-invariance budget (≤2e-5),
while bitwise claims stay within one program (device colorize vs host
quantization of the same sims).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from strugatzki_tpu.analysis import self_similarity as SS
from strugatzki_tpu.kernels import corr as K


def _group_engine_matrix(x1, x2, half_win, decim, tw_f, pix=None):
    """The per-group engine run single-device (what _pixel_matrix did
    before round 4's fast engine), via the same write-back loop."""
    n, num_blocks, blocks1, blocks2 = SS._prep_window_blocks(
        x1, x2, half_win, decim)
    tw = jnp.float32(tw_f)
    dtype = np.float32 if pix is None else (
        np.uint8 if pix[2] else np.uint16)
    pairs = [(bi, bj) for bi in range(num_blocks)
             for bj in range(bi, num_blocks)]
    dispatch = lambda ps: SS._dispatch_group(blocks1, blocks2, ps, tw, pix)
    out = np.empty((n, n), dtype)
    for (bi, bj), sims in SS._iter_pair_sims(pairs, dispatch,
                                             SS._PAIR_GROUP):
        r0, c0 = bi * SS._BLOCK, bj * SS._BLOCK
        r1, c1 = min(r0 + SS._BLOCK, n), min(c0 + SS._BLOCK, n)
        s = sims[:r1 - r0, :c1 - c0]
        if bi == bj:
            s = np.triu(s) + np.triu(s, 1).T
            out[r0:r1, c0:c1] = s
        else:
            out[r0:r1, c0:c1] = s
            out[c0:c1, r0:r1] = s.T
    return out


def _x(seed, c, t):
    rng = np.random.default_rng(seed)
    x = np.abs(0.5 + 0.15 * rng.standard_normal((c, t))).astype(np.float32)
    return K.shift_per_group(x)[0]


@pytest.mark.parametrize("t,decim", [(700, 1), (1700, 2)])
def test_fast_matrix_matches_group_engine_plan_budget(t, decim):
    # t=1700/decim=2: extent 831 → 2 blocks (pair padding to 32 exercised);
    # t=700: extent 681 → 2 blocks with a ragged tail block
    x = _x(1, 5, t)
    h = 10
    fast = SS.self_similarity_matrix(x, x, h, decim, 0.5)
    ref = _group_engine_matrix(x, x, h, decim, 0.5)
    assert fast.dtype == np.float32
    np.testing.assert_allclose(fast, ref, atol=2e-5, equal_nan=True)


def test_fast_matrix_cross_mode_and_pix():
    x1 = _x(2, 6, 900)
    x2 = _x(3, 6, 1100)
    h = 12
    fast = SS.self_similarity_matrix(x1, x2, h, 1, 0.3)
    ref = _group_engine_matrix(x1, x2, h, 1, 0.3)
    np.testing.assert_allclose(fast, ref, atol=2e-5, equal_nan=True)

    # within the fast engine the device colorize must be bit-equal to the
    # host quantization of the SAME sims (one gram program feeds both)
    pix = SS._device_pix("psycho", 1.0, 1.0, False)
    assert pix is not None
    fast_p = SS._pixel_matrix(x1, x2, h, 1, 0.3, pix=pix)
    assert fast_p.dtype == np.uint16
    from strugatzki_tpu.util.palette import apply_palette
    np.testing.assert_array_equal(SS._pix_to_rgb(fast_p, False),
                                  apply_palette(np.maximum(fast, 0.0)))


def test_cross_engine_budget_random_configs():
    """Randomized shapes/weights/modes: the engines must agree within the
    plan budget everywhere (STRUG_FUZZ_SEEDS=N soaks more configs; a
    120-config soak measured worst |Δ| = 1.2e-7)."""
    from conftest import FUZZ_SEEDS, FUZZ_BASE, soak_hygiene
    trials = FUZZ_SEEDS or 6
    worst = 0.0
    for trial in range(FUZZ_BASE, FUZZ_BASE + trials):
        soak_hygiene(trial)
        rng = np.random.default_rng(20000 + trial)
        C = int(rng.integers(2, 16))
        T = int(rng.integers(80, 2600))
        h = int(rng.integers(2, min(40, T // 3)))
        decim = int(rng.integers(1, 4))
        tw = float(rng.uniform(0, 1))
        x = _x(300 + trial, C, T)
        if SS._extent(x, x, h, decim) <= 0:
            continue
        fast = SS._pixel_matrix(x, x, h, decim, tw)
        ref = _group_engine_matrix(x, x, h, decim, tw)
        # NaNs must agree cell-for-cell (a NaN-vs-finite divergence is the
        # failure class this guards — nanmax alone would silently drop it)
        assert np.array_equal(np.isnan(fast), np.isnan(ref)), \
            (trial, C, T, h, decim, tw, "NaN mask mismatch")
        d = float(np.nanmax(np.abs(fast - ref))) if fast.size else 0.0
        worst = max(worst, d)
        assert d <= 2e-5, (trial, C, T, h, decim, tw, d)
    assert worst < 2e-5


def test_prep_resident_block_padding():
    # 3 blocks → NSp pads to 4; padded starts repeat the last window start
    x = _x(4, 4, 1400)   # extent 1381 → 3 blocks
    n, nb, res1, res2 = SS._prep_resident(x, x, 10, 1)
    assert (n, nb) == (1381, 3)
    win_all, stats_all, nt = res1
    assert win_all.shape[0] == 4 * SS._BLOCK
    assert stats_all.shape == (4, 4 * SS._BLOCK)
    assert nt == 1
    assert res2 is res1  # self mode shares the stacks
    # the padded tail must hold the last real window, not garbage
    assert np.array_equal(np.asarray(win_all[n - 1]),
                          np.asarray(win_all[-1]))


def test_prep_resident_threads_num_temporal():
    """The nt the stats were computed with rides inside the res tuple, so
    the pair-call program can never blend with a different split (the
    review-pass trap: exposing num_temporal only on the call side lets
    stats and blend silently disagree)."""
    x = _x(5, 6, 800)
    h = 10
    n, _nb, res2t, _ = SS._prep_resident(x, x, h, 1, num_temporal=2)
    assert res2t[2] == 2
    tw = jnp.float32(0.5)
    pairs = [(0, 0)] * SS._PAIRS_PER_CALL
    out2 = np.asarray(SS._dispatch_pairs_fast(res2t, res2t, pairs, tw))
    _, _, res1t, _ = SS._prep_resident(x, x, h, 1)
    out1 = np.asarray(SS._dispatch_pairs_fast(res1t, res1t, pairs, tw))
    assert not np.array_equal(out2, out1)   # the split must matter
    # oracle: the shared block kernel with nt=2 stats on block 0
    starts = np.minimum(np.arange(SS._BLOCK, dtype=np.int64), n - 1)
    win = K.extract_windows(jnp.asarray(x), jnp.asarray(starts), h)
    st = K.window_stats(win, num_temporal=2)
    want = np.asarray(K.gram_similarity_block(win, win, st, st, tw,
                                              num_temporal=2))
    np.testing.assert_array_equal(out2[0], want)


def test_iter_pair_sims_abort_honored_between_fetches():
    # aborts must be honored on every outer iteration, including during
    # the drain of already-dispatched lookahead chunks
    class Aborted(RuntimeError):
        pass

    state = {"abort": False}

    def check():
        if state["abort"]:
            raise Aborted()

    def dispatch(padded):
        return np.zeros((len(padded), 1), np.float32)

    pairs = [(i, i) for i in range(8)]
    it = SS._iter_pair_sims(pairs, dispatch, 2, check_aborted=check)
    assert next(it)[0] == (0, 0)
    assert next(it)[0] == (1, 1)     # finishes chunk 0
    state["abort"] = True
    with pytest.raises(Aborted):
        next(it)                     # chunk 1 was already dispatched
                                     # (lookahead) — abort still honored


def test_iter_pair_sims_lookahead_order():
    # the pipelined iterator must preserve pair order and drop padding
    calls = []

    def dispatch(padded):
        calls.append(list(padded))
        return np.array([[p[0] * 10 + p[1]] for p in padded], np.float32)

    pairs = [(i, j) for i in range(3) for j in range(i, 3)]   # 6 pairs
    got = list(SS._iter_pair_sims(pairs, dispatch, 4))
    assert [p for p, _ in got] == pairs
    assert [float(s[0]) for _, s in got] == [p[0] * 10 + p[1] for p in pairs]
    assert all(len(c) == 4 for c in calls)          # padded chunks
    assert calls[1][-1] == calls[1][-2] == (2, 2)   # tail repeats last pair
