"""Mesh-sharded self-similarity gram + batched/sharded segmentation
novelty over a files mesh.

Both the single-device default and the mesh path run the fast
engine (the mesh variant SPMD: replicated window stacks, pair index
sharded over ``files``).  Single-device and mesh are still DIFFERENT
compiled programs, and XLA contracts their mul→add/sub chains into FMAs
independently, so cross-program sims agree within the plan-invariance
budget (≤2e-5) but not bitwise — 1–32-ulp scatter at some shapes.
Bitwise claims
below are reserved for same-program comparisons: the device colorization
vs the host quantization of the SAME sharded sims, and the streaming PNG
vs the matrix path on the SAME engine."""

import numpy as np

from strugatzki_tpu.analysis.segmentation import (segment_features,
                                                  segment_features_batch)
from strugatzki_tpu.analysis.self_similarity import (
    self_similarity_image, self_similarity_matrix, self_similarity_to_png)
from strugatzki_tpu.config import ColorScheme, SegmentationConfig
from strugatzki_tpu.kernels import corr as K
from strugatzki_tpu.parallel.sweep import (batched_novelty_traces,
                                           make_files_mesh)
from strugatzki_tpu.span import Span


def _prepared(seed, C=14, T=900):
    rng = np.random.default_rng(seed)
    x = np.abs(0.5 + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
    xs, _, _ = K.shift_per_group(x)
    return xs


def test_sharded_gram_matrix_plan_budget():
    xs = _prepared(0)
    mesh = make_files_mesh()
    m1 = self_similarity_matrix(xs, xs, half_win=40, decim=1,
                                temp_weight=0.5)
    m2 = self_similarity_matrix(xs, xs, half_win=40, decim=1,
                                temp_weight=0.5, mesh=mesh)
    assert m1.shape == m2.shape and m1.shape[0] > 512  # multi-block
    np.testing.assert_allclose(m1, m2, atol=2e-5)


def test_sharded_gram_output_genuinely_sharded():
    """The mesh gram program must place one pair slice per device
    (out sharded over the pairs axis) — a silent fallback to replicated
    compute would pass the value tests while scaling at 1×."""
    import jax.numpy as jnp

    import strugatzki_tpu.analysis.self_similarity as SS
    xs = _prepared(6)
    mesh = make_files_mesh()
    ndev = mesh.devices.size
    assert ndev == 8           # conftest forces 8 virtual devices
    tw = jnp.float32(0.5)
    n, nb, res1, res2 = SS._prep_resident(xs, xs, 40, 1, mesh=mesh)
    assert n > 512 and nb >= 2
    # the resident stacks are replicated: every device holds the full copy
    win_all = res1[0]
    assert len(win_all.sharding.device_set) == ndev
    assert win_all.sharding.shard_shape(win_all.shape) == win_all.shape
    pairs = [(i, j) for i in range(nb) for j in range(i, nb)]
    chunk = SS._PAIRS_PER_CALL * ndev
    padded = (pairs + [pairs[-1]] * chunk)[:chunk]
    dev = SS._dispatch_pairs_fast(res1, res2, padded, tw, mesh=mesh)
    shards = dev.addressable_shards
    assert len(shards) == ndev
    assert shards[0].data.shape == (SS._PAIRS_PER_CALL, SS._BLOCK, SS._BLOCK)


def test_sharded_gram_image_device_colorize_bitexact():
    """Under a mesh, the device colorization must still be bit-equal to
    the host quantization of the SAME sharded f32 sims (same gram
    program feeds both paths), for palette and gray schemes."""
    from strugatzki_tpu.analysis.self_similarity import render_image
    xs = _prepared(1)
    mesh = make_files_mesh()
    m = self_similarity_matrix(xs, xs, half_win=30, decim=1,
                               temp_weight=0.5, mesh=mesh)
    img2 = self_similarity_image(xs, xs, half_win=30, decim=1,
                                 temp_weight=0.5, color_ceil=0.9, mesh=mesh)
    np.testing.assert_array_equal(
        img2, render_image(m, "psycho", 1.0, 0.9, False))
    g2 = self_similarity_image(xs, xs, half_win=30, decim=1,
                               temp_weight=0.5,
                               colors=ColorScheme.GRAY_SCALE, mesh=mesh)
    np.testing.assert_array_equal(
        g2, render_image(m, ColorScheme.GRAY_SCALE, 1.0, 1.0, False))


def test_sharded_streaming_png_matches_mesh_matrix(tmp_path):
    """The stripe-streaming PNG under a mesh is byte-identical to
    write_png of the mesh matrix path (same engine, same programs);
    against the single-device fast engine it holds to the plan budget."""
    from strugatzki_tpu.analysis.self_similarity import self_similarity_image
    from strugatzki_tpu.util.png import write_png
    xs = _prepared(2, T=760)
    mesh = make_files_mesh()
    p1 = tmp_path / "mesh_matrix.png"
    p2 = tmp_path / "sharded.png"
    img = self_similarity_image(xs, xs, 30, 1, 0.5, mesh=mesh)
    write_png(p1, img)
    n2 = self_similarity_to_png(xs, xs, 30, 1, 0.5, p2, mesh=mesh)
    assert n2 == img.shape[0] > 512
    assert p1.read_bytes() == p2.read_bytes()
    m1 = self_similarity_matrix(xs, xs, 30, 1, 0.5)
    m2 = self_similarity_matrix(xs, xs, 30, 1, 0.5, mesh=mesh)
    np.testing.assert_allclose(m1, m2, atol=2e-5)


def test_batched_novelty_sharded():
    """A mesh-divisible batch shards bit-identically; a padded batch (6
    files over 8 devices) stays within the plan-invariance budget."""
    rng = np.random.default_rng(3)
    xs_b = np.abs(0.5 + 0.1 * rng.standard_normal((8, 14, 700))
                  ).astype(np.float32)
    mesh = make_files_mesh()
    s1 = batched_novelty_traces(xs_b, 50, 0.5)
    s2 = batched_novelty_traces(xs_b, 50, 0.5, mesh=mesh)
    assert s1.shape == (8, 700 - 100 + 1)
    np.testing.assert_array_equal(s1, s2)     # divisible → bit-identical
    s1p = batched_novelty_traces(xs_b[:6], 50, 0.5)
    s2p = batched_novelty_traces(xs_b[:6], 50, 0.5, mesh=mesh)
    assert s2p.shape == (6, 601)              # padding rows sliced away
    np.testing.assert_allclose(s1p, s2p, atol=2e-5)


def _breaks_close(got, want, atol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.pos == w.pos
        assert abs(g.sim - w.sim) <= atol, (g, w)


def test_segment_batch_matches_per_file():
    """segment_features_batch equals per-file segment_features: break
    positions exactly, sims within the plan budget (the batch shares one
    device width / FFT batch plan); a mesh-divisible batch shards
    bit-identically."""
    rng = np.random.default_rng(4)
    cfg = SegmentationConfig(corr_len=44100, num_breaks=6,
                             min_spacing=22050, temporal_weight=0.5,
                             span=Span()).build()
    feats = [np.abs(0.5 + 0.2 * rng.standard_normal((14, 2000 + 7 * i))
                    ).astype(np.float32) for i in range(8)]
    singles = [segment_features(f, None, 512, cfg) for f in feats]
    batch = segment_features_batch(feats, None, 512, cfg)
    mesh = make_files_mesh()
    batch_m = segment_features_batch(feats, None, 512, cfg, mesh=mesh)
    assert batch == batch_m        # 8 files over 8 devices: bit-identical
    for got, want in zip(batch, singles):
        _breaks_close(got, want)


def test_segment_batch_accepts_generator():
    """A generator input must work: the results list used to be sized by
    re-iterating the (exhausted) input, crashing with IndexError."""
    rng = np.random.default_rng(9)
    cfg = SegmentationConfig(corr_len=44100, num_breaks=3,
                             min_spacing=0, temporal_weight=0.5,
                             span=Span()).build()
    feats = [np.abs(0.5 + 0.2 * rng.standard_normal((14, 900))
                    ).astype(np.float32) for _ in range(3)]
    from_list = segment_features_batch(feats, None, 512, cfg)
    from_gen = segment_features_batch((f for f in feats), None, 512, cfg)
    assert from_gen == from_list and len(from_gen) == 3


def test_segment_batch_empty_and_short_entries():
    """Entries whose span is empty yield []; afLen < winLen yields the
    single zero-padded window, matching segment_features."""
    rng = np.random.default_rng(5)
    cfg = SegmentationConfig(corr_len=44100, num_breaks=3,
                             min_spacing=0, temporal_weight=0.5,
                             span=Span()).build()
    long_f = np.abs(0.5 + 0.2 * rng.standard_normal((14, 800))
                    ).astype(np.float32)
    short_f = np.abs(0.5 + 0.2 * rng.standard_normal((14, 100))
                     ).astype(np.float32)   # < winLen (172)
    empty_f = np.zeros((14, 0), np.float32)
    batch = segment_features_batch([long_f, short_f, empty_f], None, 512,
                                   cfg)
    _breaks_close(batch[0], segment_features(long_f, None, 512, cfg))
    _breaks_close(batch[1], segment_features(short_f, None, 512, cfg))
    assert batch[2] == []
