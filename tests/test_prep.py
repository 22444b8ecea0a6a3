"""Device DB preparation (kernels/prep.py) vs the host reference path
(``normalized`` + ``shift_per_group``)."""

import numpy as np
import jax.numpy as jnp
import pytest

from strugatzki_tpu.analysis.common import normalized
from strugatzki_tpu.kernels import corr as K
from strugatzki_tpu.kernels.prep import prepare_database


def _batch(seed=0, B=5, C=6, T=200, lens=None):
    rng = np.random.default_rng(seed)
    feats = np.abs(0.5 + 0.2 * rng.standard_normal((B, C, T))).astype(np.float32)
    lens = np.array([T, T - 13, T - 50, 77, T] if lens is None else lens,
                    np.int32)
    for i, n in enumerate(lens):
        feats[i, :, n:] = 0.0
    norm = np.stack([feats.min(axis=(0, 2)) - 0.01,
                     feats.max(axis=(0, 2)) + 0.01], axis=1).astype(np.float32)
    return feats, lens, norm


@pytest.mark.parametrize("case", ["ragged", "zero_length", "degenerate_norm",
                                  "identity_norm", "two_temporal"])
def test_prep_matches_host(case):
    """Per file: valid frames equal the host normalize + group shift, the
    temporal shift equals the host's, and the padded tail holds the
    shift-consistent constant (never inf/NaN from the normalization)."""
    lens = [0, 40, 200, 1, 137] if case == "zero_length" else None
    feats, lens, norm = _batch(seed=7, lens=lens)
    nt = 2 if case == "two_temporal" else 1
    if case == "degenerate_norm":
        norm[3] = norm[3, 0]            # a spectral channel with min == max
    if case == "identity_norm":
        norm = None
    out, shifts = prepare_database(feats, norm, lens, num_temporal=nt)
    out, shifts = np.asarray(out), np.asarray(shifts)
    assert out.shape == feats.shape and out.dtype == np.float32
    assert shifts.shape == (feats.shape[0],)
    for i, n in enumerate(lens):
        n = int(n)
        if n == 0:
            assert np.all(out[i] == 0.0) and shifts[i] == 0.0
            continue
        host, sh_t, _ = K.shift_per_group(normalized(feats[i, :, :n], norm),
                                          num_temporal=nt)
        np.testing.assert_allclose(out[i, :, :n], host, atol=2e-6,
                                   equal_nan=True)
        np.testing.assert_allclose(shifts[i], sh_t, atol=2e-6)
        # the temporal group never inherits the spectral group's NaN
        assert np.isfinite(out[i, :nt, :n]).all()
        tail = out[i, :, n:]
        if case != "degenerate_norm":
            assert np.isfinite(tail).all()
        np.testing.assert_allclose(tail[:nt], -shifts[i], atol=0)


def test_prep_sharded_matches_single_device():
    """``sharding=`` (files axis over the virtual mesh) runs the same
    program SPMD: identical values."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from strugatzki_tpu.parallel.sweep import make_files_mesh

    feats, lens, norm = _batch(seed=2, B=8,
                               lens=[200, 3, 0, 199, 77, 200, 150, 9])
    mesh = make_files_mesh(jax.devices()[:4])
    out_s, sh_s = prepare_database(feats, norm, lens,
                                   sharding=NamedSharding(mesh, P("files")))
    out_1, sh_1 = prepare_database(feats, norm, lens)
    np.testing.assert_array_equal(np.asarray(out_s), np.asarray(out_1))
    np.testing.assert_array_equal(np.asarray(sh_s), np.asarray(sh_1))


def test_device_prep_equivalent_to_host_prep():
    """Device prep must yield the same downstream correlations as the host
    normalize+shift path (shifts may differ in f32 rounding — correlation is
    invariant to the shift constant, boost reconstructs via mu+shift)."""
    feats, lens, norm = _batch(seed=3)
    out, shifts = prepare_database(feats, norm, lens)
    out, shifts = np.asarray(out), np.asarray(shifts)

    from strugatzki_tpu.analysis.correlation import InputTemplate

    i = 1
    n = int(lens[i])
    host_x = normalized(feats[i, :, :n], norm)
    tmpl = InputTemplate(host_x[:, 10:60].copy())
    xs_host, sh_host, _ = K.shift_per_group(host_x)

    sims_host, boosts_host = K.correlation_trace(
        jnp.asarray(xs_host), tmpl.device_temporal(), tmpl.device_spectral(),
        jnp.float32(tmpl.temporal_std), jnp.float32(tmpl.spectral_std),
        jnp.float32(tmpl.ln_avg_loudness), jnp.float32(sh_host),
        jnp.float32(0.5), jnp.float32(8.0))
    sims_dev, boosts_dev = K.correlation_trace(
        jnp.asarray(out[i, :, :n]), tmpl.device_temporal(),
        tmpl.device_spectral(),
        jnp.float32(tmpl.temporal_std), jnp.float32(tmpl.spectral_std),
        jnp.float32(tmpl.ln_avg_loudness), jnp.float32(shifts[i]),
        jnp.float32(0.5), jnp.float32(8.0))
    w = n - 50 + 1
    np.testing.assert_allclose(np.asarray(sims_dev)[:w],
                               np.asarray(sims_host)[:w], atol=3e-5)
    np.testing.assert_allclose(np.asarray(boosts_dev)[:w],
                               np.asarray(boosts_host)[:w], rtol=1e-4)


def test_none_norm_identity():
    feats, lens, _ = _batch(seed=5)
    out, _ = prepare_database(feats, None, lens)
    # identity normalization: output = feats - group shift, per file
    i, n = 0, int(lens[0])
    xs_host, _, _ = K.shift_per_group(feats[i, :, :n])
    np.testing.assert_allclose(np.asarray(out)[i, :, :n], xs_host, atol=1e-5)
