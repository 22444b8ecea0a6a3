"""Fused feature-database preparation (plain XLA).

Staging a database for resident serving requires, per file:

1. per-channel min/max normalization (MathUtil.scala:132-152 semantics,
   unclipped, inf/NaN on degenerate ranges),
2. subtracting a per-group constant (≈ the group mean) so downstream f32
   window sums are cancellation-free (see kernels/corr.py), and
3. remembering the temporal shift for the loudness-boost reconstruction.

Done on host this is three NumPy passes over the whole database (gigabytes
for the 10k-file target); on device it is one vmapped program that XLA
fuses into a read-and-write pass over the slab.  Correctness note: Pearson
correlation is invariant to *any* per-group constant, so the device's f32
mean needs no f64 parity with the host version — the shift cancels exactly
in the math and ``μ + shift`` reconstructs the true window mean to f32
rounding either way.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["prepare_database", "prepare_database_xla"]


@partial(jax.jit, static_argnames=("num_temporal",))
def prepare_database_xla(feats: jnp.ndarray, norm: jnp.ndarray,
                         lens: jnp.ndarray, num_temporal: int = 1):
    """``[B, C, T]`` features, ``[C, 2]`` (min, max), ``[B]`` lengths →
    (prepared ``[B, C, T]``, temporal shifts ``[B]``), vmapped over files.

    The two group shifts are the masked means of the normalized valid
    frames; the padded tail is written as the shift-consistent constant
    (never inf/NaN, which would poison FFT traces).  The groups stay
    separate selects, so a NaN/inf shift in one (e.g. a degenerate norm
    range in the loudness channel) cannot poison the other."""
    nt = num_temporal

    def one(x, n):
        mins = norm[:, 0:1]
        rng = norm[:, 1:2] - mins
        y = (x - mins) / rng
        valid = jax.lax.broadcasted_iota(jnp.int32, y.shape, 1) < n
        yt = jnp.where(valid[:nt], y[:nt], 0.0)
        ys = jnp.where(valid[nt:], y[nt:], 0.0)
        shift_t = yt.sum() / jnp.maximum(n * nt, 1).astype(jnp.float32)
        shift_s = ys.sum() / jnp.maximum(
            n * (y.shape[0] - nt), 1).astype(jnp.float32)
        out = jnp.concatenate([y[:nt] - shift_t, y[nt:] - shift_s], axis=0)
        out = jnp.where(valid, out, jnp.concatenate(
            [jnp.full_like(y[:nt], -shift_t),
             jnp.full_like(y[nt:], -shift_s)], axis=0))
        return out.astype(jnp.float32), shift_t

    return jax.vmap(one)(feats, lens)


def prepare_database(feats, norm, lens, num_temporal: int = 1,
                     sharding=None):
    """[B, C, T] raw features (+[C,2] norm, [B] lengths) → (prepared [B,C,T],
    temporal shifts [B]), all on device.  ``norm`` may be None (identity).

    ``sharding`` (a files-axis :class:`NamedSharding`; ``B`` must divide
    evenly) places the batch sharded over a mesh; the vmapped program
    partitions SPMD."""
    if sharding is not None:
        # shard straight from host memory — an eager jnp.asarray would
        # commit the whole stack to device 0 first and pay a device→device
        # reshard on top of the upload (parallel/sweep.py keeps the same
        # discipline for its trace operands)
        feats = jax.device_put(np.asarray(feats, dtype=np.float32), sharding)
        lens = jax.device_put(np.asarray(lens, dtype=np.int32), sharding)
    else:
        feats = jnp.asarray(feats, dtype=jnp.float32)
        lens = jnp.asarray(lens, dtype=jnp.int32)
    C = feats.shape[1]
    if norm is None:
        norm_arr = jnp.concatenate(
            [jnp.zeros((C, 1), jnp.float32), jnp.ones((C, 1), jnp.float32)],
            axis=1)
    else:
        norm_arr = jnp.asarray(norm, dtype=jnp.float32)
    return prepare_database_xla(feats, norm_arr, lens,
                                num_temporal=num_temporal)
