"""Every float32 contraction on the parity paths asks for full precision:
a GPU may otherwise run a float32 dot in TF32 (about three decimal
digits), far outside the 1e-5 parity budget."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from strugatzki_tpu.dsp import frontend as FE
from strugatzki_tpu.kernels import corr as K
from strugatzki_tpu.parallel import database as D


def _dots(jaxpr):
    """Every ``dot_general`` equation, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            subs = v if isinstance(v, (list, tuple)) else [v]
            for sub in subs:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _dots(inner)


def _block_pipeline(use_fft):
    consts = FE._device_consts(44100.0, 1024, 13, 0.25, 1.0)
    audio = jnp.zeros((7 * 512 + 1024,), jnp.float32)
    carry = jnp.zeros((42,), jnp.float32)
    return jax.make_jaxpr(lambda a, c: FE._block_pipeline(
        a, c, *consts, num_frames=8, fft_size=1024, step=512,
        use_fft=use_fft))(audio, carry)


def _correlation_trace():
    x = jnp.ones((14, 64), jnp.float32)
    t = jnp.ones((1, 16), jnp.float32)
    s = jnp.ones((13, 16), jnp.float32)
    f = jnp.float32(1.0)
    return jax.make_jaxpr(K.correlation_trace)(x, t, s, f, f, f, f, f, f)


def _gram():
    w = jnp.ones((8, 14, 5), jnp.float32)
    st = K.window_stats(w)
    return jax.make_jaxpr(K.gram_similarity_block)(w, w, st, st,
                                                   jnp.float32(0.5))


def _rerank():
    xs = jnp.ones((3, 14, 64), jnp.float32)
    i = jnp.zeros((4,), jnp.int32)
    f = jnp.float32(1.0)
    return jax.make_jaxpr(D._rerank_window_kernel)(
        xs, jnp.zeros((3,)), i, i, jnp.ones((1, 16)), jnp.ones((13, 16)),
        f, f, f, f, f)


@pytest.mark.parametrize("build,min_dots", [
    (lambda: _block_pipeline(True), 3),      # mel, DCT, ERB bands
    (lambda: _block_pipeline(False), 5),     # + the two DFT matmuls
    (_correlation_trace, 0),                 # FFT formulation: no dots
    (_gram, 1),
    (_rerank, 2),                            # temporal + spectral groups
], ids=["block_pipeline_fft", "block_pipeline_gemm", "correlation_trace",
        "gram_similarity_block", "rerank_window"])
def test_every_dot_general_is_highest(build, min_dots):
    dots = list(_dots(build().jaxpr))
    assert len(dots) >= min_dots
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None, eqn
        assert all(p == jax.lax.Precision.HIGHEST for p in
                   (prec if isinstance(prec, tuple) else (prec,))), eqn
