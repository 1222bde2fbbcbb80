"""The GPU's vector-SW kernel (core/sw_pallas.py, Pallas through Triton)
against the XLA formulation (sw_jax.sw_vector_batch): bit-equal scores.

The CPU tests run the kernel on the Pallas interpreter and lower it for
CUDA, which checks every Triton lowering rule it needs; the `gpu` tests
compile and run it on the card.
"""
import numpy as np
import pytest

from shrimp_tpu import backend
from shrimp_tpu.core import sw_pallas
from shrimp_tpu.core.sw_jax import sw_vector_batch
from shrimp_tpu.core.sw_pallas import sw_vector_batch_pallas

KW = dict(match=10, mismatch=-15, a_gap_open=-33, a_gap_ext=-7,
          b_gap_open=-33, b_gap_ext=-3)


def _batch(seed, B, G, R, cs):
    rng = np.random.default_rng(seed)
    a = dict(genome=rng.integers(0, 5, (B, G)).astype(np.uint8),
             glen=rng.integers(1, G + 1, B).astype(np.int32),
             read=rng.integers(0, 5, (B, R)).astype(np.uint8),
             rlen=rng.integers(0, R + 1, B).astype(np.int32))
    a["g_row0"] = (rng.integers(0, 5, (B, G)).astype(np.uint8) if cs
                   else None)
    return a


def _check(a, cs, **kw):
    ref = np.asarray(sw_vector_batch(**a, cs_mode=cs, **KW))
    got = np.asarray(sw_vector_batch_pallas(**a, cs_mode=cs, **kw, **KW))
    assert (ref > 0).mean() > 0.5
    assert np.array_equal(ref, got)


def test_pallas_interpret_matches_xla_ls():
    """A batch that is not a whole number of programs pads and trims."""
    _check(_batch(15, 1000, 48, 24, False), False, interpret=True)


def test_pallas_interpret_matches_xla_cs():
    _check(_batch(16, 1024, 32, 16, True), True, interpret=True)


@pytest.mark.parametrize("cs", [False, True])
def test_pallas_interpret_strips(monkeypatch, cs):
    """Reads longer than STRIP_MAX rows run as several strips that hand
    their last row on through the program's device buffers."""
    monkeypatch.setattr(sw_pallas, "STRIP_MAX", 7)
    assert len(sw_pallas._strips(20)) == 3
    _check(_batch(17, 300, 32, 20, cs), cs, interpret=True)


@pytest.mark.parametrize("R,want", [(1, ((0, 1),)), (40, ((0, 40),)),
                                    (104, ((0, 34), (34, 69),
                                           (69, 104)))])
def test_strips_partition(R, want):
    assert sw_pallas._strips(R) == want


@pytest.mark.parametrize("G,R,cs", [(64, 40, False), (64, 40, True),
                                    (160, 104, False)])
def test_pallas_lowers_for_cuda(G, R, cs):
    """The kernel lowers to Triton IR at the fast path's widths (one
    strip for 36 bp reads, three for 100 bp reads)."""
    import jax
    import jax.numpy as jnp
    g = jax.ShapeDtypeStruct((4096, G), jnp.uint8)
    r = jax.ShapeDtypeStruct((4096, R), jnp.uint8)
    n = jax.ShapeDtypeStruct((4096,), jnp.int32)

    def f(*args):
        return sw_vector_batch_pallas(*args, cs_mode=cs, **KW)

    args = (g, n, r, n) + ((g,) if cs else ())
    text = jax.jit(f).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


def test_sw_vector_picks_kernel():
    """sw_vector launches the kernel the backend names."""
    import jax
    a = _batch(3, 256, 32, 16, False)
    del a["g_row0"]

    def prims(kernel):
        jaxpr = jax.make_jaxpr(lambda *x: sw_pallas.sw_vector(
            *x, vec_kernel=kernel, **KW))(*a.values())
        return {e.primitive.name for e in jaxpr.jaxpr.eqns}

    assert "pallas_call" in prims(backend.VEC_TRITON)
    assert "pallas_call" not in prims(backend.VEC_XLA)
    ref = np.asarray(sw_vector_batch(*a.values(), **KW))
    got = np.asarray(jax.jit(lambda *x: sw_pallas.sw_vector(
        *x, vec_kernel=backend.VEC_XLA, **KW))(*a.values()))
    assert np.array_equal(ref, got)


@pytest.mark.gpu
def test_pallas_matches_xla_ls():
    _check(_batch(5, 4096, 64, 40, False), False)


@pytest.mark.gpu
def test_pallas_matches_xla_cs():
    _check(_batch(6, 4096, 64, 40, True), True)


@pytest.mark.parametrize("kernel", [
    backend.VEC_XLA, pytest.param(backend.VEC_TRITON, marks=pytest.mark.gpu)])
def test_index_gather_path_matches(kernel):
    """Windows gathered on the device from the resident genome score as
    the host-gathered windows do."""
    import jax
    rng = np.random.default_rng(7)
    L, B, G, R = 100_000, 1024, 32, 16
    codes = rng.integers(0, 4, L).astype(np.uint8)
    gstart = rng.integers(0, L - 1, B).astype(np.int64)
    glen = rng.integers(8, G + 1, B).astype(np.int32)
    rtab = rng.integers(0, 4, (64, R)).astype(np.uint8)
    owner = rng.integers(0, 64, B).astype(np.int64)
    rlen = np.full(B, R, np.int32)
    got = np.asarray(sw_pallas.sw_vector_ls_from_index(
        jax.device_put(codes), gstart, glen, jax.device_put(rtab), owner,
        rlen, G=G, vec_kernel=kernel, **KW))
    pos = np.clip(gstart[:, None] + np.arange(G)[None, :], 0, L - 1)
    ref = np.asarray(sw_vector_batch(codes[pos], glen, rtab[owner], rlen,
                                     **KW))
    assert np.array_equal(ref, got)
