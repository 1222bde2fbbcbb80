"""The colour-space 4-layer full-SW DP that runs on the device
(core/sw_cs_jax.sw_full_cs_tpu, a lax.scan over read rows) must match
the numpy oracle (core/sw_cs_batch.sw_full_cs_batch) bit for bit:
every result field and the step strings, on every row."""
import numpy as np
import pytest

from shrimp_tpu import constants as C
from shrimp_tpu.core.sw_cs_batch import sw_full_cs_batch
from shrimp_tpu.core.sw_cs_jax import sw_full_cs_batch_jax

FIELDS = ("score", "n_steps", "read_start", "genome_start", "rmapped",
          "gmapped", "matches", "mismatches", "insertions", "deletions",
          "crossovers", "steps")


def check_cs_against_oracle(seed, local, taboo, B=512):
    """Run both on one seeded batch of B rows (G 64, R 40); returns the
    number of rows that score."""
    rng = np.random.default_rng(seed)
    G, R = 64, 40
    g = rng.integers(0, 4, (B, G)).astype(np.uint8)
    g[rng.random((B, G)) < 0.01] = C.BASE_N
    glen = rng.integers(40, G + 1, B).astype(np.int32)
    cols = rng.integers(0, 4, (B, R)).astype(np.uint8)
    cols[:, int(rng.integers(0, R))] = C.BASE_N
    initbp = rng.integers(0, 4, B).astype(np.int64)
    rlen = rng.integers(20, 36, B).astype(np.int32)
    ay = rng.integers(5, 15, B).astype(np.int32)
    ax = rng.integers(-4, 6, B).astype(np.int32)
    alen = rng.integers(10, 20, B).astype(np.int32)
    awid = rng.integers(6, 14, B).astype(np.int32)
    rev = rng.random(B) < 0.5
    xover = np.full((B, R + 1), -20, np.int32)   # last column: global
    thresh = np.zeros(B, np.int32)
    kw = dict(match=10, mismatch=-24, a_gap_open=-40, a_gap_ext=-7,
              b_gap_open=-40, b_gap_ext=-7, local_alignment=local,
              indel_taboo_len=taboo)
    args = (g, glen, cols, rlen, initbp, ax, ay, alen, awid, rev, xover,
            thresh)
    want = sw_full_cs_batch(*args, **kw)
    got = sw_full_cs_batch_jax(*args, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    return int((want.score > 0).sum())


@pytest.mark.parametrize("seed,local,taboo", [(0, False, 4),
                                              (1, True, 4),
                                              (2, False, 0)])
def test_cs_pallas_dp_matches_scan(seed, local, taboo):
    assert check_cs_against_oracle(seed, local, taboo) > 10
