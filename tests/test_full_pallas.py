"""The traceback-free full-SW DP (core/sw_jax.sw_full_stats, the stats
flow) against the traceback flow (sw_full_batch + the on-device walk).

Score, best cell and start plane must be equal on every row that
scores. Where the stats say the whole path is one diagonal chain
(plane 0, term 0), the closed form the host applies (nops = run,
starts = max - run + 1, matches = deq - base) must give the walk's
results."""
import numpy as np
import pytest

from shrimp_tpu.core import sw_jax

KW = dict(match=10, mismatch=-15, a_gap_open=-33, a_gap_ext=-7,
          b_gap_open=-33, b_gap_ext=-3)


def _mk(seed, B=1024, G=32, R=16):
    rng = np.random.default_rng(seed)
    return dict(
        genome=rng.integers(0, 5, (B, G)).astype(np.uint8),
        glen=rng.integers(8, G + 1, B).astype(np.int32),
        read=rng.integers(0, 5, (B, R)).astype(np.uint8),
        rlen=rng.integers(6, R + 1, B).astype(np.int32),
        ax=rng.integers(-4, G // 2, B).astype(np.int32),
        ay=rng.integers(-4, R, B).astype(np.int32),
        alen=rng.integers(1, 12, B).astype(np.int32),
        awid=rng.integers(3, 20, B).astype(np.int32),
        revcmpl=rng.integers(0, 2, B) > 0,
    )


ARGS = ("genome", "glen", "read", "rlen", "ax", "ay", "alen", "awid",
        "revcmpl")


def check_stats_against_traceback(a, local):
    """Compare sw_full_stats with the traceback flow on the batch `a`;
    returns the number of single-diagonal rows checked."""
    args = [a[k] for k in ARGS]
    score, mi, mj, plane, _ = (np.asarray(x) for x in sw_jax.sw_full_batch(
        *args, local_alignment=local, **KW))
    pk, _ = sw_jax.sw_full_and_traceback(*args, local_alignment=local,
                                         **KW)
    pk = np.asarray(pk)
    st = np.asarray(sw_jax.sw_full_stats(*args, local_alignment=local,
                                         **KW))
    assert np.array_equal(st[:, 0], pk[:, 0]), "scores differ"
    pos = pk[:, 0] > 0
    assert pos.sum() > 10
    for c, ref in ((1, mi), (2, mj), (3, plane)):
        assert np.array_equal(st[pos, c], ref[pos]), c
    diag = pos & (st[:, 3] == 0) & (st[:, 5] == 0)
    run, matches = st[diag, 4], st[diag, 6] - st[diag, 7]
    # packed: score, max_i, max_j, nops, rs, gs, matches, mismatches,
    # insertions, deletions
    ref = pk[diag]
    assert np.array_equal(run, ref[:, 3])
    assert np.array_equal(st[diag, 1] - run + 1, ref[:, 4])
    assert np.array_equal(st[diag, 2] - run + 1, ref[:, 5])
    assert np.array_equal(matches, ref[:, 6])
    assert np.array_equal(run - matches, ref[:, 7])
    assert not ref[:, 8:].any()
    return int(diag.sum())


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_full_pallas_matches_xla_traceback(local, seed):
    assert check_stats_against_traceback(_mk(seed), local) > 0
