"""Memory cap (my-alloc analogue) and the CLI flags that drive it.

Covers --max-mem / --strict-mem wired to
memmodel.init, the -S save-and-exit path, the -L x -S y -z c
re-checkpoint flow, and the long-form -L seed-subset load
(gmapper.c:1740, 2846-2857; genome.c:670-831).
"""
import json
import os
import sys

import numpy as np
import pytest

from shrimp_tpu.utils import memmodel
from shrimp_tpu.utils.memmodel import MemCapError, MemTracker


@pytest.fixture(autouse=True)
def fresh_tracker():
    """CLI main() re-inits the global tracker; isolate tests."""
    yield
    memmodel.init()


# ------------------------------------------------------------ tracker

def test_cap_warn_once(capsys):
    tr = MemTracker(max_mem=1000, strict=False)
    tr.add(900, "genomemap", "a")
    tr.add(900, "genomemap", "b")
    tr.add(900, "genomemap", "c")
    err = capsys.readouterr().err
    assert err.count("my_malloc warning: exceeding maximum memory") == 1
    assert tr.crt_mem == 2700
    assert tr.peak_mem == 2700


def test_cap_strict_raises():
    tr = MemTracker(max_mem=1000, strict=True)
    tr.add(600, "x")
    with pytest.raises(MemCapError):
        tr.add(600, "x")
    # the failed allocation was not accounted
    assert tr.crt_mem == 600


def test_sub_and_untrack_release_bytes():
    tr = MemTracker(max_mem=1 << 40)
    a = np.zeros(1024, np.uint8)
    tr.track(a, "genomemap", "a")
    assert tr.crt_mem == 1024
    tr.untrack(a, "genomemap")
    assert tr.crt_mem == 0
    assert tr.by_category["genomemap"] == 0


def test_precheck_and_actual_warnings_are_independent(capsys):
    tr = MemTracker(max_mem=1000, strict=False)
    tr.precheck_index(10_000_000_000, 4, 12)   # way over: predicted warn
    tr.add(2000, "x")                          # actual over-cap warn
    err = capsys.readouterr().err
    assert "predicted index footprint" in err
    assert "exceeding maximum memory" in err


def test_precheck_strict_raises_with_split_advice():
    tr = MemTracker(max_mem=1 << 30, strict=True)
    with pytest.raises(MemCapError, match="split-db"):
        tr.precheck_index(3_000_000_000, 4, 12)


def test_alert_mem(capsys):
    tr = MemTracker(max_mem=1 << 40, alert_mem=100)
    tr.add(200, "x", "big")
    assert "my_malloc alert" in capsys.readouterr().err


def test_index_release_untracks():
    from shrimp_tpu.core.encode import encode_ls
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    memmodel.init(max_mem=1 << 40)
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 40_000).astype(np.uint8)
    before = memmodel.tracker().crt_mem
    idx = build_index([("c1", codes)], default_seeds())
    assert memmodel.tracker().crt_mem > before
    idx.release()
    assert memmodel.tracker().crt_mem == before


# ------------------------------------------------------------ CLI flags

def _mini_genome(tmp_path):
    rng = np.random.default_rng(11)
    from shrimp_tpu.core.encode import decode_ls
    seq = decode_ls(rng.integers(0, 4, 20_000).astype(np.uint8))
    g = tmp_path / "g.fa"
    g.write_text(">chr1\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    reads = tmp_path / "r.fa"
    lines = []
    for k in range(8):
        p = 500 + 997 * k
        lines.append(f">rd{k}\n{seq[p:p + 36]}\n")
    reads.write_text("".join(lines))
    return str(g), str(reads), seq


def _run_cli(argv):
    from shrimp_tpu.cli import main
    return main(argv)


def test_save_flag_saves_split_and_exits(tmp_path, capsys):
    g, reads, _ = _mini_genome(tmp_path)
    pref = str(tmp_path / "db")
    rc = _run_cli(["map", "-S", pref, g])
    assert rc == 0
    assert os.path.exists(pref + ".genome.npz")
    assert os.path.exists(pref + ".seed.0.npz")
    # exit without mapping: no SAM on stdout
    out = capsys.readouterr().out
    assert "@SQ" not in out


def test_load_short_form_prefix_maps(tmp_path, capsys):
    g, reads, _ = _mini_genome(tmp_path)
    pref = str(tmp_path / "db")
    assert _run_cli(["map", "-S", pref, g]) == 0
    capsys.readouterr()
    assert _run_cli(["map", "-L", pref, reads]) == 0
    direct = capsys.readouterr().out
    assert _run_cli(["map", g, reads] if False else ["map", reads, g]) == 0
    whole = capsys.readouterr().out
    # identical SAM apart from the @PG command line
    strip = lambda s: [l for l in s.splitlines()
                       if not l.startswith("@PG")]
    assert strip(direct) == strip(whole)


def test_load_long_form_seed_subset(tmp_path, capsys):
    g, reads, _ = _mini_genome(tmp_path)
    pref = str(tmp_path / "db")
    assert _run_cli(["map", "-S", pref, g]) == 0
    capsys.readouterr()
    n_seeds = len([p for p in os.listdir(tmp_path)
                   if ".seed." in p])
    assert n_seeds >= 2
    # subset: genome + first seed only
    long_arg = f"{pref}.genome.npz,{pref}.seed.0.npz"
    assert _run_cli(["map", "-L", long_arg, reads]) == 0
    capsys.readouterr()
    # and it must differ from nothing: the load path itself worked with
    # a single projection (settings print one seed)
    from shrimp_tpu.index.build import GenomeIndex
    gi = GenomeIndex.load_split(f"{pref}.genome.npz",
                                [f"{pref}.seed.0.npz"])
    assert len(gi.seeds) == 1


def test_save_after_load_recheckpoint_trims(tmp_path, capsys):
    g, reads, _ = _mini_genome(tmp_path)
    pref = str(tmp_path / "db")
    assert _run_cli(["map", "-S", pref, g]) == 0
    # re-checkpoint with a trim: -L x -S y -z c (gmapper.c:2846-2857)
    pref2 = str(tmp_path / "db_trim")
    assert _run_cli(["map", "-L", pref, "-S", pref2, "-z", "2"]) == 0
    err = capsys.readouterr().err
    assert "Trimming index lists longer than: 2" in err
    from shrimp_tpu.index.build import GenomeIndex
    full = GenomeIndex.load_split(pref + ".genome")
    trimmed = GenomeIndex.load_split(pref2 + ".genome")
    for sf, st in zip(full.seeds, trimmed.seeds):
        lens_f = sf.list_lengths()
        lens_t = st.list_lengths()
        assert (lens_t <= 2).all()
        # lists at or under the cutoff survive unchanged
        keep = lens_f <= 2
        assert (lens_t[keep] == lens_f[keep]).all()


def test_trim_equivalent_to_query_time_cutoff():
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    rng = np.random.default_rng(3)
    codes = np.tile(rng.integers(0, 4, 300).astype(np.uint8), 40)
    idx = build_index([("c", codes)], default_seeds())
    dropped = idx.trim(5)
    assert dropped > 0
    for si in idx.seeds:
        assert (si.list_lengths() <= 5).all()
        assert si.offsets[-1] == len(si.positions)


def test_strict_mem_flag_aborts_build(tmp_path):
    g, reads, _ = _mini_genome(tmp_path)
    with pytest.raises(MemCapError):
        _run_cli(["map", "--max-mem", "0.0001", "--strict-mem",
                  reads, g])


def test_max_mem_flag_warns(tmp_path, capsys):
    g, reads, _ = _mini_genome(tmp_path)
    assert _run_cli(["map", "--max-mem", "0.0001", reads, g]) == 0
    assert "my_malloc warning" in capsys.readouterr().err
