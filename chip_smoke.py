#!/usr/bin/env python
"""Proof that the mapper runs on an NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded-index tier, 4 cards

Run it from the root of a checkout. One process holds the card(s) for
the whole run. With no option the phases are:

1. device: JAX's backend is the GPU; the card's name and power limit as
   nvidia-smi reports them; the native host library builds.
2. kernels at real widths, each compared bit for bit with the repo's
   plain reference and timed on the card: the Triton vector-SW kernel
   against sw_jax.sw_vector_batch (letter and colour space), the
   traceback-free full-SW DP against the traceback flow, the colour-space
   4-layer scan against the numpy oracle; then the compiled memory of
   the fused letter-space launch.
3. main path: the fast-path SAM streams a user's `map` command runs, on
   E. coli-scale and chr21-scale seeded genomes. Each cell must take
   the native fast path, and the SAM of its first reads must be
   byte-identical to the generic object pipeline (Mapper + io/sam.py).

--four-cards runs only the sharded-index tier (one genome bin per card)
and the mesh tier, each against the single-card whole-index run.

The last line of standard output is one JSON object, printed only when
every phase passed; any failure exits non-zero before it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    vec_rows: int = 1 << 22          # one two-phase vec launch at hg density
    fused_rows: int = 8192           # the E. coli fused launch
    stats_rows: int = 32768
    cs_rows: int = 4096
    cs_fused_rows: int = 2048
    ecoli_len: int = 4_600_000
    chr21_len: int = 47_000_000
    ls_reads: int = 50_000
    ls_pairs: int = 20_000
    cs_reads: int = 20_000
    cs_pairs: int = 10_000
    check_reads: int = 2000          # reads compared with the generic path
    bin_len: int = 12 << 20          # --four-cards: one contig per card,
                                     # region-aligned (meshmap caveat b)
    four_reads: int = 20_000
    four_pairs: int = 10_000
    reps: int = 5
    interpret: bool = False          # Pallas interpreter (CPU tests only)


ECOLI_SEED, CHR21_SEED = 20260816, 777


def log(*a):
    print(*a, flush=True)


def device_phase(n_cards: int) -> str:
    """Check the backend and the native library; returns the card's
    nvidia-smi 'name, power.limit' for the result lines."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX's devices are "
                 f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = smi.stdout.strip().splitlines()
    log(f"device: {devs[0].device_kind}, {len(devs)} visible")
    for line in cards:
        log(f"nvidia-smi: {line}")
    from shrimp_tpu.native import get_lib
    if get_lib() is None:
        sys.exit("chip_smoke: the native host library did not build")
    return cards[0]


def timed(fn, *args, reps):
    """Median seconds of fn(*args) to a ready result, after one warm-up
    call that compiles."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _scores(cs=False):
    from shrimp_tpu.config import Scores
    sc = Scores.cs_defaults() if cs else Scores()
    return dict(match=sc.match, mismatch=sc.mismatch,
                a_gap_open=sc.a_gap_open, a_gap_ext=sc.a_gap_extend,
                b_gap_open=sc.b_gap_open, b_gap_ext=sc.b_gap_extend)


def kernel_phase(sz: Sizes, card: str):
    import jax
    import jax.numpy as jnp

    from shrimp_tpu.core import sw_jax
    from shrimp_tpu.core.sw_pallas import sw_vector_batch_pallas
    from tests.test_cs_pallas import check_cs_against_oracle
    from tests.test_full_pallas import _mk, check_stats_against_traceback
    kw = _scores()
    G, R = 64, 40
    for cs in (False, True):
        for B in (sz.vec_rows, sz.fused_rows):
            rng = np.random.default_rng(B + cs)
            a = [jax.device_put(x) for x in (
                rng.integers(0, 4, (B, G)).astype(np.uint8),
                rng.integers(G // 2, G + 1, B).astype(np.int32),
                rng.integers(0, 4, (B, R)).astype(np.uint8),
                np.full(B, 36, np.int32))]
            if cs:
                a.append(jax.device_put(
                    rng.integers(0, 4, (B, G)).astype(np.uint8)))

            def tri(*x):
                return sw_vector_batch_pallas(*x, cs_mode=cs,
                                              interpret=sz.interpret, **kw)

            def xla(*x):
                return sw_jax.sw_vector_batch(*x, cs_mode=cs, **kw)

            got, want = tri(*a), xla(*a)
            if not bool(jnp.array_equal(got, want)):
                bad = int(jnp.sum(got != want))
                raise AssertionError(f"vector SW {B} rows: {bad} differ")
            t_tri = timed(tri, *a, reps=sz.reps)
            t_xla = timed(xla, *a, reps=sz.reps)
            log(f"kernel vector-SW {'CS' if cs else 'LS'} B={B} G={G} "
                f"R={R}: triton {t_tri * 1e3:.3f} ms, xla "
                f"{t_xla * 1e3:.3f} ms, bit-equal ({card})")
            del a, got, want

    for local in (False, True):
        rows = check_stats_against_traceback(
            _mk(3 + local, B=sz.stats_rows, G=G, R=R), local)
        log(f"kernel full-SW stats local={local} B={sz.stats_rows}: equal "
            f"to the traceback flow ({rows} single-diagonal rows)")
    for B in (sz.stats_rows, sz.fused_rows):
        a = _mk(5, B=B, G=G, R=R)
        args = [jax.device_put(a[k]) for k in (
            "genome", "glen", "read", "rlen", "ax", "ay", "alen", "awid",
            "revcmpl")]
        t_st = timed(lambda *x: sw_jax.sw_full_stats(*x, **kw), *args,
                     reps=sz.reps)
        t_tb = timed(lambda *x: sw_jax.sw_full_and_traceback(*x, **kw),
                     *args, reps=sz.reps)
        log(f"kernel full-SW B={B} G={G} R={R}: stats scan "
            f"{t_st * 1e3:.3f} ms, traceback flow {t_tb * 1e3:.3f} ms "
            f"({card})")

    for seed, local, taboo in ((0, False, 4), (1, True, 4), (2, False, 0)):
        rows = check_cs_against_oracle(seed, local, taboo, B=sz.cs_rows)
        log(f"kernel CS 4-layer scan local={local} taboo={taboo} "
            f"B={sz.cs_rows}: equal to the numpy oracle ({rows} scored)")
    t_cs = timed(_cs_scan(sz.cs_fused_rows, G, R), reps=sz.reps)
    log(f"kernel CS 4-layer scan B={sz.cs_fused_rows} G={G} R={R}: "
        f"{t_cs * 1e3:.3f} ms ({card})")
    fused_memory(sz)


def _cs_scan(B, G, R):
    """The CS full-SW launch (scan + traceback) on a seeded batch, as a
    thunk for timed()."""
    import jax

    from shrimp_tpu.core.sw_cs_jax import sw_full_cs_tpu
    rng = np.random.default_rng(B)
    args = [jax.device_put(x) for x in (
        rng.integers(0, 4, (B, G)).astype(np.uint8),
        np.full(B, G, np.int32),
        rng.integers(0, 4, (B, 4, R)).astype(np.uint8),
        np.full(B, 36, np.int32),
        rng.integers(-4, 6, B).astype(np.int32),
        rng.integers(5, 15, B).astype(np.int32),
        rng.integers(10, 20, B).astype(np.int32),
        rng.integers(6, 14, B).astype(np.int32),
        rng.random(B) < 0.5,
        np.full((B, R), -20, np.int32), np.full(B, -20, np.int32),
        np.zeros(B, np.int32))]
    kw = _scores(cs=True)
    return lambda: sw_full_cs_tpu(*args, **kw, local_alignment=False,
                                  indel_taboo_len=0)


def fused_memory(sz: Sizes):
    """compiled.memory_analysis() of the fused LS launch at the E. coli
    shape (4.6 Mbp planes, fused_rows windows, G 64, 36 bp reads)."""
    import jax
    import jax.numpy as jnp

    from shrimp_tpu import backend
    from shrimp_tpu.core.sw_jax import (sw_vec_full_stats_packed,
                                        sw_vec_full_tb_packed)
    n = sz.ecoli_len + 128
    u8, i32 = jnp.uint8, jnp.int32
    fn = (sw_vec_full_stats_packed if backend.stats_flow()
          else sw_vec_full_tb_packed)
    lowered = fn.lower(
        jax.ShapeDtypeStruct((n,), u8), jax.ShapeDtypeStruct((n,), u8),
        jax.ShapeDtypeStruct((sz.fused_rows, 4), i32),
        jax.ShapeDtypeStruct((sz.fused_rows, 20), u8), None,
        G=64, L=36, vec_kernel=backend.vec_kernel(), **_scores())
    mem = lowered.compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    log(f"memory_analysis {fn.__name__} B={sz.fused_rows}: " + ", ".join(
        f"{f}={getattr(mem, f, 'n/a')}" for f in fields))


def _consume(gen) -> bytes:
    assert gen is not None, "the fast path refused the configuration"
    return b"".join(gen)


def generic_sam(m, recs, paired: bool) -> bytes:
    """The in-repo reference: the generic object pipeline + io/sam.py."""
    from shrimp_tpu.io import sam
    lines = []
    if paired:
        for pe in m.map_paired(recs):
            p_out, u_out = m.select_output(pe)
            lines.extend(sam.render_pair_entry(pe, m.index, m.config,
                                               p_out, u_out))
    else:
        for re_, hits in m.map_unpaired(recs):
            for h in hits:
                lines.append(sam.render_unpaired(re_, h, m.index,
                                                 m.config))
    return ("\n".join(lines) + "\n").encode() if lines else b""


def _stream(mode: str, paired: bool):
    from shrimp_tpu import fastpath, fastpath_cs
    return {("ls", False): fastpath.map_unpaired_sam_stream,
            ("ls", True): fastpath.map_paired_sam_stream,
            ("cs", False): fastpath_cs.map_unpaired_cs_sam_stream,
            ("cs", True): fastpath_cs.map_paired_cs_sam_stream,
            }[mode, paired]


def _cfg(mode: str, paired: bool):
    from shrimp_tpu import constants as C
    from shrimp_tpu.config import MapperConfig
    kw = {}
    if mode == "cs":
        kw["mode"] = C.MODE_COLOUR_SPACE
    if paired:
        kw["pair_mode"] = "opp-in"
    return MapperConfig(**kw)


@contextlib.contextmanager
def vec_kernel(kind: str):
    """Run the block with the backend's vector-SW kernel set to `kind`
    (the end-to-end kernel comparison)."""
    from shrimp_tpu import backend
    saved = backend.current
    choice = dataclasses.replace(saved(), vec_kernel=kind)
    backend.current = lambda: choice
    try:
        yield
    finally:
        backend.current = saved


def run_cell(name, codes, mode, paired, recs, sz: Sizes, card, idx=None):
    """One main-path cell; returns (index, steady reads/s)."""
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    from shrimp_tpu.paired import PairedMapper
    t_index = 0.0
    if idx is None:
        t0 = time.perf_counter()
        idx = build_index([(name, codes)], default_seeds(mode=mode),
                          mode=mode)
        t_index = time.perf_counter() - t0
    cfg = _cfg(mode, paired)
    cls = PairedMapper if paired else Mapper
    stream = _stream(mode, paired)
    m = cls(idx, cfg)
    t0 = time.perf_counter()
    first = _consume(stream(m, recs))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = _consume(stream(m, recs))
    t_steady = time.perf_counter() - t0
    assert first == second, f"{name}: two runs gave different SAM"
    assert m.stats.vec_invocs > 0 and "filter1" in m.stats.stage_secs, \
        f"{name}: the native fast path did not run"
    k = min(sz.check_reads, len(recs))
    fast = _consume(stream(cls(idx, cfg), recs[:k]))
    want = generic_sam(cls(idx, cfg), recs[:k], paired)
    assert fast == want, f"{name}: SAM differs from the generic pipeline"
    assert want.count(b"\n") >= k // 2, f"{name}: too few alignments"
    rate = len(recs) / t_steady
    log(f"cell {name}: {len(recs)} reads, {rate:.1f} reads/s, index "
        f"{t_index:.2f} s, compile {max(t_first - t_steady, 0.0):.2f} s "
        f"(first run {t_first:.2f} s, steady {t_steady:.2f} s); SAM of "
        f"the first {k} reads byte-identical to the generic pipeline "
        f"({card})")
    return idx, rate


def main_path_phase(sz: Sizes, card: str, compare_vec: bool):
    import bench_all as B
    from shrimp_tpu import backend
    ecoli = B.genome(sz.ecoli_len, ECOLI_SEED)
    reads = B.ls_reads(ecoli, sz.ls_reads)
    idx, rate = run_cell("ecoli-ls", ecoli, "ls", False, reads, sz, card)
    if compare_vec:
        with vec_kernel(backend.VEC_XLA):
            _, rate_xla = run_cell("ecoli-ls (xla vector SW)", ecoli, "ls",
                                   False, reads, sz, card, idx=idx)
        log(f"ecoli-ls end to end: triton vector SW {rate:.1f} reads/s, "
            f"xla vector SW {rate_xla:.1f} reads/s ({card})")
    run_cell("ecoli-ls-paired", ecoli, "ls", True,
             B.ls_pairs(ecoli, sz.ls_pairs), sz, card, idx=idx)
    del idx
    cs_idx, _ = run_cell("ecoli-cs", ecoli, "cs", False,
                         B.cs_reads(ecoli, sz.cs_reads), sz, card)
    run_cell("ecoli-cs-paired", ecoli, "cs", True,
             B.cs_pairs(ecoli, sz.cs_pairs), sz, card, idx=cs_idx)
    del cs_idx
    chr21 = B.genome(sz.chr21_len, CHR21_SEED)
    run_cell("chr21-ls", chr21, "ls", False, B.ls_reads(chr21, sz.ls_reads),
             sz, card)


def _sam_diff(got: bytes, want: bytes) -> str:
    """Where two SAM texts first differ, and in which columns."""
    g, w = got.split(b"\n"), want.split(b"\n")
    for n, (a, b) in enumerate(zip(g, w)):
        if a != b:
            cols = [c + 1 for c, (x, y) in enumerate(
                zip(a.split(b"\t"), b.split(b"\t"))) if x != y]
            return (f"line {n}: columns {cols} differ\n  got  {a[:200]!r}"
                    f"\n  want {b[:200]!r}")
    return f"{len(g)} lines against {len(w)}"


def four_card_phase(sz: Sizes, card: str, n_cards: int = 4):
    """Sharded-index tier (one genome bin per card) and mesh tier, each
    byte-identical to the single-card whole-index run."""
    import jax

    import bench_all as B
    from shrimp_tpu.fastpath import (map_paired_sam_stream,
                                     map_unpaired_sam_stream)
    from shrimp_tpu.fastpath_cs import map_unpaired_cs_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    from shrimp_tpu.paired import PairedMapper
    from shrimp_tpu.parallel.meshmap import (MeshMapper, ShardedIndexMapper,
                                             make_mesh, split_contig_bins,
                                             zmerge_psum)
    mesh = make_mesh(jax.devices()[:n_cards])
    contigs = [(f"chr{c}", B.genome(sz.bin_len, 4000 + c))
               for c in range(n_cards)]
    whole_codes = np.concatenate([c for _, c in contigs])
    bins = split_contig_bins(contigs, n_cards)
    assert [len(b) for b in bins] == [1] * n_cards, "one contig per card"

    def check(name, got, want, t_sharded, t_single, n):
        if got != want:
            raise AssertionError(f"{name}: sharded SAM differs from the "
                                 f"single-card run: {_sam_diff(got, want)}")
        assert want.count(b"\n") >= n // 2, f"{name}: too few alignments"
        log(f"four-card {name}: {n} reads, sharded {n / t_sharded:.1f} "
            f"reads/s, single card {n / t_single:.1f} reads/s, SAM "
            f"byte-identical ({card})")

    def both(single, sharded):
        t0 = time.perf_counter()
        want = single()
        t1 = time.perf_counter()
        got = sharded()
        return got, want, time.perf_counter() - t1, t1 - t0

    for mode in ("ls", "cs"):
        t0 = time.perf_counter()
        whole = build_index(contigs, default_seeds(mode=mode), mode=mode)
        subs = [build_index(b, default_seeds(mode=mode), mode=mode)
                for b in bins]
        log(f"four-card {mode} indexes: {time.perf_counter() - t0:.2f} s")
        cfg = _cfg(mode, False)
        reads = (B.ls_reads if mode == "ls" else B.cs_reads)(
            whole_codes, sz.four_reads)
        single = (map_unpaired_sam_stream if mode == "ls"
                  else map_unpaired_cs_sam_stream)
        sim = ShardedIndexMapper(subs, cfg, mesh=mesh)
        got, want, ts, t1 = both(
            lambda: _consume(single(Mapper(whole, cfg), reads)),
            lambda: sim.map_unpaired_sam(reads))
        check(f"sharded-index {mode} unpaired", got, want, ts, t1,
              len(reads))
        if mode == "cs":
            continue
        assert sim.last_z1_merged is not None \
            and float(np.max(sim.last_z1_merged)) > 0.0, \
            "the z1 collective did not run"
        mm = MeshMapper(whole, cfg, mesh=mesh)
        t0 = time.perf_counter()
        got = mm.map_unpaired_sam(reads, collect_z=True)
        check("mesh ls unpaired", got, want, time.perf_counter() - t0, t1,
              len(reads))
        zp = mm.last_zpart
        merged = zmerge_psum(mesh, zp)
        assert np.allclose(merged, zp.sum(axis=0), rtol=1e-12, atol=0.0)
        assert float(merged.max()) > 0.0, "the z1 psum did not run"
        pcfg = _cfg("ls", True)
        pairs = B.ls_pairs(whole_codes, sz.four_pairs)
        simp = ShardedIndexMapper(subs, pcfg, mesh=mesh)
        got, want, ts, t1 = both(
            lambda: _consume(map_paired_sam_stream(PairedMapper(whole, pcfg),
                                                   pairs)),
            lambda: simp.map_paired_sam(pairs))
        check("sharded-index ls opp-in pairs", got, want, ts, t1,
              len(pairs))
        assert simp.last_zpair_merged is not None \
            and float(np.max(simp.last_zpair_merged[:, 3])) > 0.0, \
            "the zpair collective did not run"
        log("four-card collectives: z1 psum and zpair merge ran")
        del whole, subs, sim, mm, simp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded tiers over four cards")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    card = device_phase(n_cards)
    sz = Sizes()
    if args.four_cards:
        four_card_phase(sz, card)
    else:
        kernel_phase(sz, card)
        main_path_phase(sz, card, compare_vec=True)
    import jax
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
