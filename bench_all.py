#!/usr/bin/env python
"""Full perf suite over the BASELINE.json workloads (one JSON line per
workload). bench.py remains the driver's single-metric entry point;
this script measures the wider matrix on demand:

  ecoli-ls        36bp LS unpaired vs 4.6Mb (bench.py's metric)
  ecoli-paired    2x36bp LS opp-in pairs
  ecoli-cs        36bp colour-space unpaired
  ecoli-ls-fastq  36bp LS unpaired with quality strings
  chr21-ls        36bp LS unpaired vs 47Mb synthetic

Usage: python bench_all.py [workload ...]   (default: all)
Env: SHRIMP_TPU_BENCH_READS (default 400000).
"""
import json
import os
import sys
import time

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
# enough batches to fill the 32-lane pipeline at the 16k batch size
# (100k reads = 6 batches left the pipeline mostly empty)
N_READS = int(os.environ.get("SHRIMP_TPU_BENCH_READS", "400000"))
READ_LEN = 36


def genome(length: int, seed: int) -> np.ndarray:
    """A seeded uniform random genome of 2-bit letter codes."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, length).astype(np.uint8)


def _genome(name: str, length: int, seed: int) -> np.ndarray:
    return genome(length, seed)


def _index(name: str, codes: np.ndarray, mode: str = "ls"):
    from shrimp_tpu.index.build import GenomeIndex, build_index
    from shrimp_tpu.index.seeds import default_seeds
    sfx = "" if mode == "ls" else ".cs"
    npz = os.path.join(CACHE, f"{name}{sfx}.idx.npz")
    if os.path.exists(npz):
        return GenomeIndex.load(npz)
    idx = build_index([(name, codes)], default_seeds(mode=mode),
                      mode=mode)
    idx.save(npz)
    if not os.path.exists(npz) and os.path.exists(npz + ".npz"):
        os.rename(npz + ".npz", npz)
    return idx


_COMP = np.array([3, 2, 1, 0], np.uint8)


def ls_reads(codes, n, seed=7, quals=False):
    """n 36 bp letter-space reads: 0-2 substitutions, odd reads
    reverse-complemented."""
    return _ls_reads(codes, n, np.random.default_rng(seed), quals)


def ls_pairs(codes, n_pairs, seed=8):
    """n_pairs opp-in 2x36 bp pairs, insert 120-280, 0-2 substitutions
    per leg; records alternate /1, /2."""
    from shrimp_tpu.core.encode import decode_ls
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(seed)
    recs = []
    for k in range(n_pairs):
        isz = int(rng.integers(120, 280))
        p = int(rng.integers(0, len(codes) - isz - READ_LEN))
        a = codes[p:p + READ_LEN].copy()
        b = _COMP[codes[p + isz - READ_LEN:p + isz][::-1]].copy()
        for r in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(READ_LEN))] = rng.integers(4)
        recs.append(SeqRecord(f"p{k}/1", decode_ls(a)))
        recs.append(SeqRecord(f"p{k}/2", decode_ls(b)))
    return recs


def _tocs(lets):
    import shrimp_tpu.constants as C
    cm = C.COLOUR_MAT
    cols = [int(cm[3, lets[0]])] + [int(cm[lets[i], lets[i + 1]])
                                    for i in range(READ_LEN - 1)]
    return "T" + "".join(str(c) if c <= 3 else "." for c in cols)


def cs_reads(codes, n, seed=9):
    """n 36-colour reads from the forward strand, 0-2 letter
    substitutions."""
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(seed)
    recs = []
    for k in range(n):
        p = int(rng.integers(0, len(codes) - READ_LEN - 1))
        lets = codes[p:p + READ_LEN + 1].copy()
        for _ in range(int(rng.integers(0, 3))):
            lets[int(rng.integers(READ_LEN + 1))] = rng.integers(4)
        recs.append(SeqRecord(f"c{k}", _tocs(lets)))
    return recs


def cs_pairs(codes, n_pairs, seed=11):
    """n_pairs opp-in colour-space pairs (as ls_pairs)."""
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(seed)
    recs = []
    for k in range(n_pairs):
        isz = int(rng.integers(120, 280))
        p = int(rng.integers(0, len(codes) - isz - READ_LEN - 1))
        a = codes[p:p + READ_LEN + 1].copy()
        b = _COMP[codes[p + isz - READ_LEN - 1:p + isz][::-1]].copy()
        for r in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(READ_LEN + 1))] = rng.integers(4)
        recs.append(SeqRecord(f"q{k}/1", _tocs(a)))
        recs.append(SeqRecord(f"q{k}/2", _tocs(b)))
    return recs


def _ls_reads(codes, n, rng, quals=False):
    from shrimp_tpu.core.encode import decode_ls
    from shrimp_tpu.io.fasta import SeqRecord
    out = []
    for k in range(n):
        p = int(rng.integers(0, len(codes) - READ_LEN))
        r = codes[p:p + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(READ_LEN))] = rng.integers(4)
        if k % 2:
            r = _COMP[r[::-1]]
        q = None
        if quals:
            q = "".join(chr(64 + int(x))
                        for x in rng.integers(15, 41, READ_LEN))
        out.append(SeqRecord(f"r{k}", decode_ls(r), q))
    return out


def _run_stream(gen) -> int:
    n = 0
    for chunk in gen:
        n += chunk.count(b"\n")
    return n


def bench_ls(name, glen, seed, fastq=False, env=None):
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_unpaired_sam_stream
    from shrimp_tpu.mapper import Mapper
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        return _bench_ls_inner(name, glen, seed, fastq, MapperConfig,
                               map_unpaired_sam_stream, Mapper)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _bench_ls_inner(name, glen, seed, fastq, MapperConfig,
                    map_unpaired_sam_stream, Mapper):
    codes = _genome(name, glen, seed)
    idx = _index(name, codes)
    m = Mapper(idx, MapperConfig())
    rng = np.random.default_rng(7)
    recs = _ls_reads(codes, N_READS, rng, quals=fastq)
    warm = map_unpaired_sam_stream(m, recs[:16384], batch_size=16384)
    assert warm is not None
    _run_stream(warm)
    t0 = time.time()
    lines = _run_stream(map_unpaired_sam_stream(m, recs, batch_size=16384))
    dt = time.time() - t0
    return len(recs) / dt, lines


def bench_ls_flags(name, glen, seed):
    """Renderer-level flags (--sam-unaligned --read-group --all-contigs)
    through the NATIVE fast path — published to show these flags no
    longer fall off a performance cliff."""
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_unpaired_sam_stream
    from shrimp_tpu.mapper import Mapper
    codes = _genome(name, glen, seed)
    idx = _index(name, codes)
    m = Mapper(idx, MapperConfig(sam_unaligned=True,
                                 read_group_name="bench",
                                 sam_sample_name="s"))
    rng = np.random.default_rng(7)
    recs = _ls_reads(codes, N_READS, rng)
    warm = map_unpaired_sam_stream(m, recs[:16384], batch_size=16384)
    assert warm is not None, "flags unexpectedly outside the fast gate"
    _run_stream(warm)
    t0 = time.time()
    lines = _run_stream(map_unpaired_sam_stream(m, recs,
                                                batch_size=16384))
    dt = time.time() - t0
    return len(recs) / dt, lines


def bench_ls_es(name, glen, seed):
    """--extra-sam-fields through the NATIVE fast path (r5: the native
    renderer builds ZM/ZR/ZV/ZH/ZE edit strings itself) — compare with
    ecoli-ls-generic, the same config on the generic object pipeline,
    to see the r4 31x off-default cliff closed."""
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_unpaired_sam_stream
    from shrimp_tpu.mapper import Mapper
    codes = _genome(name, glen, seed)
    idx = _index(name, codes)
    cfg = MapperConfig(extra_sam_fields=True)
    m = Mapper(idx, cfg)
    rng = np.random.default_rng(7)
    recs = _ls_reads(codes, N_READS, rng)
    for _ in map_unpaired_sam_stream(m, recs[:4096]):
        pass
    t0 = time.time()
    nb = 0
    gen = map_unpaired_sam_stream(m, recs)
    assert gen is not None, "extra-sam-fields left the fast gate"
    for chunk in gen:
        nb += len(chunk)
    dt = time.time() - t0
    return len(recs) / dt, nb // 100  # lines proxy: bytes/100


def bench_ls_generic(name, glen, seed):
    """The generic object pipeline on the same --extra-sam-fields
    config (r4 published this as the off-default cliff; r5 moved the
    config inside the fast gate — this row keeps measuring the generic
    pipeline itself, the floor any still-ungated config falls to:
    multi-round option sets, --shrimp-format, gapless, local)."""
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.io.sam import render_unpaired
    from shrimp_tpu.mapper import Mapper
    codes = _genome(name, glen, seed)
    idx = _index(name, codes)
    cfg = MapperConfig(extra_sam_fields=True)
    m = Mapper(idx, cfg)
    rng = np.random.default_rng(7)
    n = min(N_READS, 20000)   # the generic path is the slow one
    recs = _ls_reads(codes, n, rng)
    m.map_unpaired(recs[:256])      # warm kernels
    t0 = time.time()
    lines = 0
    for re_, hits in m.map_unpaired(recs):
        for h in hits:
            render_unpaired(re_, h, idx, cfg)
            lines += 1
    dt = time.time() - t0
    return len(recs) / dt, lines


def bench_paired(name, glen, seed):
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_paired_sam_stream
    from shrimp_tpu.paired import PairedMapper
    codes = _genome(name, glen, seed)
    idx = _index(name, codes)
    m = PairedMapper(idx, MapperConfig(pair_mode="opp-in"))
    recs = ls_pairs(codes, N_READS // 2)
    warm = map_paired_sam_stream(m, recs[:16384], batch_size=16384)
    assert warm is not None
    _run_stream(warm)
    t0 = time.time()
    lines = _run_stream(map_paired_sam_stream(m, recs, batch_size=16384))
    dt = time.time() - t0
    return len(recs) / dt, lines


def bench_cs(name, glen, seed):
    import shrimp_tpu.constants as C
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath_cs import map_unpaired_cs_sam_stream
    from shrimp_tpu.mapper import Mapper
    codes = _genome(name, glen, seed)
    idx = _index(name, codes, mode="cs")
    m = Mapper(idx, MapperConfig(mode=C.MODE_COLOUR_SPACE))
    recs = cs_reads(codes, N_READS)
    warm = map_unpaired_cs_sam_stream(m, recs[:16384], batch_size=16384)
    assert warm is not None
    _run_stream(warm)
    t0 = time.time()
    lines = _run_stream(
        map_unpaired_cs_sam_stream(m, recs, batch_size=16384))
    dt = time.time() - t0
    return len(recs) / dt, lines


def bench_cs_paired(name, glen, seed):
    import shrimp_tpu.constants as C
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath_cs import map_paired_cs_sam_stream
    from shrimp_tpu.paired import PairedMapper
    codes = _genome(name, glen, seed)
    idx = _index(name, codes, mode="cs")
    m = PairedMapper(idx, MapperConfig(mode=C.MODE_COLOUR_SPACE,
                                       pair_mode="opp-in"))
    recs = cs_pairs(codes, N_READS // 2)
    warm = map_paired_cs_sam_stream(m, recs[:16384], batch_size=16384)
    assert warm is not None
    _run_stream(warm)
    t0 = time.time()
    lines = _run_stream(
        map_paired_cs_sam_stream(m, recs, batch_size=16384))
    dt = time.time() - t0
    return len(recs) / dt, lines


WORKLOADS = {
    "ecoli-ls": lambda: bench_ls("ecoli_synth2", 4_600_000, 20260816),
    "ecoli-ls-fastq": lambda: bench_ls("ecoli_synth2", 4_600_000,
                                       20260816, fastq=True),
    "ecoli-paired": lambda: bench_paired("ecoli_synth2", 4_600_000,
                                         20260816),
    "ecoli-cs": lambda: bench_cs("ecoli_synth2", 4_600_000, 20260816),
    "ecoli-cs-paired": lambda: bench_cs_paired("ecoli_synth2",
                                               4_600_000, 20260816),
    # chr21 runs the DEFAULT config: the round-5 device-step fixes
    # (one launch per batch, fast gather, density-aware batch) removed
    # the need for the round-4 hand sweep (48 lanes / 2 f1 threads)
    "chr21-ls": lambda: bench_ls("chr21", 47_000_000, 777),
    "ecoli-ls-flags": lambda: bench_ls_flags("ecoli_synth2", 4_600_000,
                                             20260816),
    "ecoli-ls-es": lambda: bench_ls_es("ecoli_synth2", 4_600_000,
                                       20260816),
    "ecoli-ls-generic": lambda: bench_ls_generic("ecoli_synth2",
                                                 4_600_000, 20260816),
}


def main():
    os.environ.setdefault("SHRIMP_TPU_PIPELINE_LANES", "32")
    names = sys.argv[1:] or list(WORKLOADS)
    for nm in names:
        rate, lines = WORKLOADS[nm]()
        print(json.dumps({"metric": nm, "value": round(rate, 1),
                          "unit": "reads/s/chip", "lines": lines}))


if __name__ == "__main__":
    main()
