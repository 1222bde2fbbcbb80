#!/usr/bin/env python
"""hg18-scale benchmark: the reference's SPLIT-DB workflow at 3 Gbp.

Reference headline (BASELINE.md, README:107-117): 36bp colour-space
reads map against hg18 at 160,000 reads/hour/core (~44 reads/s/core,
3.0 GHz core, 16 GB RAM), with the genome split into 4 RAM-sized
pieces (utils/split-db.py), one gmapper run per piece, and the
per-piece SAM recombined by mergesam (SPLITTING_AND_MERGING).

This script reproduces that workflow end to end at the same scale:
N synthetic chromosome bins (default 4 x 750 Mbp), one saved index per
bin (the project-db step, cached across runs), every read mapped
against every bin with the native fast path, and the per-bin SAM
merged with exact MQV recombination (tools/mergesam). Each bin's
mapper uses its own auto list cutoff, exactly like the reference
workflow where each gmapper instance only sees its piece (the README
reports cutoff ~5000 on hg18 quarters this way, README:1297-1305).

The synthetic genome carries hg-like repeat structure, not i.i.d.
bases: ~47% of each bin is covered by mutated copies from a shared
repeat library — a 300bp SINE-like unit at ~25% (5-25% per-copy
divergence), 5'-truncated 6kb LINE-like fragments at ~15%, 171bp
alpha-satellite-like tandem arrays at ~5% (1-3% divergence) — plus
~1.5% N gaps. That gives the per-kmer posting lists a real heavy tail,
so the auto list cutoff actually trims (the behavior that dominates
real-hg18 runtime: cutoff ~5000 with a ~3x runtime effect,
/root/reference/README:1297-1305). The script logs the cutoff value,
the number of over-cutoff keys, the list-length tail, and the measured
candidate windows/read so the density can be compared against hg18.

The TIMED SPAN is mapping + merge. Index load-from-disk and device
plane upload are logged per shard but EXCLUDED: the reference's
reads/hour figure amortizes piece loading over ~250M reads
(README:113-114); at bench read counts including it would measure the
disk, not the mapper.

Usage: python bench_hg.py [ls|cs|ls-paired|cs-paired]
       (default: cs — the headline; *-paired maps opp-in pairs and
       checks the reference's "paired ~2x faster" claim, README:109-110)
Env:   SHRIMP_TPU_HG_LEN     total genome bases   (default 3e9)
       SHRIMP_TPU_HG_SHARDS  bins                 (default 4)
       SHRIMP_TPU_BENCH_READS reads               (default 50000)
First run builds ~13 GB of index cache per bin under the checkout's
.bench_cache/ (sequentially, ~5 min per 750 Mbp bin).
"""
import json
import os
import sys
import time

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
HG_LEN = int(float(os.environ.get("SHRIMP_TPU_HG_LEN", "3e9")))
N_SHARDS = int(os.environ.get("SHRIMP_TPU_HG_SHARDS", "4"))
N_READS = int(os.environ.get("SHRIMP_TPU_BENCH_READS", "50000"))
READ_LEN = 36
BASELINE_CS = 44.4   # 160k reads/hour/core, README:107-109
SEED = 20260818

# 16-entry complement LUT: codes 0-3 complement, BASE_N (15) maps to
# itself so a pair sampled across an N gap survives until the resample
# check instead of indexing out of bounds
_COMP = np.arange(16, dtype=np.uint8)
_COMP[:4] = [3, 2, 1, 0]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


BASE_N = 15          # constants.BASE_N: windows containing N are skipped


def _mutate_copies(rng, copies: np.ndarray, div: np.ndarray) -> None:
    """Per-copy point mutation at per-row divergence rates (in place)."""
    n, L = copies.shape
    for off in range(0, n, 100_000):      # bound the float mask RAM
        end = min(off + 100_000, n)
        mask = rng.random((end - off, L)) < div[off:end, None]
        copies[off:end][mask] = rng.integers(
            0, 4, int(mask.sum()), dtype=np.int64).astype(np.uint8)


def shard_codes(i: int, slen: int) -> np.ndarray:
    """One 750 Mbp bin with hg-like repeat structure (module docstring);
    the repeat LIBRARY is shared across bins (genome-wide families), the
    copies and their mutations are per-bin."""
    os.makedirs(CACHE, exist_ok=True)
    path = os.path.join(
        CACHE, f"hgrep{HG_LEN}.shard{i}of{N_SHARDS}.codes.npy")
    if os.path.exists(path):
        return np.load(path, mmap_mode="r")
    t0 = time.time()
    lib = np.random.default_rng(SEED)     # shared library
    sine = lib.integers(0, 4, 300, dtype=np.int64).astype(np.uint8)
    line = lib.integers(0, 4, 6000, dtype=np.int64).astype(np.uint8)
    sat = lib.integers(0, 4, 171, dtype=np.int64).astype(np.uint8)
    rng = np.random.default_rng(SEED + 1000 + i)
    codes = rng.integers(0, 4, slen, dtype=np.int64).astype(np.uint8)
    # SINE-like: ~25% of bases, 300bp copies, 5-25% divergence
    n_sine = int(0.25 * slen) // 300
    starts = rng.integers(0, slen - 300, n_sine)
    copies = np.tile(sine, (n_sine, 1))
    _mutate_copies(rng, copies, rng.uniform(0.05, 0.25, n_sine))
    pos = starts[:, None] + np.arange(300)[None, :]
    codes[pos.ravel()] = copies.ravel()
    del copies, pos
    # LINE-like: ~15% of bases, 5'-truncated 0.5-6 kb fragments,
    # 5-20% divergence
    budget = int(0.15 * slen)
    while budget > 0:
        L = int(rng.integers(500, 6001))
        s = int(rng.integers(0, slen - L))
        frag = line[-L:].copy()
        d = float(rng.uniform(0.05, 0.20))
        m = rng.random(L) < d
        frag[m] = rng.integers(0, 4, int(m.sum()),
                               dtype=np.int64).astype(np.uint8)
        codes[s:s + L] = frag
        budget -= L
    # alpha-satellite-like tandem arrays: ~5%, 10-200 kb, 1-3%
    # divergence — these are the monster posting lists the cutoff trims
    budget = int(0.05 * slen)
    while budget > 0:
        L = int(rng.integers(10_000, 200_001))
        s = int(rng.integers(0, slen - L))
        reps = -(-L // len(sat))
        arr = np.tile(sat, reps)[:L].copy()
        d = float(rng.uniform(0.01, 0.03))
        m = rng.random(L) < d
        arr[m] = rng.integers(0, 4, int(m.sum()),
                              dtype=np.int64).astype(np.uint8)
        codes[s:s + L] = arr
        budget -= L
    # N gaps: ~1.5% in ~20 blocks (centromere/assembly-gap analogue)
    budget = int(0.015 * slen)
    for _ in range(20):
        L = budget // 20
        s = int(rng.integers(0, slen - L))
        codes[s:s + L] = BASE_N
    log(f"[genome] shard {i}: {slen / 1e6:.0f} Mbp repeat-structured "
        f"({time.time() - t0:.0f}s)")
    np.save(path + ".tmp.npy", codes)
    os.replace(path + ".tmp.npy", path)
    return codes


def shard_index_path(i: int, mode: str) -> str:
    return os.path.join(
        CACHE, f"hgrep{HG_LEN}.{mode}.shard{i}of{N_SHARDS}.idx.npz")


def build_shard_index(i: int, mode: str, slen: int) -> str:
    """project-db step: build + save one bin's index (cached)."""
    npz = shard_index_path(i, mode)
    if os.path.exists(npz):
        return npz
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    codes = np.asarray(shard_codes(i, slen))
    t0 = time.time()
    idx = build_index([(f"chr{i + 1}", codes)], default_seeds(mode=mode),
                      mode=mode)
    t1 = time.time()
    idx.save(npz + ".tmp")
    src = npz + ".tmp" if os.path.exists(npz + ".tmp") else npz + ".tmp.npz"
    os.replace(src, npz)
    log(f"[build] shard {i}: {slen / 1e6:.0f} Mbp {mode} index "
        f"built {t1 - t0:.1f}s saved {time.time() - t1:.1f}s")
    idx.release()   # hugepage buffers outlive GC without this
    del idx, codes
    return npz


def _render(mode: str, r: np.ndarray) -> str:
    import shrimp_tpu.constants as C
    from shrimp_tpu.core.encode import decode_ls
    if mode == "cs":
        cm = C.COLOUR_MAT
        cols = [int(cm[3, r[0]])] + [int(cm[r[j], r[j + 1]])
                                     for j in range(len(r) - 2)]
        return "T" + "".join(str(c) if c <= 3 else "." for c in cols)
    return decode_ls(r)


def gen_reads(mode: str, slen: int):
    """36bp reads sampled round-robin from the bins, 0-2 errors, half
    reverse-complement; colour-space reads get a T primer + colours."""
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(SEED)
    plen = READ_LEN + (1 if mode == "cs" else 0)
    picks = []   # (shard, pos, revcomp, errors)
    for k in range(N_READS):
        picks.append((k % N_SHARDS,
                      int(rng.integers(0, slen - plen - 1)),
                      k % 2 == 1,
                      [(int(rng.integers(plen)), int(rng.integers(4)))
                       for _ in range(int(rng.integers(0, 3)))]))
    recs = [None] * N_READS
    for s in range(N_SHARDS):
        codes = np.asarray(shard_codes(s, slen))
        for k, (sh, p, rc, errs) in enumerate(picks):
            if sh != s:
                continue
            r = codes[p:p + plen].copy()
            while (r == BASE_N).any():     # resample out of N gaps
                p = int(rng.integers(0, slen - plen - 1))
                r = codes[p:p + plen].copy()
            if rc:
                r = _COMP[r[::-1]]
            for pos, b in errs:
                r[pos] = b
            recs[k] = SeqRecord(f"q{k}", _render(mode, r))
        del codes
    rpath = os.path.join(CACHE, f"hgrep_reads_{mode}_{N_READS}.fa")
    with open(rpath, "w") as f:
        for r in recs:
            f.write(f">{r.name}\n{r.seq}\n")
    return recs, rpath


def gen_pairs(mode: str, slen: int):
    """opp-in pairs, insert 100-300, 0-2 errors per foot."""
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(SEED + 77)
    plen = READ_LEN + (1 if mode == "cs" else 0)
    n_pairs = N_READS // 2
    picks = []
    for k in range(n_pairs):
        isz = int(rng.integers(100, 300))
        picks.append((k % N_SHARDS,
                      int(rng.integers(0, slen - isz - 2)), isz,
                      [(int(rng.integers(plen)), int(rng.integers(4)))
                       for _ in range(int(rng.integers(0, 3)))],
                      [(int(rng.integers(plen)), int(rng.integers(4)))
                       for _ in range(int(rng.integers(0, 3)))]))
    recs = [None] * N_READS
    for s in range(N_SHARDS):
        codes = np.asarray(shard_codes(s, slen))
        for k, (sh, p, isz, e1, e2) in enumerate(picks):
            if sh != s:
                continue
            r1 = codes[p:p + plen].copy()
            r2 = _COMP[codes[p + isz - plen:p + isz][::-1]].copy()
            while (r1 == BASE_N).any() or (r2 == BASE_N).any():
                p = int(rng.integers(0, slen - isz - 2))
                r1 = codes[p:p + plen].copy()
                r2 = _COMP[codes[p + isz - plen:p + isz][::-1]].copy()
            for pos, b in e1:
                r1[pos] = b
            for pos, b in e2:
                r2[pos] = b
            recs[2 * k] = SeqRecord(f"q{k}/1", _render(mode, r1))
            recs[2 * k + 1] = SeqRecord(f"q{k}/2", _render(mode, r2))
        del codes
    rpath = os.path.join(CACHE, f"hgrep_pairs_{mode}_{N_READS}.fa")
    with open(rpath, "w") as f:
        for r in recs:
            f.write(f">{r.name}\n{r.seq}\n")
    return recs, rpath


def main():
    arg = sys.argv[1] if len(sys.argv) > 1 else "cs"
    assert arg in ("ls", "cs", "ls-paired", "cs-paired")
    os.environ.setdefault("SHRIMP_TPU_PIPELINE_LANES", "32")
    paired = arg.endswith("-paired")
    mode = arg.split("-")[0]
    slen = HG_LEN // N_SHARDS

    # offline steps (cached): split-db bins + project-db indexes
    paths = [build_shard_index(i, mode, slen) for i in range(N_SHARDS)]
    if paired:
        recs, rpath = gen_pairs(mode, slen)
    else:
        recs, rpath = gen_reads(mode, slen)
    log(f"[reads] {N_READS} x {READ_LEN}bp {mode} reads ready"
        + (" (opp-in pairs)" if paired else ""))

    import shrimp_tpu.constants as C
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import (map_paired_sam_stream,
                                     map_unpaired_sam_stream)
    from shrimp_tpu.fastpath_cs import (map_paired_cs_sam_stream,
                                        map_unpaired_cs_sam_stream)
    from shrimp_tpu.index.build import GenomeIndex
    from shrimp_tpu.io import sam as samio
    from shrimp_tpu.mapper import Mapper
    from shrimp_tpu.tools.mergesam import merge_sam_files

    cfg = MapperConfig(mode=(C.MODE_COLOUR_SPACE if mode == "cs"
                             else C.MODE_LETTER_SPACE),
                       **(dict(pair_mode="opp-in", min_insert_size=0,
                               max_insert_size=1000) if paired else {}))
    if paired:
        stream_fn = (map_paired_cs_sam_stream if mode == "cs"
                     else map_paired_sam_stream)
    else:
        stream_fn = (map_unpaired_cs_sam_stream if mode == "cs"
                     else map_unpaired_sam_stream)

    def make_mapper(idx):
        if paired:
            from shrimp_tpu.paired import PairedMapper
            return PairedMapper(idx, cfg)
        return Mapper(idx, cfg)

    # warm the device kernels on shard 0 so compile time stays out of
    # the measurement (steady-state serving assumption, like every
    # other workload in bench_all.py)
    idx0 = GenomeIndex.load(paths[0])
    m0 = make_mapper(idx0)
    # cutoff + list-skew diagnostics (the README:1297-1305 behavior the
    # repeat-structured genome exists to reproduce): the auto cutoff
    # must actually trim, and the list-length distribution must show a
    # heavy tail, or the bench is measuring an unrealistically easy
    # genome
    cut = m0.cutoff
    ll = np.concatenate([si.list_lengths() for si in idx0.seeds])
    ll = ll[ll > 0]
    over = int((ll > cut).sum())
    pct_pos_trim = float(ll[ll > cut].sum()) / float(ll.sum()) * 100.0
    log(f"[skew] shard0 cutoff={cut}: {over} keys over cutoff "
        f"({pct_pos_trim:.1f}% of postings trimmed); list tail "
        f"p50={int(np.percentile(ll, 50))} p99={int(np.percentile(ll, 99))} "
        f"p99.9={int(np.percentile(ll, 99.9))} max={int(ll.max())}")
    assert over > 0, "auto cutoff never fires - genome has no list skew"
    del ll
    # warm at the exact batch geometry of the timed run — compiled
    # shapes depend on it, and a mismatched warm leaves the first
    # timed shard paying minutes of compiles
    warm = stream_fn(m0, recs[:8192 * 2], batch_size=8192)
    assert warm is not None, "fast path rejected the workload"
    for _ in warm:
        pass
    idx0.release()
    del m0, idx0
    log("[warm] kernels compiled")

    # timed span: mapping + merge. Index load-from-disk is logged but
    # excluded — the reference's reads/hour figure amortizes piece
    # loading over ~250M reads (README:113-114); at bench read counts
    # including it would measure the disk, not the mapper.
    sam_paths = []
    tspan = 0.0
    for i, p in enumerate(paths):
        tl = time.time()
        idx = GenomeIndex.load(p)
        m = make_mapper(idx)
        # prime this shard's genome planes into device HBM (part of the
        # piece-load cost the reference amortizes over ~250M reads,
        # README:113-114 — same bucket as the index load above)
        for _ in stream_fn(m, recs[:2048], batch_size=2048):
            pass
        log(f"[load] shard {i}: {time.time() - tl:.1f}s "
            f"(incl. device planes)")
        sp = os.path.join(CACHE, f"hg_shard{i}.{arg}.sam")
        nb = 0
        t0 = time.time()
        with open(sp, "wb") as f:
            hdr = "".join(
                line + "\n" for line in samio.sam_header(
                    idx, f"bench_hg shard{i}", cfg))
            f.write(hdr.encode())
            for chunk in stream_fn(m, recs, batch_size=8192):
                f.write(chunk)
                nb += len(chunk)
        dt = time.time() - t0
        tspan += dt
        sam_paths.append(sp)
        wpr = m.stats.vec_invocs / max(m.stats.reads, 1)
        log(f"[map] shard {i}: {dt:.1f}s ({nb / 1e6:.1f} MB SAM, "
            f"{wpr:.1f} candidate windows/read)")
        if os.environ.get("SHRIMP_TPU_HG_STAGES"):
            for nm2, secs in sorted(m.stats.stage_secs.items(),
                                    key=lambda kv: -kv[1]):
                log(f"    [stage] {nm2}: {secs:.1f}s (sum over lanes)")
        idx.release()
        del m, idx
    tmap = time.time()
    mpath = os.path.join(CACHE, f"hg_merged.{arg}.sam")
    with open(mpath, "w") as f:
        merge_sam_files(rpath, sam_paths, f)
    tspan += time.time() - tmap
    log(f"[merge] {time.time() - tmap:.1f}s")

    rate = N_READS / tspan
    # paired baseline: the reference claims paired maps ~2x faster than
    # unpaired (README:109-110), so compare against 2x the per-core rate
    base = BASELINE_CS * (2.0 if paired else 1.0)
    print(json.dumps({
        "metric": f"reads_per_sec_hgscale_{HG_LEN / 1e9:g}gbp_36bp_"
                  f"{'paired' if paired else 'unpaired'}_{mode}_splitdb",
        "value": round(rate, 1),
        "unit": "reads/s",
        "vs_baseline": round(rate / base, 2),
    }))


if __name__ == "__main__":
    main()
