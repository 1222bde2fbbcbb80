#!/usr/bin/env python
"""Benchmark: unpaired 36bp letter-space reads vs an E.coli-sized genome.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

vs_baseline compares against the reference gmapper's self-reported
single-core mapping rate on the same dataset (measured locally when the
reference binary can be built; otherwise a cached constant measured on
this machine class: ~18,300 reads/s/core on E.coli-scale data; the
README's 44 reads/s/core figure is for hg18-scale indexes).
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".bench_cache")
N_READS = int(os.environ.get("SHRIMP_TPU_BENCH_READS", "600000"))
READ_LEN = 36
GENOME_LEN = 4_600_000
FALLBACK_BASELINE = 18300.0


def get_dataset():
    os.makedirs(CACHE, exist_ok=True)
    gpath = os.path.join(CACHE, "ecoli.fa")
    npz = os.path.join(CACHE, "ecoli.idx.npz")
    rpath = os.path.join(CACHE, "reads.fa")
    rng = np.random.default_rng(20260816)
    codes = rng.integers(0, 4, GENOME_LEN).astype(np.uint8)
    if not os.path.exists(gpath):
        from shrimp_tpu.core.encode import decode_ls
        gs = decode_ls(codes)
        with open(gpath + ".tmp", "w") as f:
            f.write(">ecoli_synth\n")
            for i in range(0, len(gs), 70):
                f.write(gs[i:i + 70] + "\n")
        os.rename(gpath + ".tmp", gpath)
    from shrimp_tpu.index.build import GenomeIndex, build_index
    from shrimp_tpu.index.seeds import default_seeds
    if os.path.exists(npz):
        idx = GenomeIndex.load(npz)
    else:
        idx = build_index([("ecoli_synth", codes)], default_seeds())
        idx.save(npz)
        if not os.path.exists(npz) and os.path.exists(npz + ".npz"):
            os.rename(npz + ".npz", npz)
    comp = np.array([3, 2, 1, 0], np.uint8)
    # vectorized read synthesis (a python per-read loop costs ~30s at 600k)
    pos = rng.integers(0, GENOME_LEN - READ_LEN, N_READS)
    mat = codes[pos[:, None] + np.arange(READ_LEN)[None, :]].copy()
    nmut = rng.integers(0, 3, N_READS)
    for j in range(2):
        rows = np.nonzero(nmut > j)[0]
        mat[rows, rng.integers(0, READ_LEN, len(rows))] = \
            rng.integers(0, 4, len(rows)).astype(np.uint8)
    odd = np.arange(N_READS) % 2 == 1
    mat[odd] = comp[mat[odd, ::-1]]
    lut = np.frombuffer(b"ACGT", np.uint8)
    seqs = lut[mat].tobytes().decode()
    reads = [(f"r{k}", seqs[k * READ_LEN:(k + 1) * READ_LEN])
             for k in range(N_READS)]
    if not os.path.exists(rpath):
        with open(rpath + ".tmp", "w") as f:
            for n, r in reads:
                f.write(f">{n}\n{r}\n")
        os.rename(rpath + ".tmp", rpath)
    return idx, reads, gpath, rpath


def measure_baseline(gpath, rpath) -> float:
    """Single-core gmapper reads/s on (a subset of) the same dataset."""
    cache_file = os.path.join(CACHE, "baseline.json")
    if os.path.exists(cache_file):
        with open(cache_file) as f:
            return json.load(f)["reads_per_sec"]
    gm = None
    for cand in ("/tmp/refbuild/bin/gmapper-ls",):
        if os.path.exists(cand):
            gm = cand
    if gm is None and os.path.isdir("/root/reference"):
        try:
            import shutil
            if not os.path.isdir("/tmp/refbuild"):
                shutil.copytree("/root/reference", "/tmp/refbuild")
            subprocess.run(["make", "bin/gmapper", "-j8"], cwd="/tmp/refbuild",
                           check=True, capture_output=True, timeout=600)
            gm = "/tmp/refbuild/bin/gmapper-ls"
        except Exception:
            return FALLBACK_BASELINE
    if gm is None:
        return FALLBACK_BASELINE
    sub = os.path.join(CACHE, "reads5k.fa")
    if not os.path.exists(sub):
        with open(rpath) as fin, open(sub, "w") as fout:
            for i, line in enumerate(fin):
                if i >= 10000:
                    break
                fout.write(line)
    try:
        res = subprocess.run([gm, "-N", "1", "-E", sub, gpath],
                             capture_output=True, text=True, timeout=600)
        m = re.search(r"Reads per hour:\s+([\d,]+)", res.stderr)
        rate = float(m.group(1).replace(",", "")) / 3600.0
        with open(cache_file, "w") as f:
            json.dump({"reads_per_sec": rate}, f)
        return rate
    except Exception:
        return FALLBACK_BASELINE


def run_measurement():
    idx, reads, gpath, rpath = get_dataset()
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.io.fasta import SeqRecord
    from shrimp_tpu.io.sam import render_unpaired
    from shrimp_tpu.mapper import Mapper

    from shrimp_tpu.fastpath import map_unpaired_sam_stream

    cfg = MapperConfig()
    m = Mapper(idx, cfg)
    recs = [SeqRecord(n, s) for n, s in reads]
    bs = int(os.environ.get("SHRIMP_TPU_BENCH_BATCH", "8192"))
    # warmup: compile kernels at the exact batch geometry of the run and
    # fill every pipeline lane once, so the timed region is steady state
    warm = map_unpaired_sam_stream(m, recs[:bs * 2], batch_size=bs)
    if warm is not None:
        for _ in warm:
            pass
    else:
        m.map_unpaired(recs[:256])
    # the timed span is short next to setup, and throughput ramps over
    # the first passes (host page cache + lane fill). Run several
    # passes, treat the first two as ramp, and report the MEDIAN of the
    # post-warmup passes — best-of-N would inflate the headline as reps
    # grow.
    n_lines = 0
    pass_rates = []
    for rep in range(int(os.environ.get("SHRIMP_TPU_BENCH_REPS", "7"))):
        t0 = time.time()
        nl = 0
        gen = map_unpaired_sam_stream(m, recs, batch_size=bs)
        if gen is not None:
            for chunk in gen:
                nl += chunk.count(b"\n")
        else:
            for re_, hits in m.map_unpaired_stream(recs,
                                                   batch_size=len(recs)):
                for h in hits:
                    nl += 1
                    render_unpaired(re_, h, idx, cfg)
        dt = time.time() - t0
        n_lines = nl
        r = len(recs) / dt
        print(f"# pass {rep}: {r:.0f} reads/s", file=sys.stderr)
        pass_rates.append(r)
        if gen is None:
            break
    steady = pass_rates[2:] if len(pass_rates) > 2 else pass_rates
    rate = float(np.median(steady))

    baseline = measure_baseline(gpath, rpath)
    print(json.dumps({
        "metric": "reads_per_sec_ecoli_36bp_unpaired_ls",
        "value": round(rate, 1),
        "unit": "reads/s/chip",
        "vs_baseline": round(rate / baseline, 3),
    }))
    print(f"# mapped alignment lines: {n_lines}; baseline(1-core gmapper): "
          f"{baseline:.0f} reads/s", file=sys.stderr)


def main():
    """Run the measurement in a child process, so the parent stays off
    JAX and a hung run ends at its budget; a failed run exits non-zero
    and prints no result line."""
    if "--inner" in sys.argv:
        os.environ.setdefault("SHRIMP_TPU_PIPELINE_LANES", "32")
        os.environ.setdefault("SHRIMP_TPU_BENCH_BATCH", "16384")
        run_measurement()
        return
    budget = float(os.environ.get("SHRIMP_TPU_BENCH_BUDGET", "2100"))
    try:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--inner"],
            capture_output=True, text=True, timeout=budget)
    except subprocess.TimeoutExpired:
        sys.exit(f"# bench exceeded its {budget:.0f}s budget")
    sys.stderr.write(res.stderr[-2000:])
    out = [l for l in res.stdout.splitlines() if l.startswith("{")]
    if res.returncode != 0 or not out:
        sys.exit(f"# bench failed rc={res.returncode}")
    print(out[-1])


if __name__ == "__main__":
    main()
