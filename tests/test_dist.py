"""Multi-host distribution (parallel/dist.py): 2 jax.distributed
processes x 4 virtual CPU devices each, per-process sub-indexes only
(no process holds more than half the genome's CSR), cross-host window
allgather + z1 psum over the global mesh. Rank 0's ordered SAM must be
byte-identical to the single-process whole-index run — the reference's
own correctness criterion for its multi-machine split/merge workflow
(/root/reference/SPLITTING_AND_MERGING:1-160, README:281-303).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

HERE = os.path.dirname(os.path.abspath(__file__))
CLEN = 16 * 2048          # region-aligned (see test_sharded_index)
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def make_dataset():
    """Deterministic 8-contig genome + 200 reads, shared between the
    oracle run here and the distributed workers."""
    from shrimp_tpu.core import encode
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(331)
    contigs, gs = [], []
    for c in range(8):
        g = "".join(rng.choice(list("ACGT"), CLEN))
        gs.append(g)
        contigs.append((f"chr{c}", encode.encode_ls(g)))
    reads = []
    for k in range(200):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - 36))
        r = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        if k % 3 == 0:
            r = "".join(COMP[c] for c in reversed(r))
        reads.append(SeqRecord(f"dr{k}", r))
    return contigs, reads


def make_paired_dataset():
    """8-contig genome + 120 opp-in pairs (1 in 9 discordant, so the
    half-paired fallback and leg-prior classes are exercised)."""
    from shrimp_tpu.core import encode
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(733)
    contigs, gs = [], []
    for c in range(8):
        g = "".join(rng.choice(list("ACGT"), CLEN))
        gs.append(g)
        contigs.append((f"chr{c}", encode.encode_ls(g)))
    reads = []
    for k in range(120):
        src = gs[k % len(gs)]
        isz = int(rng.integers(90, 200))
        p = int(rng.integers(0, len(src) - isz - 1))
        r1 = src[p:p + 36]
        r2 = "".join(COMP[c]
                     for c in reversed(src[p + isz - 36:p + isz]))
        if k % 9 == 0:
            q = int(rng.integers(0, len(src) - 36))
            r2 = src[q:q + 36]
        reads.append(SeqRecord(f"dp{k}/1", r1))
        reads.append(SeqRecord(f"dp{k}/2", r2))
    return contigs, reads


def make_long_dataset():
    """8-contig genome + 24 LONG reads (800bp, window 1120 — G past
    the old 1023 packed-IO ceiling): gmapper maps --longest-read
    1000 on any cluster member (gmapper.c:1823-1829); the widened
    14-bit-glen packed layout carries these through the multi-host
    fused launch."""
    from shrimp_tpu.core import encode
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(557)
    contigs, gs = [], []
    for c in range(8):
        g = "".join(rng.choice(list("ACGT"), CLEN))
        gs.append(g)
        contigs.append((f"chr{c}", encode.encode_ls(g)))
    RL = 800
    reads = []
    for k in range(24):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - RL))
        r = list(src[p:p + RL])
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, RL))] = "ACGT"[int(rng.integers(0, 4))]
        r = "".join(r)
        if k % 3 == 0:
            r = "".join(COMP[c] for c in reversed(r))
        reads.append(SeqRecord(f"lr{k}", r))
    return contigs, reads


def _tocs(s):
    l2n = {c: i for i, c in enumerate("ACGT")}
    return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
        str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))


def make_cs_dataset_dist():
    """8-contig genome + 160 colour-space reads (36 colours)."""
    from shrimp_tpu.core import encode
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(839)
    contigs, gs = [], []
    for c in range(8):
        g = "".join(rng.choice(list("ACGT"), CLEN))
        gs.append(g)
        contigs.append((f"chr{c}", encode.encode_ls(g)))
    reads = []
    for k in range(160):
        src = gs[k % len(gs)]
        p = int(rng.integers(0, len(src) - 36))
        s = list(src[p:p + 36])
        for _ in range(int(rng.integers(0, 2))):
            s[int(rng.integers(0, 36))] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if k % 3 == 0:
            s = "".join(COMP[c] for c in reversed(s))
        reads.append(SeqRecord(f"dc{k}", _tocs(s)))
    return contigs, reads


def make_cs_paired_dataset():
    """8-contig genome + 100 opp-in CS pairs (1 in 9 discordant)."""
    from shrimp_tpu.core import encode
    from shrimp_tpu.io.fasta import SeqRecord
    rng = np.random.default_rng(941)
    contigs, gs = [], []
    for c in range(8):
        g = "".join(rng.choice(list("ACGT"), CLEN))
        gs.append(g)
        contigs.append((f"chr{c}", encode.encode_ls(g)))
    reads = []
    for k in range(100):
        src = gs[k % len(gs)]
        isz = int(rng.integers(100, 220))
        p = int(rng.integers(0, len(src) - isz - 1))
        a = list(src[p:p + 36])
        b = list(src[p + isz - 36:p + isz])
        for s in (a, b):
            for _ in range(int(rng.integers(0, 3))):
                s[int(rng.integers(36))] = "ACGT"[int(rng.integers(4))]
        r1 = _tocs("".join(a))
        r2 = _tocs("".join(COMP[c] for c in reversed(b)))
        if k % 9 == 0:
            q = int(rng.integers(0, len(src) - 36))
            r2 = _tocs(src[q:q + 36])
        reads.append(SeqRecord(f"dcp{k}/1", r1))
        reads.append(SeqRecord(f"dcp{k}/2", r2))
    return contigs, reads


def _run_workers(tmp_path, mode, timeout=480):
    port = 11000 + (os.getpid() * 7
                    + ["unpaired", "paired", "cs", "cs-paired",
                       "rs", "rs-paired", "long"].index(mode) * 131) % 20000
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    outs = [str(tmp_path / f"w{mode}{p}.sam") for p in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "dist_worker.py"),
         str(p), "2", str(port), outs[p], mode],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(2)]
    logs = []
    for pr in procs:
        try:
            so, se = pr.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((pr.returncode, so.decode(), se.decode()[-3000:]))
    for rc, so, se in logs:
        assert rc == 0, f"worker failed rc={rc}\n{so}\n{se}"
    return outs


def test_two_process_dist_paired_byte_identical(tmp_path):
    """Paired multi-host: each process owns 4 of 8 sub-indexes, the
    paired class statistics (z1/z2/z3/insert denominator, z4 leg
    priors, pair prior) merge via the zpair collective over the global
    mesh, and both ranks' SAM is byte-identical to the single-process
    whole-index paired run."""
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_paired_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.paired import PairedMapper
    contigs, reads = make_paired_dataset()
    idx = build_index(contigs, default_seeds())
    cfg = MapperConfig(pair_mode="opp-in", min_insert_size=60,
                       max_insert_size=240)
    want = b"".join(map_paired_sam_stream(PairedMapper(idx, cfg), reads,
                                          batch_size=100, lanes=1))
    outs = _run_workers(tmp_path, "paired")
    assert open(outs[0], "rb").read() == want
    assert open(outs[1], "rb").read() == want
    meta = json.load(open(outs[0] + ".meta"))
    assert meta["z1_max"] > 0.0   # the cross-host zpair psum ran


def test_two_process_read_sharding_byte_identical(tmp_path):
    """Read-axis data parallelism: each rank
    finalizes + renders only its 1/P read slice, slices are exchanged
    and concatenated in rank order, and the assembled stream is
    byte-identical to the single-process run on BOTH ranks. The render
    work really splits: each rank's rendered job count is a strict
    fraction of the two ranks' total."""
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_unpaired_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    contigs, reads = make_dataset()
    idx = build_index(contigs, default_seeds())
    cfg = MapperConfig()
    want = b"".join(map_unpaired_sam_stream(Mapper(idx, cfg), reads,
                                            batch_size=100, lanes=1))
    outs = _run_workers(tmp_path, "rs")
    assert open(outs[0], "rb").read() == want
    assert open(outs[1], "rb").read() == want
    metas = [json.load(open(o + ".meta")) for o in outs]
    j0, j1 = metas[0]["slice_jobs"], metas[1]["slice_jobs"]
    assert j0 > 0 and j1 > 0
    # each rank selected+expanded+rendered a strict share of the jobs
    # (slice_select: pass1, the vec gate, expansion and render all run
    # on the rank's read slice only), roughly balanced
    assert max(j0, j1) <= 0.75 * (j0 + j1), (j0, j1)
    # ... and filter 1 itself split along the shard axis: each rank
    # generated windows only from its LOCAL sub-indexes
    f0 = metas[0]["f1_local_windows"]
    f1w = metas[1]["f1_local_windows"]
    assert f0 > 0 and f1w > 0
    assert max(f0, f1w) <= 0.75 * (f0 + f1w), (f0, f1w)


def test_two_process_read_sharding_paired_byte_identical(tmp_path):
    """Read-sharded paired: the native paired brain runs per-rank only
    for its pair slice; assembled output byte-identical on both ranks
    and the window workload splits between ranks."""
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_paired_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.paired import PairedMapper
    contigs, reads = make_paired_dataset()
    idx = build_index(contigs, default_seeds())
    cfg = MapperConfig(pair_mode="opp-in", min_insert_size=60,
                       max_insert_size=240)
    want = b"".join(map_paired_sam_stream(PairedMapper(idx, cfg), reads,
                                          batch_size=100, lanes=1))
    outs = _run_workers(tmp_path, "rs-paired")
    assert open(outs[0], "rb").read() == want
    assert open(outs[1], "rb").read() == want
    metas = [json.load(open(o + ".meta")) for o in outs]
    j0, j1 = metas[0]["slice_jobs"], metas[1]["slice_jobs"]
    assert j0 > 0 and j1 > 0
    assert max(j0, j1) <= 0.75 * (j0 + j1), (j0, j1)


def test_two_process_dist_cs_byte_identical(tmp_path):
    """Multi-host colour space (the flagship 36bp-CS workload on the
    flagship distribution tier): per-local-shard CS filter 1, cross-host window allgather, global-mesh fused CS
    launch, owner-host window arena for the post-SW eval. Both ranks'
    SAM must be byte-identical to the single-process CS fast path."""
    from shrimp_tpu import constants as C
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath_cs import map_unpaired_cs_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    contigs, reads = make_cs_dataset_dist()
    idx = build_index(contigs, default_seeds(mode="cs"), mode="cs")
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE)
    want = b"".join(map_unpaired_cs_sam_stream(Mapper(idx, cfg), reads,
                                               batch_size=100, lanes=1))
    assert want.count(b"\n") >= 150
    outs = _run_workers(tmp_path, "cs")
    assert open(outs[0], "rb").read() == want
    assert open(outs[1], "rb").read() == want


def test_two_process_dist_cs_paired_byte_identical(tmp_path):
    """Multi-host CS paired: the paired class statistics merge via the
    zpair collective over the global mesh (ext_in, pairedpipe.cpp CS
    mode); both ranks byte-identical to the single-process CS paired
    fast path — gmapper-cs per chunk + mergesam as one program."""
    from shrimp_tpu import constants as C
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath_cs import map_paired_cs_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.paired import PairedMapper
    contigs, reads = make_cs_paired_dataset()
    idx = build_index(contigs, default_seeds(mode="cs"), mode="cs")
    cfg = MapperConfig(mode=C.MODE_COLOUR_SPACE, pair_mode="opp-in")
    gen = map_paired_cs_sam_stream(PairedMapper(idx, cfg), reads,
                                   batch_size=100, lanes=1)
    assert gen is not None
    want = b"".join(gen)
    assert want.count(b"\n") >= 100
    outs = _run_workers(tmp_path, "cs-paired")
    assert open(outs[0], "rb").read() == want
    assert open(outs[1], "rb").read() == want
    meta = json.load(open(outs[0] + ".meta"))
    assert meta["z1_max"] > 0.0   # the cross-host zpair collective ran


def test_two_process_dist_byte_identical(tmp_path):
    # oracle: single-process whole-index fast path
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_unpaired_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    contigs, reads = make_dataset()
    idx = build_index(contigs, default_seeds())
    cfg = MapperConfig()
    want = b"".join(map_unpaired_sam_stream(Mapper(idx, cfg), reads,
                                            batch_size=100, lanes=1))

    port = 11000 + os.getpid() % 20000
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    outs = [str(tmp_path / f"w{p}.sam") for p in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "dist_worker.py"),
         str(p), "2", str(port), outs[p]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(2)]
    logs = []
    for pr in procs:
        try:
            so, se = pr.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((pr.returncode, so.decode(), se.decode()[-3000:]))
    for rc, so, se in logs:
        assert rc == 0, f"worker failed rc={rc}\n{so}\n{se}"

    got0 = open(outs[0], "rb").read()
    got1 = open(outs[1], "rb").read()
    assert got0 == want           # rank 0 byte-identical to whole run
    assert got1 == want           # every rank renders the same bytes
    meta = json.load(open(outs[0] + ".meta"))
    assert meta["z1_max"] > 0.0   # the cross-host psum really ran


def test_two_process_dist_long_reads_byte_identical(tmp_path):
    """Multi-host LONG reads: 1200bp reads with
    ~1680-base windows ride the widened packed-IO layout (14-bit glen,
    12-bit stats positions) through the global-mesh fused launch; both
    ranks' SAM byte-identical to the single-process run — matching
    gmapper --longest-read on any cluster member (gmapper.c:1823-1829).
    """
    from shrimp_tpu.config import MapperConfig
    from shrimp_tpu.fastpath import map_unpaired_sam_stream
    from shrimp_tpu.index.build import build_index
    from shrimp_tpu.index.seeds import default_seeds
    from shrimp_tpu.mapper import Mapper
    contigs, reads = make_long_dataset()
    idx = build_index(contigs, default_seeds())
    cfg = MapperConfig(longest_read_len=1000)
    want = b"".join(map_unpaired_sam_stream(Mapper(idx, cfg), reads,
                                            batch_size=24, lanes=1))
    assert want.count(b"\n") >= 20      # the long reads actually map
    outs = _run_workers(tmp_path, "long", timeout=1200)
    assert open(outs[0], "rb").read() == want
    assert open(outs[1], "rb").read() == want
