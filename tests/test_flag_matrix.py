"""Flag-matrix golden fuzz: our CLI vs gmapper across option combos.

Each case maps the same reads/genome with one flag set through both
tools and requires byte-identical SAM bodies. This is the broad-parity
backstop behind the per-feature golden tests."""
import os
import subprocess
import sys

import pytest

from . import oracle

pytestmark = [pytest.mark.slow,
              pytest.mark.skipif(oracle.ensure_gmapper() is None,
                                reason="reference gmapper not available")]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    import random
    d = str(tmp_path_factory.mktemp("flagmx"))
    rng = random.Random(424242)
    g = "".join(rng.choice("ACGT") for _ in range(60000))
    with open(os.path.join(d, "genome.fa"), "w") as f:
        f.write(">chrX\n")
        for i in range(0, len(g), 70):
            f.write(g[i:i + 70] + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    with open(os.path.join(d, "u.fa"), "w") as f:
        for r in range(200):
            pos = rng.randrange(0, len(g) - 36)
            s = list(g[pos:pos + 36])
            for _ in range(rng.choice([0, 0, 1, 2, 3])):
                s[rng.randrange(36)] = rng.choice("ACGT")
            s = "".join(s)
            if rng.random() < 0.5:
                s = s.translate(comp)[::-1]
            f.write(f">u{r}\n{s}\n")
    with open(os.path.join(d, "p.fa"), "w") as f:
        for i in range(120):
            p = rng.randrange(0, len(g) - 400)
            isz = rng.randrange(100, 300)
            a = list(g[p:p + 36])
            b = list(g[p + isz - 36:p + isz])
            for s in (a, b):
                for _ in range(rng.choice([0, 0, 1, 2])):
                    s[rng.randrange(36)] = rng.choice("ACGT")
            r1 = "".join(a)
            r2 = "".join(b).translate(comp)[::-1]
            if rng.random() < 0.1:
                q = rng.randrange(0, len(g) - 36)
                r2 = g[q:q + 36]
            f.write(f">p{i}/1\n{r1}\n>p{i}/2\n{r2}\n")
    return d


UNPAIRED_CASES = [
    ("--max-alignments 2", None),
    ("-o 3", None),
    ("-w 120.0", None),
    ("-r 70.0", None),
    ("-h 60.0", "-h-threshold 60.0"),
    ("-m 11 -i -20", None),
    ("-g -40 -e -10", None),
    ("-q -40 -f -10", None),
    ("--trim-front 3", None),
    ("--trim-end 4", None),
    ("--strata -o 5", None),
    ("--local -t", None),
    ("-l 80.0", None),
    ("-n 1", None),
    ("-a 4", None),
    ("-s 1110111,1101101", None),
    ("--extra-sam-fields", None),
    ("--all-contigs", None),
    ("--single-best-mapping", None),
    # --- combo widening (r3): selection x window x scores interactions
    ("-o 3 --strata", None),
    ("-o 3 -w 120.0", None),
    ("-o 3 -r 70.0", None),
    ("--max-alignments 2 -w 120.0", None),
    ("--max-alignments 2 --strata", None),
    ("-m 12 -i -18 -h 55.0", "-m 12 -i -18 -h-threshold 55.0"),
    ("-w 110.0 -r 60.0", None),
    ("-n 2 -l 85.0", None),
    ("-n 1 -w 150.0", None),
    ("--local", None),
    ("-t", None),
    ("-z 3", None),
    ("-V", None),
    ("--no-mapping-qualities", None),
    ("--sam-unaligned", None),
    ("--sam-unaligned -o 2", None),
    ("--longest-read 300", None),
    ("--trim-front 2 --trim-end 2", None),
    ("--trim-front 5 --strata", None),
    ("--trim-end 3 -o 3", None),
    ("-s 111101011,110011011 -o 2", None),
    ("--single-best-mapping --strata", None),
    ("--all-contigs -o 3", None),
    # renderer-level flags now INSIDE the fast gate (r4): these cases
    # exercise the native renderer, not the generic fallback
    ("--read-group rg1,smp1", None),
    ("--read-group grp2,s2 --sam-unaligned", None),
    ("--all-contigs --sam-unaligned", None),
    ("--read-group g3,s3 -o 3 --strata", None),
    ("--extra-sam-fields --strata", None),
    ("-g -45 -e -5 -q -35 -f -9", None),
    ("-F", None),
    ("-C", None),
]

PAIRED_CASES = [
    ("-p opp-in -I 50,400", None),
    ("-p opp-in --strata", None),
    ("-p opp-in --max-alignments 1", None),
    ("-p opp-in --insert-size-dist 180,60", None),
    ("-p opp-in --no-improper-mappings", None),
    ("-p opp-in --trim-front 2", None),
    ("-p opp-in --trim-end 3", None),
    ("-p opp-in --trim-front 2 --trim-first", None),
    ("-p opp-out", None),
    ("-p col-fw", None),
    ("-p col-bw", None),
    # --- combo widening (r3): trim x pair-mode x selection
    ("-p opp-in -I 50,400 --strata", None),
    ("-p opp-in --trim-end 3 --trim-second", None),
    ("-p opp-in --trim-front 2 --trim-end 2", None),
    ("-p opp-in --trim-front 3 --trim-second", None),
    ("-p opp-in --sam-unaligned", None),
    ("-p opp-in --all-contigs", None),
    ("-p opp-in --no-mapping-qualities", None),
    ("-p opp-in -o 2", None),
    ("-p opp-in -n 4", None),
    ("-p opp-in -w 120.0", None),
    ("-p opp-in --no-half-paired", None),
    ("-p opp-in --no-half-paired --strata", None),
    ("-p opp-out --max-alignments 2", None),
    ("-p opp-out --trim-end 2", None),
    ("-p col-fw --strata", None),
    ("-p col-bw -o 2", None),
    ("-p opp-in -m 11 -i -20", None),
    ("-p opp-in --extra-sam-fields", None),
    # renderer-level flags inside the paired fast gate (r4)
    ("-p opp-in --sam-r2", None),
    ("-p opp-in --read-group prg,psm", None),
    ("-p opp-in --sam-r2 --sam-unaligned", None),
    ("-p opp-in --all-contigs --read-group pg2,ps2", None),
]


def _ours(dataset, flags, reads):
    from shrimp_tpu.cli import main
    out_path = os.path.join(dataset, "out.sam")
    old = sys.stdout
    with open(out_path, "w") as f:
        sys.stdout = f
        try:
            main(["map"] + flags.split()
                 + [os.path.join(dataset, reads),
                    os.path.join(dataset, "genome.fa")])
        finally:
            sys.stdout = old
    with open(out_path) as f:
        return [l.rstrip("\n") for l in f
                if l.strip() and not l.startswith("@")]


def _ref(dataset, flags, reads):
    res = subprocess.run(
        [os.path.join(oracle.BUILD_DIR, "bin", "gmapper-ls"), "-E"]
        + flags.split()
        + [os.path.join(dataset, reads), os.path.join(dataset, "genome.fa")],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-500:]
    return [l for l in res.stdout.splitlines()
            if l and not l.startswith("@")]


@pytest.mark.parametrize("gflags,oflags", UNPAIRED_CASES)
def test_flag_matrix_unpaired(dataset, gflags, oflags):
    want = _ref(dataset, gflags, "u.fa")
    got = _ours(dataset, oflags or gflags, "u.fa")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


@pytest.mark.parametrize("gflags,oflags", PAIRED_CASES)
def test_flag_matrix_paired(dataset, gflags, oflags):
    want = _ref(dataset, gflags, "p.fa")
    got = _ours(dataset, oflags or gflags, "p.fa")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


@pytest.fixture(scope="module")
def cs_dataset(tmp_path_factory):
    import random
    d = str(tmp_path_factory.mktemp("flagmx_cs"))
    rng = random.Random(888)
    g = "".join(rng.choice("ACGT") for _ in range(60000))
    with open(os.path.join(d, "genome.fa"), "w") as f:
        f.write(">chrX\n")
        for i in range(0, len(g), 70):
            f.write(g[i:i + 70] + "\n")
    l2n = {c: i for i, c in enumerate("ACGT")}
    comp = str.maketrans("ACGT", "TGCA")

    def tocs(s):
        return "T" + str(l2n["T"] ^ l2n[s[0]]) + "".join(
            str(l2n[s[i]] ^ l2n[s[i + 1]]) for i in range(len(s) - 1))

    fa = open(os.path.join(d, "pc.fa"), "w")
    fq = open(os.path.join(d, "pc.fastq"), "w")
    for i in range(100):
        p = rng.randrange(0, len(g) - 400)
        isz = rng.randrange(100, 300)
        a = list(g[p:p + 36])
        b = list(g[p + isz - 36:p + isz])
        for s in (a, b):
            for _ in range(rng.choice([0, 0, 1])):
                s[rng.randrange(36)] = rng.choice("ACGT")
        r1 = "".join(a)
        r2 = "".join(b).translate(comp)[::-1]
        if rng.random() < 0.12:
            q = rng.randrange(0, len(g) - 36)
            r2 = g[q:q + 36]
        c1, c2 = tocs(r1), tocs(r2)
        fa.write(f">x{i}/1\n{c1}\n>x{i}/2\n{c2}\n")
        for nm, cs in ((f"x{i}/1", c1), (f"x{i}/2", c2)):
            qs = "".join(chr(33 + rng.randrange(3, 41))
                         for _ in range(len(cs) - 1))
            fq.write(f"@{nm}\n{cs}\n+\n{qs}\n")
    fa.close()
    fq.close()
    ucfa = open(os.path.join(d, "uc.fa"), "w")
    ucfq = open(os.path.join(d, "uc.fastq"), "w")
    for r in range(150):
        pos = rng.randrange(0, len(g) - 36)
        s = list(g[pos:pos + 36])
        for _ in range(rng.choice([0, 0, 1, 2])):
            s[rng.randrange(36)] = rng.choice("ACGT")
        s = "".join(s)
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        cs = tocs(s)
        ucfa.write(f">c{r}\n{cs}\n")
        qs = "".join(chr(33 + rng.randrange(2, 41))
                     for _ in range(len(cs) - 1))
        ucfq.write(f"@c{r}\n{cs}\n+\n{qs}\n")
    ucfa.close()
    ucfq.close()
    return d


CS_PAIRED_CASES = [
    ("-p opp-in", None),
    ("-p opp-in --strata", None),
    ("-p opp-in -x -18", None),
    ("-p opp-in --no-half-paired", None),
    ("-p opp-in --trim-end 2", None),
    ("-p col-fw", None),
    # --- r3 widening: trim x pair-mode x CS
    ("-p opp-in --trim-end 2 --trim-second", None),
    ("-p opp-in --trim-end 3 --trim-first", None),
    ("-p opp-in -o 2", None),
    ("-p opp-in --no-mapping-qualities", None),
    ("-p opp-in --sam-unaligned", None),
    ("-p col-bw", None),
    ("-p col-fw --strata", None),
    ("-p opp-out --trim-end 2", None),
]

CS_PAIRED_FASTQ_CASES = [
    ("-p opp-in", None),
    ("-p opp-in --strata", None),
    ("-p opp-in --ignore-qvs", None),
    ("-p opp-in --max-alignments 1", None),
    ("-p opp-out", None),
    # --- r3 widening
    ("-p opp-in --trim-end 2", None),
    ("-p opp-in --trim-end 2 --trim-second", None),
    # deeper trim: mate-1 post_sw reads past the planted NUL into the
    # original qual bytes (trim_read strlen(seq) quirk, gmapper.c:270);
    # --trim-front is rejected outright in CS mode (gmapper.c:2135)
    ("-p opp-in --trim-end 3", None),
    ("-p opp-in --min-avg-qv 15", None),
    ("-p opp-in --qv-offset 33", None),
    ("-p col-fw --ignore-qvs", None),
    # renderer-level flags inside the CS paired fast gate (r4)
    ("-p opp-in --sam-r2", None),
    ("-p opp-in --read-group cpg,cps --sam-unaligned", None),
    ("-p opp-in --all-contigs", None),
]

CS_UNPAIRED_CASES = [
    ("", None),
    ("--max-alignments 2", None),
    ("-o 3", None),
    ("--strata -o 5", None),
    ("-x -18", None),
    ("-n 1", None),
    ("-w 120.0", None),
    # --- r3 widening
    ("-o 2 --strata", None),
    ("-x -16 -o 3", None),
    ("--trim-end 2", None),
    ("--trim-end 3 --strata", None),
    ("--sam-unaligned", None),
    ("--local -t", None),
    ("--bfast", None),
    # renderer-level flags inside the CS fast gate (r4)
    ("--all-contigs", None),
    ("--read-group csg,css", None),
    ("--read-group csg2,cs2 --sam-unaligned", None),
]

# CS unpaired over fastq: qv-derived crossover scores, QUAL/CQ columns,
# min-avg-qv drops, per-base post-SW qualities — the native cspipe path
CS_UNPAIRED_FASTQ_CASES = [
    ("", None),
    ("--strata", None),
    ("--ignore-qvs", None),
    ("--min-avg-qv 15", None),
    ("--qv-offset 33", None),
    ("--trim-end 2", None),
    ("-o 3", None),
    ("--max-alignments 2", None),
    ("--sam-unaligned", None),
    ("--bfast", None),
]


@pytest.mark.parametrize("gflags,oflags", CS_UNPAIRED_FASTQ_CASES)
def test_flag_matrix_cs_unpaired_fastq(cs_dataset, gflags, oflags):
    want = _ref_cs(cs_dataset, gflags, "uc.fastq")
    got = _ours(cs_dataset, ("--cs " + (oflags or gflags)).strip(),
                "uc.fastq")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


def _ref_cs(dataset, flags, reads):
    res = subprocess.run(
        [os.path.join(oracle.BUILD_DIR, "bin", "gmapper-cs"), "-E"]
        + flags.split()
        + [os.path.join(dataset, reads), os.path.join(dataset, "genome.fa")],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-500:]
    return [l for l in res.stdout.splitlines()
            if l and not l.startswith("@")]


@pytest.mark.parametrize("gflags,oflags", CS_PAIRED_CASES)
def test_flag_matrix_cs_paired(cs_dataset, gflags, oflags):
    want = _ref_cs(cs_dataset, gflags, "pc.fa")
    got = _ours(cs_dataset, "--cs " + (oflags or gflags), "pc.fa")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


@pytest.mark.parametrize("gflags,oflags", CS_PAIRED_FASTQ_CASES)
def test_flag_matrix_cs_paired_fastq(cs_dataset, gflags, oflags):
    want = _ref_cs(cs_dataset, gflags, "pc.fastq")
    got = _ours(cs_dataset, "--cs " + (oflags or gflags), "pc.fastq")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


@pytest.mark.parametrize("gflags,oflags", CS_UNPAIRED_CASES)
def test_flag_matrix_cs_unpaired(cs_dataset, gflags, oflags):
    want = _ref_cs(cs_dataset, gflags, "uc.fa")
    got = _ours(cs_dataset, ("--cs " + (oflags or gflags)).strip(),
                "uc.fa")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


# ===================================================================
# r3 widening: N/IUPAC contigs, reads with Ns, qv edge cases
# (the bit-identity claim must not rest on clean
# ACGT-only input; N windows are skipped at index build,
# genome.c:1145-1147, N read bases never match, and fastq qv handling
# has its own corner semantics, gmapper.c:440-492)
# ===================================================================

@pytest.fixture(scope="module")
def n_dataset(tmp_path_factory):
    import random
    d = str(tmp_path_factory.mktemp("flagmx_n"))
    rng = random.Random(77177)
    # genome: ACGT with N runs and scattered IUPAC codes
    g = list("".join(rng.choice("ACGT") for _ in range(60000)))
    for _ in range(14):                       # N runs, 20-300bp
        p = rng.randrange(0, len(g) - 400)
        for i in range(p, p + rng.randrange(20, 300)):
            g[i] = "N"
    for _ in range(120):                      # lone IUPAC codes
        g[rng.randrange(len(g))] = rng.choice("RYSWKMBDHV")
    g = "".join(g)
    with open(os.path.join(d, "genome.fa"), "w") as f:
        f.write(">chrN\n")
        for i in range(0, len(g), 70):
            f.write(g[i:i + 70] + "\n")
    comp = str.maketrans("ACGTN", "TGCAN")
    with open(os.path.join(d, "u.fa"), "w") as f:
        for r in range(200):
            pos = rng.randrange(0, len(g) - 36)
            s = list(g[pos:pos + 36].upper())
            # normalize IUPAC genome chars in the read to bases
            s = [c if c in "ACGTN" else rng.choice("ACGT") for c in s]
            for _ in range(rng.choice([0, 0, 1, 2])):
                s[rng.randrange(36)] = rng.choice("ACGT")
            if rng.random() < 0.25:           # reads with Ns
                for _ in range(rng.randrange(1, 4)):
                    s[rng.randrange(36)] = "N"
            s = "".join(s)
            if rng.random() < 0.5:
                s = s.translate(comp)[::-1]
            f.write(f">n{r}\n{s}\n")
    # fastq with qv edge cases: minimum/maximum PHRED, trailing 'B'
    # (Illumina low-quality marker, gmapper.c:440-453), low-avg reads.
    # LS-mode gmapper defaults to PHRED+64 when no offset is given, so
    # the dataset is PHRED+64 ('B' = qv 2, the historical marker).
    with open(os.path.join(d, "u.fastq"), "w") as f:
        for r in range(160):
            pos = rng.randrange(0, len(g) - 36)
            s = "".join(c if c in "ACGTN" else rng.choice("ACGT")
                        for c in g[pos:pos + 36].upper())
            if rng.random() < 0.5:
                s = s.translate(comp)[::-1]
            kind = r % 4
            if kind == 0:     # ordinary
                q = "".join(chr(64 + rng.randrange(3, 41))
                            for _ in range(36))
            elif kind == 1:   # trailing Illumina 'B' run
                k = rng.randrange(4, 20)
                q = "".join(chr(64 + rng.randrange(20, 41))
                            for _ in range(36 - k)) + "B" * k
            elif kind == 2:   # very low average qv
                q = "".join(chr(64 + rng.randrange(0, 6))
                            for _ in range(36))
            else:             # extremes of the accepted range
                q = "".join(chr(64 + rng.choice([0, 0, 40, 40, 1, 39]))
                            for _ in range(36))
            f.write(f"@fq{r}\n{s}\n+\n{q}\n")
    return d


N_UNPAIRED_CASES = [
    ("", None),
    ("-o 3", None),
    ("-w 120.0", None),
    ("-n 1", None),
    ("--strata -o 5", None),
    ("--sam-unaligned", None),
    ("--local -t", None),
    ("--trim-front 3 --trim-end 2", None),
    ("-s 1110111", None),
    ("--max-alignments 2", None),
    ("-a 4", None),
    ("-r 60.0", None),
    ("--all-contigs", None),
]

FASTQ_QV_CASES = [
    ("", None),
    ("--trim-illumina", None),
    ("--trim-illumina --strata", None),
    ("--min-avg-qv 20", None),
    ("--min-avg-qv 20 --sam-unaligned", None),
    ("--ignore-qvs", None),
    ("--qv-offset 64", None),
    ("--trim-end 2", None),
    ("--trim-illumina --trim-end 3", None),
    ("--min-avg-qv 3", None),
]


@pytest.mark.parametrize("gflags,oflags", N_UNPAIRED_CASES)
def test_flag_matrix_n_iupac(n_dataset, gflags, oflags):
    want = _ref(n_dataset, gflags, "u.fa")
    got = _ours(n_dataset, oflags if oflags is not None else gflags,
                "u.fa")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


@pytest.mark.parametrize("gflags,oflags", FASTQ_QV_CASES)
def test_flag_matrix_fastq_qv(n_dataset, gflags, oflags):
    want = _ref(n_dataset, gflags, "u.fastq")
    got = _ours(n_dataset, oflags if oflags is not None else gflags,
                "u.fastq")
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))


# CS reads containing '.' (missing colour) — scores 0, sw-full-cs.c:357
@pytest.fixture(scope="module")
def cs_dot_reads(cs_dataset):
    import random
    rng = random.Random(5150)
    src = open(os.path.join(cs_dataset, "uc.fa")).read().splitlines()
    out = os.path.join(cs_dataset, "ucn.fa")
    with open(out, "w") as f:
        for i in range(0, len(src), 2):
            nm, cs = src[i], list(src[i + 1])
            if rng.random() < 0.3:
                for _ in range(rng.randrange(1, 3)):
                    cs[rng.randrange(1, len(cs))] = "."
            f.write(f"{nm}\n{''.join(cs)}\n")
    return "ucn.fa"


CS_DOT_CASES = [
    ("", None),
    ("-o 3", None),
    ("--strata", None),
    ("--sam-unaligned", None),
]


@pytest.mark.parametrize("gflags,oflags", CS_DOT_CASES)
def test_flag_matrix_cs_dot_colours(cs_dataset, cs_dot_reads, gflags,
                                    oflags):
    want = _ref_cs(cs_dataset, gflags, cs_dot_reads)
    got = _ours(cs_dataset, ("--cs " + (oflags if oflags is not None
                                        else gflags)).strip(),
                cs_dot_reads)
    assert got == want, (f"[{gflags}]\n" + "\n".join(got[:3])
                         + "\n---\n" + "\n".join(want[:3]))
