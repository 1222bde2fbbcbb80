"""CLI parity long tail: -1/-2 split mate files, --sam-header* overrides,
-P pretty print, --bfast CS base quals, --use-regions toggle
(gmapper.c:356-376, 2968-3014, output.c:283-290, 581-612)."""
import subprocess
import sys

import numpy as np
import pytest

from . import oracle
from .test_e2e_paired import make_paired_dataset
from .test_e2e_unpaired import make_dataset


def run_cli(args, cwd=None):
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": "/root/repo"}
    import os
    env.update({k: v for k, v in os.environ.items()
                if k not in env})
    r = subprocess.run([sys.executable, "-m", "shrimp_tpu.cli", "map"]
                       + args, capture_output=True, text=True, env=env,
                       cwd=cwd, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


pytestmark = [pytest.mark.slow,
              pytest.mark.skipif(oracle.ensure_gmapper() is None,
                                reason="reference gmapper not available")]


def test_split_mate_files(tmp_path):
    gpath, rpath, g, reads = make_paired_dataset(str(tmp_path),
                                                 mode="opp-in")
    left, right = str(tmp_path / "l.fa"), str(tmp_path / "r.fa")
    with open(left, "w") as f1, open(right, "w") as f2:
        for k, (n, s) in enumerate(reads):
            (f1 if k % 2 == 0 else f2).write(f">{n}\n{s}\n")
    want = oracle.sam_body(oracle.run_gmapper(
        ["-E", "-p", "opp-in", "-1", left, "-2", right, gpath]))
    got = [l for l in run_cli(["-p", "opp-in", "-1", left, "-2", right,
                               gpath]).splitlines()
           if not l.startswith("@")]
    assert got == want and got


def test_sam_header_overrides(tmp_path):
    gpath, rpath, g, reads = make_dataset(str(tmp_path), n_reads=5)
    hd = tmp_path / "hd.txt"
    hd.write_text("@HD\tVN:1.5\tSO:coordinate\n")
    pg = tmp_path / "pg.txt"
    pg.write_text("@CO\tcustom\n")
    out = run_cli(["--sam-header-hd", str(hd), "--sam-header-pg", str(pg),
                   rpath, gpath])
    hdr = [l for l in out.splitlines() if l.startswith("@")]
    assert hdr[0] == "@HD\tVN:1.5\tSO:coordinate"
    assert hdr[-1] == "@CO\tcustom"
    whole = tmp_path / "whole.txt"
    whole.write_text("@HD\tVN:9\n@CO\tonly\n")
    out = run_cli(["--sam-header", str(whole), rpath, gpath])
    hdr = [l for l in out.splitlines() if l.startswith("@")]
    assert hdr == ["@HD\tVN:9", "@CO\tonly"]


def test_pretty_print_matches(tmp_path):
    gpath, rpath, g, reads = make_dataset(str(tmp_path), n_reads=40)
    want = oracle.run_gmapper(["-P", rpath, gpath]).splitlines()
    got = run_cli(["--shrimp-format", "-P", rpath, gpath]).splitlines()
    assert got == want and any(l.startswith("G:") for l in got)


def _cs_fastq(tmp_path, g, rng, n=60, L=40):
    enc = {"A": 0, "C": 1, "G": 2, "T": 3}
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    path = str(tmp_path / "reads_cs.fq")
    with open(path, "w") as f:
        for i in range(n):
            p = int(rng.integers(0, len(g) - L))
            s = list(g[p:p + L])
            for _ in range(int(rng.integers(0, 3))):
                s[int(rng.integers(L))] = str(rng.choice(list("ACGT")))
            if rng.random() < 0.5:
                s = [comp[c] for c in reversed(s)]
            prev, cols = "T", []
            for c in s:
                cols.append(str(enc[prev] ^ enc[c]))
                prev = c
            qual = "".join(chr(33 + int(rng.integers(5, 40)))
                           for _ in range(L))
            f.write(f"@c{i:03d}\nT{''.join(cols)}\n+\n{qual}\n")
    return path


def test_bfast_quals_match(tmp_path):
    gpath, rpath, g, reads = make_dataset(str(tmp_path), n_reads=5)
    rng = np.random.default_rng(17)
    fq = _cs_fastq(tmp_path, g, rng)
    want = oracle.sam_body(oracle.run_gmapper(
        ["-E", "-Q", "--bfast", fq, gpath], mode="cs"))
    got = [l for l in run_cli(["--cs", "--fastq", "--bfast", fq,
                               gpath]).splitlines()
           if not l.startswith("@")]
    assert got == want and got


def test_use_regions_toggle_matches(tmp_path):
    gpath, rpath, g, reads = make_dataset(str(tmp_path), n_reads=40)
    want = oracle.sam_body(oracle.run_gmapper(
        ["-E", "--use-regions", rpath, gpath]))
    got = [l for l in run_cli(["--use-regions", rpath, gpath]).splitlines()
           if not l.startswith("@")]
    assert got == want and got


def test_cli_E_and_L_flags(tmp_path, capsys):
    """gmapper drop-in flags: -E (SAM output; our default) is accepted,
    and -L loads a saved index by path or prefix (gmapper.c -L)."""
    import numpy as np
    from shrimp_tpu.cli import main as cli_main
    rng = np.random.default_rng(5150)
    g = "".join(rng.choice(list("ACGT"), 4000))
    gp = tmp_path / "g.fa"
    gp.write_text(">c\n" + g + "\n")
    rp = tmp_path / "r.fa"
    rp.write_text(">r0\n" + g[100:136] + "\n")
    idxp = tmp_path / "saved"
    assert cli_main(["index", str(gp), "-o", str(idxp)]) == 0
    assert cli_main(["map", "-E", "-L", str(idxp), str(rp)]) == 0
    out_l = [l for l in capsys.readouterr().out.splitlines()
             if l and not l.startswith("@")]
    assert cli_main(["map", str(rp), str(gp)]) == 0
    out_g = [l for l in capsys.readouterr().out.splitlines()
             if l and not l.startswith("@")]
    assert out_l == out_g and len(out_l) == 1


def test_gzipped_inputs(tmp_path):
    """gz fasta reads and genome map identically to the plain files and
    to the reference binary (fasta_open is zlib-backed, fasta.h:64)."""
    import gzip
    gpath, rpath, g, reads = make_dataset(str(tmp_path), n_reads=40)
    gz_r = str(tmp_path / "reads.fa.gz")
    gz_g = str(tmp_path / "genome.fa.gz")
    with open(rpath, "rb") as f, gzip.open(gz_r, "wb") as z:
        z.write(f.read())
    with open(gpath, "rb") as f, gzip.open(gz_g, "wb") as z:
        z.write(f.read())
    want = oracle.sam_body(oracle.run_gmapper(["-E", rpath, gpath]))
    got = [l for l in run_cli([gz_r, gz_g]).splitlines()
           if not l.startswith("@")]
    assert got == want and got


def _indel_dataset(tmp_path, n_reads=200, seed=4242):
    """Reads with 1-2 indels + substitutions: exercises the ZE edit
    string's paren/deletion tokens AND the window-gen threshold's (int)
    truncation edge (mapping.c:1157 — a 40bp read's 55% threshold is
    the non-representable 220.000...03 in f64)."""
    rng = np.random.default_rng(seed)
    g = "".join(rng.choice(list("ACGT"), 60_000))
    gpath = str(tmp_path / "ig.fa")
    with open(gpath, "w") as f:
        f.write(">ichr\n" + g + "\n")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rpath = str(tmp_path / "ir.fa")
    with open(rpath, "w") as f:
        for k in range(n_reads):
            p = int(rng.integers(0, len(g) - 50))
            r = list(g[p:p + 44])
            for _ in range(int(rng.integers(1, 3))):
                q = int(rng.integers(2, len(r) - 3))
                if rng.integers(2):
                    del r[q:q + int(rng.integers(1, 3))]
                else:
                    r[q:q] = ["ACGT"[int(rng.integers(4))]
                              for _ in range(int(rng.integers(1, 3)))]
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(len(r)))] = \
                    "ACGT"[int(rng.integers(4))]
            r = ("".join(r[:40]) if len(r) >= 40
                 else "".join(r) + g[p + 44:p + 44 + 40 - len(r)])
            if k % 3 == 0:
                r = "".join(comp[c] for c in reversed(r))
            f.write(f">ir{k}\n{r}\n")
    return gpath, rpath


def test_extra_sam_fields_byte_identical(tmp_path):
    """--extra-sam-fields rides the native fast path: ZM/ZR/ZV/ZH/ZE byte-identical to the reference on an
    indel-bearing dataset (forward and reverse-strand edit strings,
    paren groups, deletions, substitution letters)."""
    gpath, rpath = _indel_dataset(tmp_path)
    want = oracle.sam_body(oracle.run_gmapper(
        ["-E", "--extra-sam-fields", rpath, gpath]))
    got = [l for l in run_cli(["--extra-sam-fields", rpath,
                               gpath]).splitlines()
           if not l.startswith("@")]
    assert got == want and got
    assert any("ZE:Z:" in l and "(" in l.split("ZE:Z:")[1] for l in got)
    assert any("ZE:Z:" in l and "-" in l.split("ZE:Z:")[1] for l in got)


def test_windowgen_threshold_trunc_byte_identical(tmp_path):
    """The window-gen percent threshold truncates to int before the
    compare (mapping.c:1157) — without it, 40bp reads whose best
    2-anchor chain scores exactly 220 are dropped (220 < 400 * 0.55 in
    f64). Plain-config byte identity on the indel dataset."""
    gpath, rpath = _indel_dataset(tmp_path, seed=977)
    want = oracle.sam_body(oracle.run_gmapper(["-E", rpath, gpath]))
    got = [l for l in run_cli([rpath, gpath]).splitlines()
           if not l.startswith("@")]
    assert got == want and got
