"""chip_smoke.py on the CPU at a tiny size: every comparison of every
phase runs (the Triton kernel on the Pallas interpreter, the four-card
path on four of the eight virtual CPU devices). Without a GPU, or
without the rest of the repo, the script exits non-zero and prints no
result line."""
import os
import shutil
import subprocess
import sys

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = chip_smoke.Sizes(
    vec_rows=300, fused_rows=256, stats_rows=1024, cs_rows=64,
    cs_fused_rows=64, ecoli_len=60_000, chr21_len=120_000, ls_reads=200,
    ls_pairs=100, cs_reads=100, cs_pairs=50, check_reads=100,
    bin_len=16384, four_reads=64, four_pairs=32, reps=1, interpret=True)


def test_kernel_phase_tiny(capsys):
    chip_smoke.kernel_phase(TINY, "cpu")
    out = capsys.readouterr().out
    assert out.count("bit-equal") == 4
    assert "memory_analysis" in out


def test_main_path_phase_tiny(capsys):
    chip_smoke.main_path_phase(TINY, "cpu", compare_vec=False)
    out = capsys.readouterr().out
    assert out.count("byte-identical to the generic pipeline") == 5


def test_four_card_phase_tiny(capsys):
    chip_smoke.four_card_phase(TINY, "cpu")
    out = capsys.readouterr().out
    assert out.count("SAM byte-identical") == 4
    assert "collectives: z1 psum and zpair merge ran" in out


def _run(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_gpu_exits_nonzero():
    r = _run(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
