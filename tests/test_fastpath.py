"""The flat-array LS unpaired fast path (shrimp_tpu/fastpath.py +
native/hostpipe.cpp) must produce byte-identical SAM to the generic
object pipeline (and hence to gmapper -E, covered transitively by
test_e2e_unpaired)."""
import os

import numpy as np
import pytest

from shrimp_tpu.config import MapperConfig
from shrimp_tpu.core import encode
from shrimp_tpu.fastpath import map_unpaired_sam_stream
from shrimp_tpu.index.build import build_index
from shrimp_tpu.index.seeds import default_seeds
from shrimp_tpu.io.fasta import SeqRecord
from shrimp_tpu.io.sam import render_unpaired
from shrimp_tpu.mapper import Mapper
from shrimp_tpu.native import get_lib

from . import oracle
from .test_e2e_unpaired import make_dataset

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


def _generic_sam(mapper, recs):
    lines = []
    for re_, hits in mapper.map_unpaired(recs):
        for h in hits:
            lines.append(render_unpaired(re_, h, mapper.index,
                                         mapper.config))
        if not hits and mapper.config.sam_unaligned:
            lines.append(render_unpaired(re_, None, mapper.index,
                                         mapper.config))
    return ("\n".join(lines) + "\n").encode() if lines else b""


def _fast_sam(mapper, recs, batch_size=None):
    gen = map_unpaired_sam_stream(mapper, recs,
                                  batch_size=batch_size or len(recs) or 1)
    assert gen is not None, "fast path unexpectedly unsupported"
    return b"".join(gen)


def _build(tmp_path, **dskw):
    gpath, rpath, g, reads = make_dataset(str(tmp_path), **dskw)
    idx = build_index([("chr_test", encode.encode_ls(g))], default_seeds())
    return idx, reads, gpath, rpath


def test_fastpath_matches_generic(tmp_path):
    idx, reads, _, _ = _build(tmp_path, n_reads=300)
    cfg = MapperConfig()
    m = Mapper(idx, cfg)
    recs = [SeqRecord(n, s) for n, s in reads]
    assert _fast_sam(m, recs) == _generic_sam(Mapper(idx, cfg), recs)


def test_fastpath_two_phase_identical(tmp_path, monkeypatch):
    """Two-phase dispatch (vec first, full SW only on pass1 survivors —
    the high-candidate-density shape used at hg scale) must be
    byte-identical to the fused speculative launch."""
    idx, reads, _, _ = _build(tmp_path, n_reads=300)
    cfg = MapperConfig()
    recs = [SeqRecord(n, s) for n, s in reads]
    monkeypatch.setenv("SHRIMP_TPU_LS_TWO_PHASE", "0")
    fused = _fast_sam(Mapper(idx, cfg), recs, batch_size=64)
    monkeypatch.setenv("SHRIMP_TPU_LS_TWO_PHASE", "1")
    m2 = Mapper(idx, cfg)
    assert _fast_sam(m2, recs, batch_size=64) == fused
    assert "device full (2ph)" in m2.stats.stage_secs


def test_fastpath_multi_batch_pipelined(tmp_path):
    idx, reads, _, _ = _build(tmp_path, n_reads=257)
    cfg = MapperConfig()
    m = Mapper(idx, cfg)
    recs = [SeqRecord(n, s) for n, s in reads]
    want = _generic_sam(Mapper(idx, cfg), recs)
    assert _fast_sam(m, recs, batch_size=64) == want


def test_fastpath_mixed_length_fallback(tmp_path):
    """A batch with a short read falls back to the generic path for
    that batch only, preserving output order."""
    idx, reads, _, _ = _build(tmp_path, n_reads=120)
    recs = [SeqRecord(n, s) for n, s in reads]
    recs[70] = SeqRecord(recs[70].name, recs[70].seq[:30])
    cfg = MapperConfig()
    want = _generic_sam(Mapper(idx, cfg), recs)
    got = _fast_sam(Mapper(idx, cfg), recs, batch_size=32)
    assert got == want


def test_fastpath_gate_configs(tmp_path):
    idx, reads, _, _ = _build(tmp_path, n_reads=8)
    recs = [SeqRecord(n, s) for n, s in reads]
    for kw in (dict(shrimp_format=True),
               dict(compute_mapping_qualities=False)):
        cfg = MapperConfig(**kw)
        assert map_unpaired_sam_stream(Mapper(idx, cfg), recs) is None
    # renderer-level flags are INSIDE the gate (r4; extra-sam-fields
    # r5) and byte-identical to the generic path
    for kw in (dict(sam_unaligned=True), dict(all_contigs=True),
               dict(read_group_name="g", sam_sample_name="s"),
               dict(extra_sam_fields=True),
               dict(sam_unaligned=True, read_group_name="g2",
                    sam_sample_name="s2")):
        cfg = MapperConfig(**kw)
        gen = map_unpaired_sam_stream(Mapper(idx, cfg), recs)
        assert gen is not None, kw
        assert b"".join(gen) == _generic_sam(Mapper(idx, cfg), recs), kw


def test_fastpath_option_variants(tmp_path):
    idx, reads, _, _ = _build(tmp_path, n_reads=200, seed=7)
    recs = [SeqRecord(n, s) for n, s in reads]
    for kw in (dict(num_outputs=3), dict(strata=True),
               dict(max_alignments=2), dict(single_best_mapping=False),
               dict(sw_full_threshold=-30.0)):
        cfg = MapperConfig(**kw)
        want = _generic_sam(Mapper(idx, cfg), recs)
        got = _fast_sam(Mapper(idx, cfg), recs)
        assert got == want, f"mismatch for {kw}"


def test_fastpath_stats_flow(tmp_path, monkeypatch):
    """The traceback-free stats flow (the XLA DP-stats scan +
    closed-form diagonal reconstruction + native host DP for the
    indel/cross-plane minority) is byte-identical to the on-device
    traceback flow."""
    monkeypatch.setenv("SHRIMP_TPU_STATS_FLOW", "1")
    idx, reads, _, _ = _build(tmp_path, n_reads=150, seed=3)
    recs = [SeqRecord(n, s) for n, s in reads]
    cfg = MapperConfig()
    m = Mapper(idx, cfg)
    got = _fast_sam(m, recs)
    assert m.stats.full_host_tb > 0, "indel paths never hit the host DP"
    monkeypatch.delenv("SHRIMP_TPU_STATS_FLOW")
    want = _generic_sam(Mapper(idx, cfg), recs)
    assert got == want


@pytest.mark.skipif(oracle.ensure_gmapper() is None,
                    reason="reference gmapper not available")
def test_fastpath_matches_reference(tmp_path):
    idx, reads, gpath, rpath = _build(tmp_path, n_reads=200, seed=11)
    want = oracle.sam_body(oracle.run_gmapper(["-E", rpath, gpath]))
    cfg = MapperConfig()
    got = _fast_sam(Mapper(idx, cfg), [SeqRecord(n, s) for n, s in reads])
    got_lines = got.decode().rstrip("\n").split("\n") if got else []
    assert got_lines == want


def test_fastpath_fastq_quals(tmp_path):
    """fastq reads with quality strings keep the fast path and emit the
    QUAL column exactly like the generic renderer."""
    idx, reads, _, _ = _build(tmp_path, n_reads=150)
    rng = np.random.default_rng(8)
    recs = []
    for n, s in reads:
        q = "".join(chr(64 + int(rng.integers(2, 41)))
                    for _ in range(len(s)))
        recs.append(SeqRecord(n, s, q))
    cfg = MapperConfig()
    from shrimp_tpu.io.sam import render_unpaired as _ru
    lines = []
    for re_, hits in Mapper(idx, cfg).map_unpaired(recs):
        for h in hits:
            lines.append(_ru(re_, h, idx, cfg, fastq=True))
    want = ("\n".join(lines) + "\n").encode() if lines else b""
    got = _fast_sam(Mapper(idx, cfg), recs, batch_size=64)
    assert got == want
    # QUAL column (field 11) carries the quality string, not '*'
    assert got.split(b"\n")[0].split(b"\t")[10] != b"*"


def test_fastpath_fastq_qv_offset_error(tmp_path):
    idx, reads, _, _ = _build(tmp_path, n_reads=4)
    recs = [SeqRecord(n, s, chr(120) * len(s)) for n, s in reads]
    cfg = MapperConfig()
    with pytest.raises(ValueError, match="qv-offset"):
        _fast_sam(Mapper(idx, cfg), recs)
