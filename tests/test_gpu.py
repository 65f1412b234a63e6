"""Checks that need the card (marker `gpu`). Here they skip; on the card
`python chip_smoke.py` runs them with JAX_PLATFORMS=cuda. Each compares
the GPU's result with a reference computed independently of it."""

import io

import numpy as np
import pytest

from find_circ2_tpu.config import Config
from find_circ2_tpu.index.build import build_index
from find_circ2_tpu.io.bed import write_bed
from find_circ2_tpu.models.aggregate import Aggregator
from find_circ2_tpu.models.oracle import call_read
from find_circ2_tpu.models.pipeline import DeviceIndex, run_reads
from find_circ2_tpu.utils.simulate import rnase_r_library

pytestmark = pytest.mark.gpu


def _bed(genome, calls, cfg):
    agg = Aggregator(genome, cfg)
    for c in calls:
        agg.add(c)
    buf = io.StringIO()
    write_bed(buf, agg.rows(sample_name="g"))
    return buf.getvalue(), sorted(agg.stats.counts.items())


def test_prefix_sum_exact_on_card(gpu):
    """bf16 0/1 operands with float32 accumulation stay exact on tensor
    cores: TF32 never enters K2's prefix sum."""
    import jax
    from find_circ2_tpu.ops.breakpoint import prefix_sum_rows
    rng = np.random.default_rng(0)
    for ind in (np.ones((8192, 160), bool), rng.random((8192, 160)) < 0.5):
        got = np.asarray(jax.jit(prefix_sum_rows)(ind))
        np.testing.assert_array_equal(got, np.cumsum(ind, axis=1))


def test_detect_matches_oracle_on_card(gpu):
    """Per-read device results (detect, §2b explore program and the host
    2-mm rescue) equal the CPU oracle's call_read on a repeat-heavy
    library, and so do the BED bytes."""
    cfg = Config(batch_size=512)
    sim = rnase_r_library(seed=11, chrom_lengths={"chrG": 1_000_000},
                          n_circ=60, n_linear=10, repeat_frac=0.45, cfg=cfg)
    idx = build_index(sim.genome, cfg)
    dindex = DeviceIndex.build(sim.genome, idx, cfg)
    dev = run_reads(dindex, sim.reads, cfg, True,
                    slowpath=(sim.genome, idx))
    orc = [call_read(sim.genome, idx, n, s, cfg, True) for n, s in sim.reads]
    assert [c.status for c in dev] == [c.status for c in orc]
    assert _bed(sim.genome, dev, cfg) == _bed(sim.genome, orc, cfg)


def test_run_fastq_matches_run_reads_on_card(gpu, tmp_path):
    """The served path (native parse, device detect + explore, rescue
    worker thread) equals the per-read streaming loop on the card."""
    from find_circ2_tpu import native
    from find_circ2_tpu.models.stream import run_fastq
    assert native.available()
    cfg = Config(batch_size=512)
    sim = rnase_r_library(seed=12, chrom_lengths={"chrG": 1_000_000},
                          n_circ=60, n_linear=10, repeat_frac=0.45, cfg=cfg)
    idx = build_index(sim.genome, cfg)
    dindex = DeviceIndex.build(sim.genome, idx, cfg)
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                          for n, s in sim.reads))
    slow = (sim.genome, idx)
    agg = Aggregator(sim.genome, cfg)
    run_fastq(dindex, fq, agg, cfg, slowpath=slow)
    buf = io.StringIO()
    write_bed(buf, agg.rows(sample_name="g"))
    want = _bed(sim.genome, run_reads(dindex, sim.reads, cfg,
                                      slowpath=slow), cfg)
    assert (buf.getvalue(), sorted(agg.stats.counts.items())) == want
