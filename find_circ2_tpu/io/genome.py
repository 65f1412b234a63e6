"""Concatenated, sentinel-padded genome representation.

Layout (SPEC.md §1): [GAP][chrom0][GAP][chrom1]...[GAP] where GAP is
`chrom_gap` sentinel bases (code 5). Global uint32 positions are used on
device; this module converts to/from per-chromosome coordinates and is the
single place coordinate arithmetic lives for oracle and device paths alike.

Replaces the reference's on-disk FASTA + faidx access (SURVEY.md §2.2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from find_circ2_tpu.config import GAP_CODE, Config
from find_circ2_tpu.io.fasta import read_fasta
from find_circ2_tpu.io.twobit import seq_to_codes


@dataclass
class Genome:
    codes: np.ndarray          # uint8 concatenated codes, sentinel-padded
    chrom_names: list[str]
    chrom_offsets: np.ndarray  # int64 global start of each chromosome
    chrom_lengths: np.ndarray  # int64

    @classmethod
    def from_records(cls, records, cfg: Config = Config()) -> "Genome":
        names: list[str] = []
        offsets: list[int] = []
        lengths: list[int] = []
        parts: list[np.ndarray] = []
        gap = np.full(cfg.chrom_gap, GAP_CODE, dtype=np.uint8)
        pos = 0
        for name, seq in records:
            parts.append(gap)
            pos += cfg.chrom_gap
            codes = seq_to_codes(seq) if isinstance(seq, (str, bytes)) \
                else np.asarray(seq, dtype=np.uint8)
            names.append(name)
            offsets.append(pos)
            lengths.append(len(codes))
            parts.append(codes)
            pos += len(codes)
        parts.append(gap)
        return cls(
            codes=np.concatenate(parts) if parts else gap.copy(),
            chrom_names=names,
            chrom_offsets=np.asarray(offsets, dtype=np.int64),
            chrom_lengths=np.asarray(lengths, dtype=np.int64),
        )

    @classmethod
    def from_fasta(cls, path, cfg: Config = Config()) -> "Genome":
        return cls.from_records(read_fasta(path), cfg)

    def __len__(self) -> int:
        return int(self.codes.size)

    @property
    def n_chroms(self) -> int:
        return len(self.chrom_names)

    def chrom_of(self, gpos) -> np.ndarray:
        """Chromosome index for global position(s); -1 if in a gap."""
        gpos = np.asarray(gpos, dtype=np.int64)
        idx = np.searchsorted(self.chrom_offsets, gpos, side="right") - 1
        idx = np.clip(idx, 0, self.n_chroms - 1)
        inside = (gpos >= self.chrom_offsets[idx]) & (
            gpos < self.chrom_offsets[idx] + self.chrom_lengths[idx])
        return np.where(inside, idx, -1)

    def to_local(self, gpos) -> tuple[np.ndarray, np.ndarray]:
        """Global position(s) -> (chrom_index, per-chrom 0-based position)."""
        idx = self.chrom_of(gpos)
        off = self.chrom_offsets[np.clip(idx, 0, None)]
        return idx, np.asarray(gpos, dtype=np.int64) - off

    def to_global(self, chrom_idx, lpos) -> np.ndarray:
        return self.chrom_offsets[np.asarray(chrom_idx)] + np.asarray(lpos)
