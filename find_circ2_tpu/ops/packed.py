"""Nibble-packed genome representation for gather-efficient window reads.

Gathers cost per *row* fetched, so the genome is packed 8 bases per
uint32 word (4-bit nibble per base, values 0-6 preserving the full
SPEC.md §0 code alphabet incl. N/GAP/RPAD sentinels) and laid out as a
2-D [n_rows, WPR] array whose rows are gathered whole. A w-base window
needs 1-2 row-gathers; the in-row selection is branchless vector work.

Row width (WPR, words) depends on genome size: genomes <= 128 Mbp use
WPR=8 (32 B rows), larger ones WPR=64 (256 B rows). The split was chosen
for an accelerator whose memory layout padded narrow arrays; on the GPU
a [N, 8] uint32 array is not padded, and which width gathers faster at
genome scale is not measured (ROADMAP: WPR=8 vs 64 on the card). The
reshape happens HOST-side in pack_nibbles.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

# Genomes with more packed words than this use 64-word (256 B) rows.
SMALL_WORDS = 16 << 20        # 16M words = 128 Mbp


def pack_nibbles(codes: np.ndarray) -> np.ndarray:
    """Host-side: uint8 codes (values 0..6) -> uint32 [n_rows, WPR],
    8 codes/word, base i in bits [4*(i%8), 4*(i%8)+3) of word i//8.
    Padding nibbles get the GAP-like value 7 (>=4 => mismatches
    everything, never canonical). One all-padding spare row guarantees
    `gather_window`'s trailing row fetch stays in bounds."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    pad = (-n) % 8
    c = np.concatenate([codes, np.full(pad, 7, np.uint8)]).astype(np.uint32)
    c = c.reshape(-1, 8)
    shifts = np.arange(8, dtype=np.uint32) * 4
    words = np.bitwise_or.reduce(c << shifts, axis=1).astype(np.uint32)
    wpr = 8 if words.size <= SMALL_WORDS else 64
    wpad = (-words.size) % wpr + wpr
    words = np.concatenate(
        [words, np.full(wpad, 0x77777777, np.uint32)])
    return words.reshape(-1, wpr)


def gather_window(packed: jnp.ndarray, starts: jnp.ndarray, width: int
                  ) -> jnp.ndarray:
    """codes[starts : starts+width] for each element of `starts` (uint32
    or int32, any shape S); returns int32 codes of shape S + (width,).

    `packed` is pack_nibbles' [n_rows, WPR] layout (WPR a power of two,
    multiple of 8). `starts` must be pre-clamped to [0, n_bases - width];
    pack_nibbles' spare row plus the genome's trailing chrom_gap
    sentinels keep every fetched row index in bounds.
    """
    nwords = width // 8 + 2
    W8, WPR = packed.shape
    # Word indices fit int32 even for 4.29 Gbp genomes (< 2^29 words).
    word0 = (starts >> 3).astype(jnp.int32)
    off = (starts & 7).astype(jnp.int32)
    nrows = (nwords + WPR - 1) // WPR + 1
    rbits = WPR.bit_length() - 1
    row0 = word0 >> rbits
    woff = word0 & (WPR - 1)
    ridx = jnp.clip(row0[..., None] + jnp.arange(nrows, dtype=jnp.int32),
                    0, W8 - 1)
    rows = jnp.take(packed, ridx, axis=0)             # [..., nrows, WPR]
    flatw = rows.reshape(*rows.shape[:-2], nrows * WPR)
    # Two-level branchless selection of the nwords-word window at word
    # offset `woff`: first the 8-word-aligned chunk (WPR/8-way), then
    # the sub-chunk offset (8-way) — static slices only, so the gather's
    # consumer stays on the vector emitter (docs/DESIGN.md).
    cw = nwords + 8
    chunk = woff >> 3
    tmp = flatw[..., 0:cw]
    for c in range(1, WPR // 8):
        tmp = jnp.where((chunk == c)[..., None],
                        flatw[..., 8 * c:8 * c + cw], tmp)
    sub = woff & 7
    words = tmp[..., 0:nwords]
    for o in range(1, 8):
        words = jnp.where((sub == o)[..., None],
                          tmp[..., o:o + nwords], words)
    # Branchless unpack: [..., nwords, 8] -> [..., nwords*8].
    shifts = (jnp.arange(8, dtype=jnp.uint32) * 4)
    nibs = (words[..., None] >> shifts) & jnp.uint32(7)
    flat = nibs.reshape(*nibs.shape[:-2], nwords * 8).astype(jnp.int32)
    # Select among the 8 possible sub-word offsets with static slices.
    out = flat[..., 0:width]
    for o in range(1, 8):
        out = jnp.where((off == o)[..., None], flat[..., o:o + width], out)
    return out
