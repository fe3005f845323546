"""Chunked speculative JPEG Huffman decode — numpy prototype.

The algorithm the device kernel (jpeg_huffman_decode_tpu.py) implements,
in plain numpy for correctness work and convergence measurement. The
idea (after "Accelerating JPEG Decompression on GPUs", Weissenberger &
Schmidt 2021 — PAPERS.md): split each entropy segment into fixed-size
bit chunks, decode every chunk in parallel from a GUESSED entry state,
then iterate: chunk i+1's entry state is chunk i's exit state (Jacobi
fixed point). Huffman streams self-synchronise, so a chunk decoded
from a wrong guess usually produces the RIGHT exit state anyway —
truth propagates much faster than one chunk per pass, and the fixed
point lands in a handful of passes.

Decoder state at a symbol boundary is tiny: (bit offset within chunk
0..26, MCU block slot, coefficient index 0..63). DC values are emitted
as DIFFS and integrated afterwards, so predictors are NOT part of the
sync state. Restart segments are chunked independently with exactly
known entry states at each segment start.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .jpeg_scan import (ScanInfo, ZIGZAG, derive_tables, mcu_slot_tables,
                        scatter_layout)


def bits_of(seg: bytes, pad_chunks: int, C: int) -> np.ndarray:
    """Unpacked bit array padded with 1-bits to pad_chunks*C bits."""
    bits = np.unpackbits(np.frombuffer(seg, np.uint8))
    out = np.ones(pad_chunks * C, np.uint8)
    out[: bits.size] = bits
    return out


class _Tables:
    def __init__(self, info: ScanInfo):
        # 2*ncomp table slots: per-component DC then per-component AC.
        # parse_baseline accepts scans where every component names its
        # own DC/AC table ids (e.g. Cb and Cr with different tables),
        # so the prototype must index tables per component — a comp0
        # vs rest collapse mis-decodes such files.
        sig = info.comp_sig
        self.comp_of = mcu_slot_tables(sig)
        self.B = int(self.comp_of.size)
        self.ncomp = nc = info.ncomp
        self.limit = np.zeros((2 * nc, 17), np.int64)
        self.mincode = np.zeros((2 * nc, 17), np.int64)
        self.valptr = np.zeros((2 * nc, 17), np.int64)
        self.hv = np.zeros((2 * nc, 256), np.int32)
        for ci in range(nc):
            for cls in (0, 1):
                t = ci + cls * nc
                table_id = info.scan_tables[ci][cls]
                lim, mc, vp, hv = derive_tables(
                    *info.huffman[(cls, table_id)])
                self.limit[t], self.mincode[t] = lim, mc
                self.valptr[t], self.hv[t] = vp, hv


def _decode_chunk(bits: np.ndarray, start: int, end: int,
                  entry: Tuple[int, int, int], tabs: _Tables,
                  emit=None) -> Tuple[int, int, int, int]:
    """Decode from bit `start+entry.off` until the next symbol start
    >= `end`. Returns (off_next, slot, z, nblk_completed). `emit(local
    block, z, value)` is called per coefficient when provided."""
    off, slot, z, nblk = entry[0], entry[1], entry[2], 0
    pos = start + off
    n = bits.size

    def peek16(p):
        v = 0
        for k in range(16):
            v = (v << 1) | int(bits[p + k]) if p + k < n else (v << 1) | 1
        return v

    def read(p, cnt):
        v = 0
        for k in range(cnt):
            v = (v << 1) | (int(bits[p + k]) if p + k < n else 1)
        return v

    while pos < end:
        tid = int(tabs.comp_of[slot])  # tables index per component
        t = tid if z == 0 else tabs.ncomp + tid
        P = peek16(pos)
        # clamp at 16: an all-ones peek (stream padding, or garbage
        # under a wrong speculative phase) exceeds every limit —
        # speculative lanes must tolerate any bit pattern
        clen = min(16, 1 + int(np.sum(P >= tabs.limit[t, 1:17])))
        idx = (P >> (16 - clen)) - int(tabs.mincode[t, clen]) \
            + int(tabs.valptr[t, clen])
        sym = int(tabs.hv[t, idx & 255])
        if z == 0:
            size = sym & 15
            v = read(pos + clen, size)
            if size and v < (1 << (size - 1)):
                v -= (1 << size) - 1
            if emit is not None:
                emit(nblk, 0, v)
            pos += clen + size
            z = 1
        else:
            run, size = sym >> 4, sym & 15
            if size == 0:
                pos += clen
                z = 64 if run != 15 else z + 16
            else:
                z += run
                v = read(pos + clen, size)
                if v < (1 << (size - 1)):
                    v -= (1 << size) - 1
                if emit is not None and z < 64:
                    emit(nblk, z, v)
                pos += clen + size
                z += 1
        if z >= 64:
            z = 0
            slot = (slot + 1) % tabs.B
            nblk += 1
    return (pos - end, slot, z, nblk)


def decode_chunked(info: ScanInfo, C: int = 256, max_passes: int = 64):
    """Chunked speculative decode of every segment. Returns
    (planes like decode_reference, passes_used (max over segments))."""
    sig = info.comp_sig
    tabs = _Tables(info)
    out_idx, comp_all, total = scatter_layout(sig)
    mcus = info.mcus
    ri = info.restart_interval or mcus
    B = tabs.B
    coefs = np.zeros((mcus * B + 1, 64), np.int32)  # scan order + trash
    passes_hist = []
    blk_base = 0
    for si, seg in enumerate(info.segments):
        n_mcu = min(ri, mcus - si * ri)
        if n_mcu <= 0:
            # malformed stream: more RST-delimited segments than
            # ceil(mcus/ri) — ignore the excess like the device
            # kernel's ScanBatch does (a negative count would crash
            # the DC integration's np.repeat below)
            break
        nbits = len(seg) * 8
        nch = max(1, -(-nbits // C))
        bits = bits_of(seg, nch, C)
        entries = [(0, 0, 0)] * nch  # guess: chunk starts a fresh MCU
        exits = [None] * nch
        used = 0
        memo = [dict() for _ in range(nch)]  # entry -> exit (host-only
        # shortcut; the device kernel re-decodes, which is free in
        # lockstep — this just makes large-image convergence
        # measurements tractable in python)
        for p in range(max_passes):
            used = p + 1
            new_entries = list(entries)
            changed = False
            for i in range(nch):
                e = entries[i]
                ex = memo[i].get(e)
                if ex is None:
                    ex = _decode_chunk(bits, i * C, (i + 1) * C, e, tabs)
                    memo[i][e] = ex
                exits[i] = ex
                if i + 1 < nch:
                    nxt = (ex[0], ex[1], ex[2])
                    if nxt != entries[i + 1]:
                        new_entries[i + 1] = nxt
                        changed = True
            entries = new_entries
            if not changed:
                break
        else:
            # hit max_passes with entries still changing: the block
            # offsets below would come from pre-update entries while
            # the emission re-decodes with post-update ones — silently
            # inconsistent planes. This prototype is an oracle; fail
            # loudly instead (the device kernel signals ok=False).
            raise RuntimeError(
                f"chunked decode did not converge in {max_passes} passes "
                f"(segment {si})")
        passes_hist.append(used)
        # block prefix within the segment
        starts = np.zeros(nch, np.int64)
        acc = 0
        for i in range(nch):
            starts[i] = acc
            acc += exits[i][3]
        # final emission pass
        for i in range(nch):
            base = blk_base + int(starts[i])

            def emit(local, z, v, base=base):
                b = base + local
                if b < blk_base + n_mcu * B:
                    coefs[b, z] = v
            _decode_chunk(bits, i * C, (i + 1) * C, entries[i], tabs,
                          emit=emit)
        blk_base += n_mcu * B
    # DC diffs -> absolute per (component, segment)
    seg_of = np.repeat(np.arange(len(info.segments)),
                       [min(ri, mcus - s * ri) * B
                        for s in range(len(info.segments))])
    comp_seq = np.tile(tabs.comp_of, mcus)
    dc = coefs[:-1, 0].copy()
    for ci in range(info.ncomp):
        for s in range(len(info.segments)):
            m = (comp_seq == ci) & (seg_of == s)
            dc[m] = np.cumsum(dc[m])
    coefs[:-1, 0] = dc
    nat = np.zeros((mcus * B, 64), np.int32)
    nat[:, ZIGZAG] = coefs[:-1]
    flat = np.zeros((total + 1, 64), np.int32)
    flat[out_idx] = nat
    bases = np.cumsum([0] + [c[0] * c[1] for c in sig])[:-1]
    planes = [flat[bases[ci] : bases[ci] + bh * bw]
              .reshape(bh, bw, 64).astype(np.int16)
              for ci, (bh, bw, _, _) in enumerate(sig)]
    return planes, max(passes_hist)
