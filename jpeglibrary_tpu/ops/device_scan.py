"""EXPERIMENT: baseline Huffman entropy decode ON DEVICE.

SURVEY.md hard-part #1 lists a mitigation never attempted through
round 4: a fixed-iteration "decode up to K symbols per step" masked
scanner over restart segments, executed by XLA instead of the host
C++ scanner. This module is that experiment — a complete, bit-exact
baseline (SOF0/1) scan decoder expressed as a ``lax.while_loop`` whose
batch dimension is the restart segment:

- the host does only what is embarrassingly vectorizable anyway
  (0xFF00 unstuffing + segment padding + table layout);
- every lane (segment) holds a decode cursor (bit position, block
  ordinal, zig-zag index, DC predictors) and each loop iteration
  decodes EXACTLY ONE Huffman symbol per live lane: a 16-bit peek
  (three byte gathers), the two-level table lookup (the 8-bit
  lookahead gather, with the maxcode/valoffset slow path computed
  branchlessly as ``9 + sum(code16 > maxcode[9..16])``), the EXTEND
  value bits, and one dense scatter of the coefficient;
- lanes mask off as their segments finish; the loop runs until every
  lane is done (`jnp.any` condition — XLA's native dynamic trip).

The decoder mirrors JpegHuffmanScanDecoder.DecodeHuffmanCode /
ReceiveAndExtend (JpegHuffmanScanDecoder.cs:81-117) and the baseline
block walk (JpegHuffmanBaselineScanDecoder.cs:99-235) exactly, so the
output coefficients are bit-identical to the host scanner's.

Status: bit-exact against the host scanner. Each symbol costs
several data-dependent gathers and the while_loop trips once per
symbol of the longest segment. Its speed on the GPU is not measured,
so whether entropy decode should move to the device stays open.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..models.geometry import FrameGeometry
from ..syntax.frame import FrameHeader, ScanHeader, resolve_scan_components
from ..syntax.huffman import HuffmanDecodingTable


def _unstuff(seg: bytes) -> bytes:
    """Remove 0xFF00 stuffing (vectorizable host prepass; the bit
    reader then reads a plain bitstream). Trailing garbage is
    irrelevant — the decoder stops after its MCU budget."""
    return bytes(seg).replace(b"\xff\x00", b"\xff")


def prepare_scan(
    data: bytes,
    spans,
    frame: FrameHeader,
    scan: ScanHeader,
    dc_tables: Dict[int, HuffmanDecodingTable],
    ac_tables: Dict[int, HuffmanDecodingTable],
    restart_interval: int,
    geometry: FrameGeometry,
):
    """Host prepass: unstuffed padded segment bytes + table/geometry
    constants for :func:`decode_segments_device`."""
    resolved = resolve_scan_components(frame, scan)
    comps = [geometry.components[ci] for ci, _, _ in resolved]
    bpm = sum(c.h * c.v for c in comps)
    # per-block-in-MCU component index
    comp_of = []
    for i, c in enumerate(comps):
        comp_of += [i] * (c.h * c.v)

    # tables: slot 2*i = component i DC, 2*i+1 = AC
    lookahead = np.zeros((2 * len(comps), 256), dtype=np.int32)
    maxcode = np.zeros((2 * len(comps), 18), dtype=np.int32)
    valoffset = np.zeros((2 * len(comps), 19), dtype=np.int32)
    values = np.zeros((2 * len(comps), 256), dtype=np.int32)
    for i, (_ci, _fc, sc) in enumerate(resolved):
        for j, t in ((2 * i, dc_tables[sc.dc_table_selector]),
                     (2 * i + 1, ac_tables[sc.ac_table_selector])):
            lookahead[j] = (
                (t.lookahead_size.astype(np.int32) << 8)
                | t.lookahead_value.astype(np.int32)
            )
            maxcode[j] = t.maxcode.astype(np.int32)
            valoffset[j, : len(t.valoffset)] = t.valoffset.astype(np.int32)
            values[j, : len(t.values)] = t.values.astype(np.int32)

    total_mcus = geometry.mcus_per_line * geometry.mcus_per_column
    ri = restart_interval if restart_interval > 0 else total_mcus
    segs: List[bytes] = []
    mcus: List[int] = []
    done_mcus = 0
    for sp in spans:
        if done_mcus >= total_mcus:
            break
        n = min(ri, total_mcus - done_mcus)
        segs.append(_unstuff(data[sp.start : sp.end]))
        mcus.append(n)
        done_mcus += n
    width = max(len(s) for s in segs) + 8  # peek slack past the end
    buf = np.full((len(segs), width), 0xFF, dtype=np.uint8)  # 1-fill pad
    for i, s in enumerate(segs):
        buf[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)

    const = {
        "bpm": bpm,
        "comp_of": np.asarray(comp_of, dtype=np.int32),
        "mcu_counts": np.asarray(mcus, dtype=np.int32),
        "tables": (lookahead, maxcode, valoffset, values),
        "n_comps": len(comps),
    }
    return buf, const


@functools.lru_cache(maxsize=8)
def _compiled_decoder(bpm: int, n_comps: int, width: int, n_segs: int,
                      max_blocks: int):
    import jax
    import jax.numpy as jnp
    from jax import lax

    def decode(buf, comp_of, mcu_counts, lookahead, maxcode, valoffset,
               values):
        S = n_segs
        blocks_total = mcu_counts * bpm  # per segment

        def peek16(bit_pos):
            byte = bit_pos >> 3
            sh = bit_pos & 7
            i = jnp.arange(S)
            b0 = buf[i, byte].astype(jnp.int32)
            b1 = buf[i, byte + 1].astype(jnp.int32)
            b2 = buf[i, byte + 2].astype(jnp.int32)
            w = (b0 << 16) | (b1 << 8) | b2
            return (w >> (8 - sh)) & 0xFFFF

        def read_bits(bit_pos, n):
            # n <= 16 value bits at bit_pos (1-padded past the end by
            # the 0xFF fill)
            v = peek16(bit_pos)
            return jnp.where(n > 0, v >> (16 - jnp.maximum(n, 1)), 0) & (
                (1 << jnp.maximum(n, 0)) - 1
            )

        def huff_decode(tbl, bit_pos):
            code16 = peek16(bit_pos)
            entry = lookahead[tbl, code16 >> 8]
            fast_size = entry >> 8
            fast_val = entry & 0xFF
            # slow path: the host walk is "size = 9; while code16 >
            # maxcode[size]: size += 1" — it stops at the FIRST
            # size that fits, so the branchless form must count the
            # LEADING run of exceedances (a plain sum would also count
            # absent lengths past the stop, whose maxcode of 0 compares
            # true again): size = 9 + sum(cumprod(gt)).
            mc = jnp.take(maxcode, tbl, axis=0)[:, 9:17]
            gt = (code16[:, None] > mc).astype(jnp.int32)
            slow_size = 9 + jnp.sum(jnp.cumprod(gt, axis=1), axis=1)
            slow_size = jnp.minimum(slow_size, 16)
            idx = valoffset[tbl, slow_size] + (code16 >> (16 - slow_size))
            slow_val = values[tbl, idx & 0xFF]
            hit = fast_size > 0
            return (
                jnp.where(hit, fast_size, slow_size),
                jnp.where(hit, fast_val, slow_val),
            )

        def extend(v, t):
            # ITU-T81 EXTEND (JpegHuffmanScanDecoder.cs:100-116)
            vt = jnp.where(t > 0, 1 << jnp.maximum(t - 1, 0), 0)
            return jnp.where(v < vt, v - (1 << jnp.maximum(t, 1)) + 1, v)

        out0 = jnp.zeros((S, max_blocks * 64), dtype=jnp.int32)

        # state: bit_pos, block (segment-local ordinal), k (zigzag),
        # preds [S, n_comps], out
        def cond(st):
            _bit, block, _k, _preds, _out = st
            return jnp.any(block < blocks_total)

        def body(st):
            bit, block, k, preds, out = st
            live = block < blocks_total
            comp = comp_of[jnp.minimum(block, blocks_total - 1) % bpm]
            is_dc = k == 0
            tbl = 2 * comp + jnp.where(is_dc, 0, 1)
            size, sym = huff_decode(tbl, bit)
            bit1 = bit + size

            # DC: t = sym; diff = extend(read(t), t); pred += diff
            t_dc = sym
            dc_bits = read_bits(bit1, t_dc)
            diff = jnp.where(t_dc > 0, extend(dc_bits, t_dc), 0)
            new_pred_c = preds[jnp.arange(S), comp] + diff
            bit_dc = bit1 + t_dc

            # AC: r = sym >> 4, s = sym & 15
            r = sym >> 4
            s_ac = sym & 15
            ac_bits = read_bits(bit1, s_ac)
            ac_val = extend(ac_bits, s_ac)
            bit_ac = bit1 + s_ac
            k_ac_emit = jnp.minimum(k + r, 63)
            eob = (s_ac == 0) & (r == 0)
            zrl = (s_ac == 0) & (r != 0)
            k_next_ac = jnp.where(
                eob, 64, jnp.where(zrl, k + 16, k_ac_emit + 1)
            )

            # merged emission (one scatter per iteration)
            base = jnp.minimum(block, max_blocks - 1) * 64
            pos = jnp.where(is_dc, base, base + k_ac_emit)
            val = jnp.where(is_dc, new_pred_c, jnp.where(s_ac > 0, ac_val, 0))
            emit = live & (is_dc | (s_ac > 0))
            out = out.at[jnp.arange(S), pos].add(jnp.where(emit, val, 0))

            new_bit = jnp.where(live, jnp.where(is_dc, bit_dc, bit_ac), bit)
            new_k = jnp.where(live, jnp.where(is_dc, 1, k_next_ac), k)
            preds = preds.at[jnp.arange(S), comp].set(
                jnp.where(live & is_dc, new_pred_c,
                          preds[jnp.arange(S), comp])
            )
            # block advance when the zig-zag cursor ran off the end
            adv = new_k >= 64
            new_block = jnp.where(live & adv, block + 1, block)
            new_k = jnp.where(adv, 0, new_k)
            return new_bit, new_block, new_k, preds, out

        st = (
            jnp.zeros(S, jnp.int32),
            jnp.zeros(S, jnp.int32),
            jnp.zeros(S, jnp.int32),
            jnp.zeros((S, n_comps), jnp.int32),
            out0,
        )
        st = lax.while_loop(cond, body, st)
        return st[4]

    return jax.jit(decode)


def decoder_program(buf: np.ndarray, const):
    """The compiled device decoder for a prepared scan and its
    arguments: ``fn(*args)`` returns dense [n_segments, max_blocks*64]
    int32 coefficients in segment-local MCU order."""
    lookahead, maxcode, valoffset, values = const["tables"]
    max_blocks = int(const["mcu_counts"].max()) * const["bpm"]
    fn = _compiled_decoder(
        const["bpm"], const["n_comps"], buf.shape[1], buf.shape[0],
        max_blocks,
    )
    return fn, (
        buf, const["comp_of"], const["mcu_counts"],
        lookahead, maxcode, valoffset, values,
    )


def decode_segments_device(buf: np.ndarray, const) -> np.ndarray:
    """Run the device decoder; returns dense [n_segments,
    max_blocks*64] int32 coefficients in segment-local MCU order."""
    fn, args = decoder_program(buf, const)
    return fn(*args)


def decode_baseline_device(data: bytes) -> Tuple[np.ndarray, object]:
    """End-to-end experiment entry: parse the container on host, run
    the ENTROPY DECODE on device, return (dense [S, max_blocks*64]
    coefficients, geometry). Baseline single-scan streams only."""
    buf, const, geo = prepare_baseline(data)
    return decode_segments_device(buf, const), geo


def prepare_baseline(data: bytes):
    """Host side of :func:`decode_baseline_device`: parse the container
    and prepare the first scan; returns ``(buf, const, geometry)``."""
    from ..io import reader as io_reader
    from ..models.decoder import JpegDecoder
    from ..models.geometry import frame_geometry
    from ..syntax.markers import ALL_SOF_MARKERS, Marker
    from ..syntax.frame import FrameHeader, ScanHeader

    dec = JpegDecoder()
    dec.set_input(data)
    stream = dec._parsed()
    frame = None
    scan_header = None
    for seg in stream.segments:
        if seg.marker in (Marker.DQT, Marker.DHT, Marker.DAC, Marker.DRI):
            dec._process_table_segment(seg, data)
        elif seg.marker in ALL_SOF_MARKERS:
            frame = FrameHeader.parse(seg.payload(data), seg.marker)
        elif seg.marker == Marker.SOS:
            scan_header = ScanHeader.parse(seg.payload(data))
            break
    assert frame is not None and scan_header is not None
    geo = frame_geometry(frame)
    buf, const = prepare_scan(
        data, stream.scans[0].spans, frame, scan_header,
        dec._dc_tables, dec._ac_tables, dec._restart_interval, geo,
    )
    return buf, const, geo
