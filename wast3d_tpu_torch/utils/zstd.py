"""Zstandard (RFC 8878) in plain Python: the version `native.zstd_decode`
(`native/zstd.cpp`) is held to.

`zstd_reference(data, out_size)` decodes what libtiff's ZSTD codec
(`tif_zstd.c`) decodes from one strip or tile: the first frame, as libzstd's
streaming decoder fills libtiff's buffer of `out_size` bytes (a skippable
frame first gives nothing). It stops after that frame, or after the block
that fills the buffer; errors inside that block are
still errors, the blocks after it are never read. A frame is its header
(Single_Segment, Frame_Content_Size, Window_Descriptor; a nonzero
Dictionary_ID raises, there being no dictionary), then raw, RLE and
compressed blocks of at most min(window, 128 KiB) each, then, when its flag
is set, the low 32 bits of the XXH64 of the content. A compressed block is
its literals (raw, RLE, Huffman-coded in 1 or 4 streams, or treeless,
reusing the frame's last Huffman table; each stream ended as libzstd 1.5.7
ends it, which matters only for damaged data: its single- or double-symbol
decoder as HUF_selectDecoder picks, the double one's last-symbol clamp, its
four-stream fast loop that checks no stream's end, and reads past a
stream's start as its bit container gives them) and its sequences (literal length,
offset and match length codes through FSE tables that are predefined,
RLE, sent, or repeated from the last block), with libzstd's checks: exact
ends of every backward bitstream, offsets inside the output, repeat
offsets with the literal-length-0 shift. Bad data raises `ValueError`.
Slow: for small frames (a few KB) in the tests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
WINDOW_LOG_MAX = 27  # libzstd's default limit for decoding (ZSTD_WINDOWLOG_LIMIT_DEFAULT)

# (baseline, extra bits) of each literal length and match length code.
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
# The predefined distributions (accuracy logs 6, 6, 5).
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
               1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# Per table kind: (largest symbol, largest accuracy log).
LL_MAX, ML_MAX, OF_MAX = (35, 9), (52, 9), (31, 8)

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the checksum of a frame's content)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = np.frombuffer(data[:n - n % 32], "<u8").tolist()
        for i in range(0, len(lanes), 4):
            v = [_round(v[j], lanes[i + j]) for j in range(4)]
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        p = n - n % 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h = (_rotl(h ^ _round(0, int.from_bytes(data[p:p + 8], "little")), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[p:p + 4], "little") * _P1 & _M64), 23) * _P2
             + _P3) & _M64
        p += 4
    while p < n:
        h = _rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1 & _M64
        p += 1
    h = (h ^ (h >> 33)) * _P2 & _M64
    h = (h ^ (h >> 29)) * _P3 & _M64
    return h ^ (h >> 32)


def _bad(why: str):
    raise ValueError(f"bad ZSTD data ({why})")


class _Backward:
    """A backward bitstream: read from the end, the highest set bit of the
    last byte a marker (with `unmarked`, a last byte of zero is all data).
    Past the start it reads as libzstd's BIT_DStream does once its 64-bit
    container holds the stream's first 8 bytes: zeros below them, then (the
    consumed count past 64 taken mod 64) those bytes again."""

    def __init__(self, data: bytes, unmarked: bool = False):
        if not data or data[-1] == 0 and not unmarked:
            _bad("a bitstream without its end marker")
        self.value = int.from_bytes(data, "little")
        self.container = int.from_bytes(data[:8], "little")
        self.pos = 8 * len(data) if data[-1] == 0 else 8 * (len(data) - 1) + data[
            -1].bit_length() - 1  # bits left

    def peek(self, n: int) -> int:
        if self.pos >= n:
            return (self.value >> (self.pos - n)) & ((1 << n) - 1)
        return ((self.container << ((64 - self.pos) & 63)) & _M64) >> (64 - n)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos -= n
        return v

    def overflowed(self) -> bool:
        return self.pos < 0

    def done(self) -> bool:
        return self.pos == 0


def read_ncount(data: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description at `pos` -> (normalized counts, accuracy
    log, the position after it), as FSE_readNCount reads it."""
    end, bits = len(data), 0

    def take(n):
        byte = pos + (bits >> 3)
        word = int.from_bytes(data[byte:byte + 4].ljust(4, b"\x00"), "little")
        return (word >> (bits & 7)) & ((1 << n) - 1)

    if pos >= end:
        _bad("an FSE table description past the end of the block")
    log = take(4) + 5
    bits = 4
    if log > max_log:
        _bad(f"an FSE accuracy log of {log} (at most {max_log})")
    remaining, threshold, nb = (1 << log) + 1, 1 << log, log + 1
    counts, previous0 = [], False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = len(counts)
            while True:
                r = take(2)
                bits += 2
                n0 += r
                if r != 3:
                    break
            if n0 > max_symbol:
                _bad("an FSE table past its largest symbol")
            counts += [0] * (n0 - len(counts))
        big = (2 * threshold - 1) - remaining
        low = take(nb - 1)
        if low < big:
            count = low
            bits += nb - 1
        else:
            count = take(nb)
            if count >= threshold:
                count -= big
            bits += nb
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb = remaining.bit_length()
            threshold = 1 << (nb - 1)
    if remaining != 1 or len(counts) > max_symbol + 1:
        _bad("an FSE table description whose counts do not add up")
    if pos + ((bits + 7) >> 3) > end:
        _bad("an FSE table description past the end of the block")
    return counts, log, pos + ((bits + 7) >> 3)


def fse_table(counts, log: int):
    """The decoding table of normalized `counts`: (symbol, bits, baseline) per
    state, spread as FSE_buildDTable spreads them."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(max(c, 0))
    step, mask, p = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        _bad("an FSE table that does not spread")
    table = []
    for u in range(size):
        s = symbol[u]
        state = nxt[s]
        nxt[s] += 1
        bits = log - (state.bit_length() - 1)
        table.append((s, bits, (state << bits) - size))
    return table, log


def _huffman_weights(data: bytes, pos: int, end: int):
    """A Huffman tree description at `pos` -> (weights of every symbol but the
    last, the position after it)."""
    if pos >= end:
        _bad("a Huffman tree description past the end of the literals")
    head = data[pos]
    pos += 1
    if head >= 128:  # weights as 4-bit fields
        n = head - 127
        if pos + (n + 1) // 2 > end:
            _bad("a Huffman tree description past the end of the literals")
        w = [(data[pos + i // 2] >> (0 if i & 1 else 4)) & 15 for i in range(n)]
        return w, pos + (n + 1) // 2, "direct"
    if pos + head > end:
        _bad("a Huffman tree description past the end of the literals")
    blob = data[pos:pos + head]
    counts, log, at = read_ncount(blob, 0, 255, 6)
    table, _ = fse_table(counts, log)
    bs = _Backward(blob[at:])
    states, out = [bs.read(log), bs.read(log)], []
    while True:  # two interleaved states until the stream overflows
        for a in (0, 1):
            sym, nb, base = table[states[a]]
            out.append(sym)
            states[a] = base + bs.read(nb)
            if bs.overflowed():
                out.append(table[states[1 - a]][0])
                if len(out) > 255:
                    _bad("more than 255 Huffman weights")
                return out, pos + head, "fse"
            if len(out) >= 255:
                _bad("more than 255 Huffman weights")


def huffman_table(weights):
    """Weights of all but the last symbol -> (a table indexed by the next
    `bits` bits: (symbol, code length) per entry, bits), as HUF_readStats
    and HUF_readDTableX1 build it."""
    if any(w > 12 for w in weights):
        _bad("a Huffman weight above 12")
    total = sum((1 << w) >> 1 for w in weights)
    if total == 0:
        _bad("Huffman weights that are all zero")
    bits = total.bit_length()
    if bits > 12:
        _bad("a Huffman table of more than 12 bits")
    rest = (1 << bits) - total
    if rest & (rest - 1):
        _bad("Huffman weights that do not complete a power of two")
    weights = list(weights) + [rest.bit_length()]
    if weights.count(1) < 2 or weights.count(1) & 1:
        _bad("Huffman weights with an odd number of weight-1 symbols")
    start, acc = [0] * (bits + 2), 0
    for w in range(1, bits + 1):
        start[w] = acc
        acc += weights.count(w) << (w - 1)
    table = [None] * (1 << bits)
    for s, w in enumerate(weights):
        if w:
            n = (1 << w) >> 1
            table[start[w]:start[w] + n] = [(s, bits + 1 - w)] * n
            start[w] += n
    return table, bits


# libzstd 1.5.7's HUF_selectDecoder timings: (table, per 256 bytes) for its
# single- and double-symbol decoders, by compressed / regenerated size in
# sixteenths.
_ALGO_TIME = (((0, 0), (1, 1)), ((0, 0), (1, 1)), ((150, 216), (381, 119)),
              ((170, 205), (514, 112)), ((177, 199), (539, 110)), ((197, 194), (644, 107)),
              ((221, 192), (735, 107)), ((256, 189), (881, 106)), ((359, 188), (1167, 109)),
              ((582, 187), (1570, 114)), ((688, 187), (1712, 122)), ((825, 186), (1965, 136)),
              ((976, 185), (2131, 150)), ((1180, 186), (2070, 175)), ((1377, 185), (1731, 202)),
              ((1412, 185), (1695, 202)))


def double_symbol(size: int, csize: int) -> bool:
    """HUF_selectDecoder: whether libzstd decodes four streams of `size`
    literals from `csize` bytes with its double-symbol (X2) decoder."""
    q = 15 if csize >= size else csize * 16 // size
    (t0, d0), (t1, d1) = _ALGO_TIME[q]
    time0, time1 = t0 + d0 * (size >> 8), t1 + d1 * (size >> 8)
    return time1 + (time1 >> 5) < time0


def _lookup(bs: _Backward, table, bits: int, x2: bool):
    """One table lookup: [(symbol, code length)], two when the double-symbol
    decoder's 11-bit (12 for a 12-bit code) window holds both codes."""
    s1, l1 = table[bs.peek(bits)]
    if not x2:
        return [(s1, l1)]
    window = 11 if bits <= 11 else 12
    rest = (bs.peek(window) << l1) & ((1 << window) - 1)
    s2, l2 = table[rest >> (window - bits)]
    return [(s1, l1), (s2, l2)] if l2 <= window - l1 else [(s1, l1)]


def _finish(bs: _Backward, table, bits: int, n: int, x2: bool, out: bytearray) -> None:
    """HUF_decodeStreamX1 / X2 up to `n` symbols in `out`: the double-symbol
    decoder takes lookups while two symbols fit, and a last symbol left
    alone whose lookup would take two consumes the rest of the stream."""
    while len(out) < n - (1 if x2 else 0):
        for s, length in _lookup(bs, table, bits, x2):
            out.append(s)
            bs.read(length)
    if len(out) < n:
        got = _lookup(bs, table, bits, True)
        out.append(got[0][0])
        if len(got) == 1:
            bs.read(got[0][1])
        elif bs.pos > 0:  # HUF_decodeLastSymbolX2 clamps to the stream's end
            bs.read(got[0][1] + got[1][1])
            bs.pos = max(bs.pos, 0)


def _huffman_stream(data: bytes, table, bits: int, n: int, x2: bool) -> bytes:
    """One Huffman stream of `n` symbols, as libzstd's single- (X1) or
    double-symbol (X2) decoder reads it: it must end with its symbols."""
    bs, out = _Backward(data), bytearray()
    _finish(bs, table, bits, n, x2, out)
    if not bs.done():
        _bad("a Huffman stream that does not end where its symbols do")
    return bytes(out)


def _fast_four(data: bytes, sizes, counts, table, bits: int, x2: bool) -> bytes:
    """Four Huffman streams through libzstd's fast loop (`data` from the jump
    table on): rounds of five lookups a stream, each stream read down to
    the jump table and reloaded by whole bytes, for as many rounds as the
    first stream's bytes and the outputs' room allow; then a stream read
    more than 8 bytes past its own start is an error, and each stream's
    last symbols are decoded with no check of where it ends (a last byte of
    zero is data)."""
    starts = [6 + sum(sizes[:k]) for k in range(4)]
    ends = [starts[k] + sizes[k] for k in range(4)]
    streams = [_Backward(data[:ends[k]], unmarked=True) for k in range(4)]
    ip = [e - 8 for e in ends]
    out = [bytearray() for _ in range(4)]
    while True:
        iters = ip[0] // 7
        if x2:
            iters = min([iters] + [(counts[k] - len(out[k])) // 10 for k in range(4)])
        else:
            iters = min(iters, (counts[3] - len(out[3])) // 5)
        limit = len(out[3]) + 5 * iters
        if len(out[3]) == limit or any(ip[k] < ip[k - 1] for k in (1, 2, 3)):
            break
        while True:
            for k in range(4):
                for _ in range(5):
                    for s, length in _lookup(streams[k], table, bits, x2):
                        out[k].append(s)
                        streams[k].read(length)
                ip[k] = -(-streams[k].pos // 8) - 8
            if len(out[3]) >= limit:
                break
    for k in range(4):
        if ip[k] < starts[k] - 8:
            _bad("a Huffman stream read past the one before it")
        _finish(streams[k], table, bits, counts[k], x2, out[k])
    return b"".join(bytes(o) for o in out)


def _literals(data: bytes, pos: int, end: int, st: dict):
    """A compressed block's literals section -> (literals, position after)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if pos > end or size > st["block_max"]:
            _bad("a literals header past the block")
        st["seen"].add(("raw", "rle")[kind] + " literals")
        if kind == 0:
            if pos + size > end:
                _bad("raw literals past the end of the block")
            return data[pos:pos + size], pos + size
        if pos >= end:
            _bad("RLE literals past the end of the block")
        return bytes([data[pos]]) * size, pos + 1
    head = 3 if fmt < 2 else fmt + 2
    if pos + head > end:
        _bad("a literals header past the block")
    h = int.from_bytes(data[pos:pos + head], "little")
    field = (10, 10, 14, 18)[fmt]
    size = (h >> 4) & ((1 << field) - 1)
    csize = (h >> (4 + field)) & ((1 << field) - 1)
    streams = 1 if fmt == 0 else 4
    pos += head
    if size > st["block_max"] or pos + csize > end:
        _bad("Huffman literals past the end of the block")
    stop = pos + csize
    st["seen"].add(f"{'huffman' if kind == 2 else 'treeless'} literals, {streams} stream"
                   f"{'s' if streams > 1 else ''}")
    if kind == 2:  # a new table, for libzstd's single- or double-symbol decoder
        weights, pos, how = _huffman_weights(data, pos, stop)
        st["seen"].add(f"{how} weights")
        st["huffman"] = huffman_table(weights) + (
            streams == 4 and double_symbol(size, csize),)
    elif st["huffman"] is None:
        _bad("treeless literals before any Huffman table")
    table, bits, x2 = st["huffman"]
    if streams == 1:
        return _huffman_stream(data[pos:stop], table, bits, size, x2), stop
    if stop - pos < 10 or size < 6:
        _bad("four Huffman streams in too little room")
    jump = pos
    sizes = [int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3)]
    pos += 6
    sizes.append(stop - pos - sum(sizes))
    if sizes[3] < 0:
        _bad("Huffman stream sizes past the literals")
    seg = (size + 3) // 4
    counts = [seg, seg, seg, size - 3 * seg]
    if counts[3] < 0:
        _bad("too few literals for four Huffman streams")
    if bits <= 11 and min(sizes) >= 8 and counts[3] > 0:  # libzstd's fast loop
        return _fast_four(data[jump:stop], sizes, counts, table, bits, x2), stop
    out = b""
    for s, n in zip(sizes, counts):
        out += _huffman_stream(data[pos:pos + s], table, bits, n, x2)
        pos += s
    return out, stop


def _seq_table(data: bytes, pos: int, end: int, mode: int, kind: str, st: dict):
    default, (max_symbol, max_log) = {"ll": (LL_DEFAULT, LL_MAX), "of": (OF_DEFAULT, OF_MAX),
                                      "ml": (ML_DEFAULT, ML_MAX)}[kind]
    st["seen"].add(f"{kind} {('predefined', 'rle', 'fse', 'repeat')[mode]}")
    if mode == 0:
        st[kind] = fse_table(*default)
    elif mode == 1:
        if pos >= end:
            _bad("an RLE sequence table past the end of the block")
        if data[pos] > max_symbol:
            _bad(f"an RLE {kind} symbol past {max_symbol}")
        st[kind] = ([(data[pos], 0, 0)], 0)
        pos += 1
    elif mode == 2:
        counts, log, pos = read_ncount(data[:end], pos, max_symbol, max_log)
        st[kind] = fse_table(counts, log)
    elif st[kind] is None:
        _bad(f"a repeated {kind} table before any")
    return pos


def _block(data: bytes, pos: int, end: int, out: bytearray, st: dict) -> None:
    """One compressed block, appended to `out`."""
    if end - pos < 1:
        _bad("an empty compressed block")
    lits, pos = _literals(data, pos, end, st)
    if pos >= end:
        _bad("a block without its sequences section")
    b0 = data[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            _bad("a sequences header past the block")
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            _bad("a sequences header past the block")
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    start = len(out)
    if nseq == 0:
        st["seen"].add("no sequences")
        if pos != end:
            _bad("bytes after a block's last sequence")
        out += lits
        return
    if pos >= end:
        _bad("a sequences header past the block")
    modes = data[pos]
    pos += 1
    if modes & 3:
        _bad("reserved bits set in the sequence modes")
    for kind, mode in (("ll", modes >> 6), ("of", (modes >> 4) & 3), ("ml", (modes >> 2) & 3)):
        pos = _seq_table(data, pos, end, mode, kind, st)
    if pos >= end:
        _bad("a sequences bitstream that is empty")
    bs = _Backward(data[pos:end])
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = st["ll"], st["of"], st["ml"]
    ll_s, of_s, ml_s = bs.read(ll_log), bs.read(of_log), bs.read(ml_log)
    rep, lit = st["rep"], 0
    for i in range(nseq):
        of_code, ll_code, ml_code = of_t[of_s][0], ll_t[ll_s][0], ml_t[ml_s][0]
        if of_code > 31:
            _bad("an offset code past 31")
        offset = (1 << of_code) + bs.read(of_code)
        ml = ML_CODES[ml_code][0] + bs.read(ML_CODES[ml_code][1])
        ll = LL_CODES[ll_code][0] + bs.read(LL_CODES[ll_code][1])
        if offset > 3:
            offset -= 3
            rep[:] = [offset, rep[0], rep[1]]
        else:
            k = offset - 1 + (ll == 0)
            if k == 0:
                offset = rep[0]
            elif k == 3:
                offset = rep[0] - 1
                if offset == 0:
                    _bad("a repeat offset of 0")
                rep[:] = [offset, rep[0], rep[1]]
            else:
                offset = rep[k]
                rep[:] = [offset] + [rep[j] for j in range(3) if j != k]
        if i < nseq - 1:
            for which in ("ll", "ml", "of"):
                table, state = {"ll": (ll_t, ll_s), "ml": (ml_t, ml_s), "of": (of_t, of_s)}[which]
                _, nb, base = table[state]
                new = base + bs.read(nb)
                if which == "ll":
                    ll_s = new
                elif which == "ml":
                    ml_s = new
                else:
                    of_s = new
        if lit + ll > len(lits):
            _bad("a sequence past the block's literals")
        out += lits[lit:lit + ll]
        lit += ll
        if offset > len(out):
            _bad("an offset past the start of the output")
        if len(out) - start + ml > st["block_max"]:
            _bad("a block that decodes past its largest size")
        src = len(out) - offset
        if offset >= ml:
            out += out[src:src + ml]
        else:
            for j in range(ml):
                out.append(out[src + j])
    if not bs.done():
        _bad("a sequences bitstream that does not end with its last sequence")
    out += lits[lit:]
    if len(out) - start > st["block_max"]:
        _bad("a block that decodes past its largest size")


def zstd_reference(data: bytes, out_size: int, seen: Optional[set] = None) -> np.ndarray:
    """The plain version of `native.zstd_decode` (module docstring): at most
    `out_size` bytes (uint8). `seen`, when given, collects the kinds of block,
    literals, Huffman weights and sequence table met (for the tests'
    coverage)."""
    data, out = bytes(data), bytearray()
    if out_size > 0:
        if len(data) < 4:
            _bad("a frame cut short before its magic number")
        magic = int.from_bytes(data[:4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable: libzstd returns 0, libtiff stops
            if len(data) < 8 or 8 + int.from_bytes(data[4:8], "little") > len(data):
                _bad("a skippable frame cut short")
        elif magic != MAGIC:
            _bad(f"magic number {magic:#010x}")
        else:
            _frame(data, 4, out, out_size, set() if seen is None else seen)
    return np.frombuffer(bytes(out[:out_size]), np.uint8)


def _frame(data: bytes, pos: int, out: bytearray, out_size: int, seen: set) -> int:
    if pos >= len(data):
        _bad("a frame header cut short")
    fhd = data[pos]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        _bad("the reserved bit of the frame header set")
    pos += 1
    head = (0 if single else 1) + (0, 1, 2, 4)[dict_flag] + (
        (1 if single else 0), 2, 4, 8)[fcs_flag]
    if pos + head > len(data):
        _bad("a frame header cut short")
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
        if log > 31:  # ZSTD_WINDOWLOG_MAX
            _bad("a window past what libzstd decodes")
    nd = (0, 1, 2, 4)[dict_flag]
    if nd and int.from_bytes(data[pos:pos + nd], "little"):
        _bad("a dictionary, which this frame needs and TIFF does not carry")
    pos += nd
    nf = ((1 if single else 0), 2, 4, 8)[fcs_flag]
    fcs = int.from_bytes(data[pos:pos + nf], "little") if nf else None
    if nf == 2:
        fcs += 256
    pos += nf
    if single:
        window = fcs
    if window > (1 << WINDOW_LOG_MAX) + 1:
        _bad("a window past what libzstd decodes")
    st = {"block_max": min(window, BLOCK_MAX), "huffman": None, "seen": seen,
          "ll": None, "of": None, "ml": None, "rep": [1, 4, 8]}
    start = len(out)
    while True:
        if pos + 3 > len(data):
            _bad("a block header cut short")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 3:
            _bad("a reserved block type")
        seen.add(("raw", "rle", "compressed")[kind] + " block")
        if size > st["block_max"]:
            _bad("a block past the frame's largest block size")
        if kind == 0:
            if pos + size > len(data):
                _bad("a raw block cut short")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos + 1 > len(data):
                _bad("an RLE block cut short")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            if pos + size > len(data):
                _bad("a compressed block cut short")
            _block(data, pos, pos + size, out, st)
            pos += size
        if fcs is not None and len(out) - start > fcs:
            _bad("a frame longer than its content size")
        if last:
            break
        if len(out) >= out_size:
            return pos
    if fcs is not None and len(out) - start != fcs:
        _bad("a frame shorter than its content size")
    # libzstd reads the checksum once the content is out; a buffer too
    # small for it, or data that ends before it, leaves it unread.
    if checksum and len(out) <= out_size and pos + 4 <= len(data):
        seen.add("checksum")
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != int.from_bytes(data[pos:pos + 4], "little"):
            _bad("a content checksum that does not match")
        pos += 4
    return pos
