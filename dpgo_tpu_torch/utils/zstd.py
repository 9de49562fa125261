"""Zstandard frame decoder (RFC 8878) in numpy and the standard library.

The Orbax checkpoint layout the JAX package writes (``utils.orbax_store``)
holds its OCDBT nodes and its zarr chunks as zstd frames; this module
reads them on a machine with no ``zstandard`` package.  It decodes what
RFC 8878 defines for a frame without a dictionary:

* frames: the header (single-segment flag, window descriptor, frame
  content size; a dictionary ID other than 0 raises), concatenated
  frames, skippable frames, and the XXH64 content checksum, verified;
* blocks: raw, RLE and compressed;
* literals sections: raw, RLE, Huffman-compressed and treeless, with one
  stream or four; Huffman tables from direct 4-bit weights or from
  FSE-compressed weights;
* sequences sections: predefined, RLE, FSE-compressed and repeat tables
  for literal lengths, offsets and match lengths, the three repeat
  offsets, read through the backward bit reader.

Huffman literals are where the time goes (an f32 array compresses to
literals only): every stream is decoded in numpy, with the symbol and
code length looked up at every bit offset at once and the chain of code
starts found by pointer doubling (``_huf_streams``).  Everything else is
plain Python.  Malformed input raises ``ZstdError`` (a ``ValueError``).
"""

from __future__ import annotations

import struct

import numpy as np

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50       # low 4 bits free: 0x184D2A50..5F
BLOCK_MAX = 128 * 1024
HUF_TABLE_LOG_MAX = 11

# Literal-length and match-length codes: (baseline, extra bits), RFC 8878
# sections 3.1.1.3.2.1.1 and 3.1.1.3.2.1.2.
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                             256, 512, 1024, 2048, 4096, 8192, 16384,
                             32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                      12, 13, 14, 15, 16]

# Predefined distributions (RFC 8878 section 3.1.1.3.2.2).
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
               2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1], 5)

#: Per table kind: (largest symbol, largest accuracy log, predefined).
SEQ_TABLES = {"ll": (35, 9, LL_DEFAULT), "of": (31, 8, OF_DEFAULT),
              "ml": (52, 9, ML_DEFAULT)}

#: pointer-doubling levels of the Huffman decoder: chains are walked in
#: steps of ``2**HUF_JUMP_LEVELS`` symbols, then expanded level by level.
HUF_JUMP_LEVELS = 3


class ZstdError(ValueError):
    """Malformed or unsupported zstd input."""


# ---------------------------------------------------------------------------
# XXH64 (the frame's content checksum is its low 32 bits)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the reference algorithm, in Python ints)."""
    n = len(data)
    mv = memoryview(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stop = n - n % 32
        for a, b, c, d in struct.iter_unpack("<4Q", mv[:stop]):
            v1 = _round(v1, a)
            v2 = _round(v2, b)
            v3 = _round(v3, c)
            v4 = _round(v4, d)
        i = stop
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        (k,) = struct.unpack_from("<Q", mv, i)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        (k,) = struct.unpack_from("<I", mv, i)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h = (_rotl(h ^ (mv[i] * _P5 & _M64), 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# Bit readers
# ---------------------------------------------------------------------------

class _Backward:
    """RFC 8878's backward bit stream: read from the last byte's highest
    set bit (the end mark, not data) down to bit 0 of the first byte.
    Reading past the start yields zeros; ``pos`` then goes negative, which
    is how a decoder sees it over-read."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ZstdError("backward bit stream without its end mark")
        self.buf = bytes(buf)
        self.pos = 8 * len(buf) - 9 + buf[-1].bit_length()

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p >= 0:
            i = p >> 3
            return ((int.from_bytes(self.buf[i:i + 8], "little") >> (p & 7))
                    & ((1 << n) - 1))
        q = p + n                       # bits left before this read
        if q <= 0:
            return 0
        return (int.from_bytes(self.buf[:8], "little") & ((1 << q) - 1)) << -p


# ---------------------------------------------------------------------------
# FSE tables
# ---------------------------------------------------------------------------

def _read_fse_description(data: bytes, pos: int, end: int, max_symbol: int,
                          max_log: int) -> tuple[list[int], int, int]:
    """Parse an FSE table description (RFC 8878 section 4.1.1) at
    ``data[pos:end]``: the normalized counts (-1 for "less than 1"), the
    accuracy log, and the position after the description."""
    window = data[pos:min(end, pos + 512)]
    if not window:
        raise ZstdError("FSE table description past the end of its section")
    v = int.from_bytes(window, "little")
    avail = 8 * len(window)
    log = (v & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    bit = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    probs: list[int] = []
    prev_zero = False
    while remaining > 1 and len(probs) <= max_symbol:
        if prev_zero:
            while True:
                rep = (v >> bit) & 3
                bit += 2
                probs.extend([0] * rep)
                if rep != 3:
                    break
            if len(probs) > max_symbol:
                break
        mx = 2 * threshold - 1 - remaining
        low = (v >> bit) & (threshold - 1)
        if low < mx:
            count = low
            bit += nbits - 1
        else:
            count = (v >> bit) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bit += nbits
        count -= 1
        remaining -= -count if count < 0 else count
        probs.append(count)
        prev_zero = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(probs) > max_symbol + 1 or bit > avail:
        raise ZstdError("corrupt FSE table description")
    return probs, log, pos + (bit + 7) // 8


def _build_fse(probs: list[int], log: int) -> tuple[list, list, list]:
    """The decoding table of a distribution: per state its symbol, the
    bits to read and the baseline of the next state (RFC 8878 section
    4.1.1)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(probs)
    for s, p in enumerate(probs):
        if p == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return sym, nbits, base


_PREDEFINED: dict[str, tuple] = {}


def _predefined(kind: str) -> tuple:
    if kind not in _PREDEFINED:
        probs, log = SEQ_TABLES[kind][2]
        _PREDEFINED[kind] = (*_build_fse(probs, log), log)
    return _PREDEFINED[kind]


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------

def _huf_table(weights: list[int]) -> tuple[np.ndarray, np.ndarray, int]:
    """The Huffman decoding table of the transmitted weights (the last
    symbol's weight is implied): symbol and code length at every
    ``table_log``-bit prefix."""
    w = np.asarray(weights, np.int64)
    if w.size == 0 or w.max() > HUF_TABLE_LOG_MAX:
        raise ZstdError("corrupt Huffman weights")
    total = int((np.where(w > 0, 1 << np.maximum(w - 1, 0), 0)).sum())
    if total == 0:
        raise ZstdError("Huffman weights are all zero")
    log = total.bit_length()             # 2**log > total
    rest = (1 << log) - total
    if rest & (rest - 1) or log > HUF_TABLE_LOG_MAX:
        raise ZstdError("Huffman weights do not complete a tree")
    w = np.append(w, rest.bit_length())
    if w.size > 256:
        raise ZstdError("more than 256 Huffman symbols")
    order = np.argsort(w, kind="stable")
    order = order[w[order] > 0]
    reps = 1 << (w[order] - 1)
    sym = np.repeat(order.astype(np.uint8), reps)
    nbits = np.repeat((log + 1 - w[order]).astype(np.uint8), reps)
    return sym, nbits, log


def _huf_weights(data: bytes, pos: int, end: int) -> tuple[list[int], int]:
    """The Huffman tree description at ``data[pos:end]`` (RFC 8878
    section 4.2.1): the transmitted weights and the position after it."""
    if pos >= end:
        raise ZstdError("missing Huffman tree description")
    hb = data[pos]
    pos += 1
    if hb >= 128:
        n = hb - 127
        nbytes = (n + 1) // 2
        if pos + nbytes > end:
            raise ZstdError("Huffman weights past the end of the literals")
        weights = []
        for b in data[pos:pos + nbytes]:
            weights += [b >> 4, b & 15]
        return weights[:n], pos + nbytes
    if pos + hb > end:
        raise ZstdError("Huffman weights past the end of the literals")
    probs, log, body = _read_fse_description(data, pos, pos + hb, 255, 6)
    sym, nbits, base = _build_fse(probs, log)
    br = _Backward(data[body:pos + hb])
    s1, s2 = br.read(log), br.read(log)
    weights = []
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + br.read(nbits[s1])
        if br.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + br.read(nbits[s2])
        if br.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    if len(weights) > 255:
        raise ZstdError("too many Huffman weights")
    return weights, pos + hb


def _stream_prefixes(stream: bytes, log: int) -> np.ndarray:
    """The ``log``-bit prefix at every bit offset of one backward stream,
    in reading order (offset 0 is the first bit after the end mark); the
    bits past the stream's start read as zeros."""
    if not stream or stream[-1] == 0:
        raise ZstdError("Huffman stream without its end mark")
    r = np.frombuffer(stream, np.uint8)[::-1].astype(np.uint32)
    m = r.size
    w = np.zeros(m + 2, np.uint32)
    w[:m] = r << 16
    w[:m] |= np.concatenate((r[1:] << 8, np.zeros(1, np.uint32)))
    w[:m] |= np.concatenate((r[2:], np.zeros(2, np.uint32)))
    w = w[:m]
    mask = (1 << log) - 1
    pre = np.empty((m, 8), np.uint16)
    for ph in range(8):
        pre[:, ph] = (w >> (24 - log - ph)) & mask
    lead = 9 - int(stream[-1]).bit_length()
    return pre.reshape(-1)[lead:]


def _huf_streams(streams: list[bytes], counts: list[int], sym: np.ndarray,
                 nbits: np.ndarray, log: int) -> np.ndarray:
    """Decode 1 or 4 Huffman streams of ``counts`` symbols at once.

    Every bit offset of every stream gets the symbol and code length its
    prefix decodes to; ``nxt`` maps an offset to the next code's start.
    The code starts of stream ``j`` are the chain from its offset 0:
    found by walking ``nxt`` raised to the ``2**HUF_JUMP_LEVELS``-th power
    (pointer doubling) in Python steps over the streams together, then
    filled in level by level with numpy gathers.  A stream must end
    exactly on its last code's last bit."""
    pres, bases, ends = [], [], []
    total = 0
    for s in streams:
        p = _stream_prefixes(s, log)
        pres += [p, np.zeros(1, np.uint16)]  # one sink slot per stream
        bases.append(total)
        ends.append(total + p.size)
        total += p.size + 1
    pre = np.concatenate(pres)
    lens = np.take(nbits, pre).astype(np.int64)
    nxt = np.arange(total, dtype=np.int64) + lens
    for e in ends:
        tail = slice(max(e - HUF_TABLE_LOG_MAX, 0), e + 1)
        nxt[tail] = np.minimum(nxt[tail], e)
        lens[e] = 0
        nxt[e] = e
    n = max(counts)
    if n == 0:
        return np.zeros(0, np.uint8)
    jumps = [nxt]
    levels = min(HUF_JUMP_LEVELS, max(n - 1, 1).bit_length())
    for _ in range(levels):
        j = jumps[-1]
        jumps.append(np.take(j, j))
    stride = 1 << levels
    steps = -(-n // stride)
    starts = np.empty((steps, len(streams)), np.int64)
    cur = np.asarray(bases, np.int64)
    far = jumps[levels]
    for t in range(steps):
        starts[t] = cur
        cur = far[cur]
    for k in range(levels - 1, -1, -1):
        wide = np.empty((2 * starts.shape[0], starts.shape[1]), np.int64)
        wide[0::2] = starts
        wide[1::2] = np.take(jumps[k], starts)
        starts = wide
    out = []
    for j, c in enumerate(counts):
        if c == 0:
            if ends[j] != bases[j]:
                raise ZstdError("Huffman stream holds bits past its symbols")
            continue
        at = starts[:c, j]
        last = int(at[-1])
        if last >= ends[j] or last + int(lens[last]) != ends[j]:
            raise ZstdError("Huffman stream does not end on its last code")
        out.append(np.take(sym, np.take(pre, at)))
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


# ---------------------------------------------------------------------------
# Frames and blocks
# ---------------------------------------------------------------------------

class _FrameState:
    """What a block may reuse from earlier blocks of its frame."""

    def __init__(self):
        self.huf = None                       # (sym, nbits, log)
        self.seq = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int,
              st: _FrameState) -> tuple[bytes, int]:
    """The literals section at ``data[pos:end]``: the literals and the
    position after the section."""
    b0 = data[pos]
    kind = b0 & 3
    sf = (b0 >> 2) & 3
    if kind in (0, 1):
        if sf in (0, 2):
            size, hs = b0 >> 3, 1
        elif sf == 1:
            size, hs = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            hs = 3
        pos += hs
        if size > BLOCK_MAX:
            raise ZstdError("literals above the block maximum")
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals past the end of the block")
            return data[pos:pos + size], pos + size
        if pos >= end:
            raise ZstdError("RLE literals past the end of the block")
        return bytes([data[pos]]) * size, pos + 1
    hs = {0: 3, 1: 3, 2: 4, 3: 5}[sf]
    if pos + hs > end:
        raise ZstdError("literals header past the end of the block")
    h = int.from_bytes(data[pos:pos + hs], "little")
    bits = {3: 10, 4: 14, 5: 18}[hs]
    size = (h >> 4) & ((1 << bits) - 1)
    csize = h >> (4 + bits)
    pos += hs
    stop = pos + csize
    if stop > end or size > BLOCK_MAX:
        raise ZstdError("compressed literals past the end of the block")
    if kind == 2:
        weights, pos = _huf_weights(data, pos, stop)
        st.huf = _huf_table(weights)
    elif st.huf is None:
        raise ZstdError("treeless literals with no earlier Huffman table")
    sym, nbits, log = st.huf
    if sf == 0:
        streams = [data[pos:stop]]
        counts = [size]
    else:
        if pos + 6 > stop:
            raise ZstdError("Huffman jump table past the literals")
        s1, s2, s3 = struct.unpack_from("<3H", data, pos)
        pos += 6
        cuts = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
        if cuts[3] > stop:
            raise ZstdError("Huffman jump table past the literals")
        streams = [data[cuts[i]:cuts[i + 1]] for i in range(4)]
        seg = (size + 3) // 4
        counts = [seg, seg, seg, size - 3 * seg]
        if counts[3] < 0:
            raise ZstdError("too few literals for four streams")
    lits = _huf_streams(streams, counts, sym, nbits, log)
    return lits.tobytes(), stop


def _seq_table(kind: str, mode: int, data: bytes, pos: int, end: int,
               st: _FrameState) -> int:
    max_symbol, max_log, _ = SEQ_TABLES[kind]
    if mode == 0:
        st.seq[kind] = _predefined(kind)
    elif mode == 1:
        if pos >= end or data[pos] > max_symbol:
            raise ZstdError(f"bad RLE {kind} code")
        st.seq[kind] = ([data[pos]], [0], [0], 0)
        pos += 1
    elif mode == 2:
        probs, log, pos = _read_fse_description(data, pos, end, max_symbol,
                                                max_log)
        st.seq[kind] = (*_build_fse(probs, log), log)
    elif st.seq[kind] is None:
        raise ZstdError(f"repeat {kind} table with no earlier table")
    return pos


def _sequences(data: bytes, pos: int, end: int, st: _FrameState,
               lits: bytes, out: bytearray) -> None:
    """Decode the sequences section at ``data[pos:end]`` and execute it
    against ``lits``, appending to the frame's output ``out``."""
    if pos >= end:
        raise ZstdError("missing sequences section")
    b0 = data[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise ZstdError("bytes after an empty sequences section")
        out += lits
        return
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    for kind, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _seq_table(kind, (modes >> shift) & 3, data, pos, end, st)
    ll_sym, ll_nb, ll_base, ll_log = st.seq["ll"]
    of_sym, of_nb, of_base, of_log = st.seq["of"]
    ml_sym, ml_nb, ml_base, ml_log = st.seq["ml"]
    br = _Backward(data[pos:end])
    read = br.read
    lls = read(ll_log)
    ofs = read(of_log)
    mls = read(ml_log)
    reps = st.reps
    lit = 0
    nlit = len(lits)
    for i in range(nseq):
        ofc = of_sym[ofs]
        mlc = ml_sym[mls]
        llc = ll_sym[lls]
        if ofc > 31:
            raise ZstdError("offset code above 31")
        ov = (1 << ofc) + read(ofc)
        ml = ML_BASE[mlc] + read(ML_BITS[mlc])
        ll = LL_BASE[llc] + read(LL_BITS[llc])
        if ov > 3:
            off = ov - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], off
        else:
            idx = ov - 1 + (ll == 0)
            if idx == 0:
                off = reps[0]
            else:
                off = reps[0] - 1 if idx == 3 else reps[idx]
                if idx != 1:
                    reps[2] = reps[1]
                reps[1] = reps[0]
                reps[0] = off
        if i != nseq - 1:
            lls = ll_base[lls] + read(ll_nb[lls])
            mls = ml_base[mls] + read(ml_nb[mls])
            ofs = of_base[ofs] + read(of_nb[ofs])
        if lit + ll > nlit:
            raise ZstdError("a sequence reads past the literals")
        out += lits[lit:lit + ll]
        lit += ll
        start = len(out) - off
        if off <= 0 or start < 0:
            raise ZstdError("match offset outside the frame's output")
        if off >= ml:
            out += out[start:start + ml]
        else:
            out += (out[start:] * (ml // off + 1))[:ml]
    if br.pos != 0:
        raise ZstdError("sequences bit stream not consumed exactly")
    out += lits[lit:]


def _frame(data: bytes, pos: int) -> tuple[bytes, int]:
    """Decode the zstd frame whose header starts at ``data[pos]`` (after
    its magic): its content and the position after it."""
    if pos >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    checksum, did_flag = (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    if not single:
        pos += 1                             # window descriptor
    did_size = (0, 1, 2, 4)[did_flag]
    did = int.from_bytes(data[pos:pos + did_size], "little")
    pos += did_size
    if did != 0:
        raise ZstdError(f"frame needs dictionary {did}; none is supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > len(data):
        raise ZstdError("truncated frame header")
    fcs = int.from_bytes(data[pos:pos + fcs_size], "little") if fcs_size \
        else None
    if fcs_size == 2:
        fcs += 256
    pos += fcs_size
    st = _FrameState()
    out = bytearray()
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = h & 1, (h >> 1) & 3, h >> 3
        if btype == 0:
            if pos + bsize > len(data):
                raise ZstdError("truncated raw block")
            out += data[pos:pos + bsize]
            pos += bsize
        elif btype == 1:
            if pos >= len(data):
                raise ZstdError("truncated RLE block")
            out += bytes([data[pos]]) * bsize
            pos += 1
        elif btype == 2:
            end = pos + bsize
            if end > len(data) or bsize > BLOCK_MAX:
                raise ZstdError("truncated or oversized compressed block")
            lits, at = _literals(data, pos, end, st)
            _sequences(data, at, end, st, lits, out)
            pos = end
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if fcs is not None and fcs != len(out):
        raise ZstdError(f"frame content size {fcs} but {len(out)} bytes "
                        "decoded")
    if checksum:
        if pos + 4 > len(data):
            raise ZstdError("truncated content checksum")
        (want,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
    return bytes(out), pos


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data``, concatenated;
    skippable frames are skipped.  Raises ``ZstdError`` on anything
    malformed or unsupported (a dictionary)."""
    data = bytes(data)
    parts = []
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("trailing bytes after the last frame")
        (magic,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if magic == FRAME_MAGIC:
            content, pos = _frame(data, pos)
            parts.append(content)
        elif magic & 0xFFFFFFF0 == SKIPPABLE_MAGIC:
            if pos + 4 > len(data):
                raise ZstdError("truncated skippable frame")
            (size,) = struct.unpack_from("<I", data, pos)
            pos += 4 + size
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
    if not parts and not data:
        raise ZstdError("empty input")
    return b"".join(parts)
