"""Wire format: length-prefixed frames (arrays only — no pickle).

A frame on the wire is an 8-byte little-endian unsigned length followed by
a payload in one of two self-describing formats:

* **packed (v2, the default)** — a raw little-endian columnar encoding:
  magic ``DPW2``, a CRC32 of the body, then per entry a UTF-8 key, the
  numpy dtype string, the shape, and the array bytes verbatim
  (``tobytes``).  Decoding is zero-copy: each array is a ``frombuffer``
  view into the received byte buffer, so a pose frame costs one
  allocation for the socket read and nothing per array.
* **npz (v1, the versioned fallback)** — an ``np.savez`` archive (one zip
  member per array).  Old peers send this; ``decode_payload`` sniffs the
  leading magic, so a fleet can mix v1 and v2 senders during a rolling
  upgrade (``Transport(wire_format="npz")`` keeps a new robot speaking v1
  to an old bus).

The length header is *untrusted input*: it is validated against a
configurable cap (default 64 MiB) before any buffer is sized from it, so a
corrupt or malicious header raises a clean ``ProtocolError`` instead of
attempting an OOM-sized allocation.  Payload decoding likewise wraps
failures (bit-flipped archives, CRC mismatches, truncated packed bodies)
in ``ProtocolError`` so the fault-tolerance layer can count and drop
corrupt frames rather than crash the robot.

``FrameAssembler`` is the incremental decoder used by the deadline-aware
TCP transport: bytes are fed in as they arrive, complete payloads come out,
and a recv deadline can interrupt mid-frame and resume later without
desynchronizing the stream.

Pose-set packing (the deployment hot path): ``pack_pose_set`` lays a
``{(robot, pose): block}`` dict out as ONE contiguous ``[k, r, d+1]``
payload plus int32 robot/pose index vectors — three arrays total instead
of one zip member per pose — with an opt-in bf16 wire dtype (values are
rounded to bfloat16 on send and accumulated in f32/f64 on receipt; see
``bf16_encode``).  ``pack_pose_dict`` remains the per-pose v1 vocabulary;
``unpack_pose_set`` reads either.

The PyTorch port's copy of ``dpgo_tpu.comms.protocol``: the same code, with its
imports pointed at the port's own modules.
"""

from __future__ import annotations

import io
import socket
import struct
import time
import zlib

import numpy as np

HEADER = struct.Struct("<Q")
DEFAULT_MAX_FRAME_BYTES = 64 * 2 ** 20  # 64 MiB

#: Packed-payload (v2) leading magic.  An npz body starts with zip's
#: ``PK\x03\x04``, so the first bytes unambiguously select the decoder.
PACKED_MAGIC = b"DPW2"
_PACKED_HEAD = struct.Struct("<4sII")     # magic, crc32(body), n_entries
_ENTRY_HEAD = struct.Struct("<HBB")       # key_len, dtype_len, ndim


class ProtocolError(Exception):
    """The byte stream violates the frame protocol (oversized length
    header, truncated/corrupt payload, CRC mismatch).  Distinct from
    transport errors: the connection may still be usable — the *frame* is
    bad."""


def encode_payload_npz(arrays: dict) -> bytes:
    """Serialize an array dict to npz bytes (the v1 frame body)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def encode_payload_packed(arrays: dict) -> bytes:
    """Serialize an array dict to the packed v2 frame body: raw
    little-endian header + ``tobytes`` per array, CRC32-protected."""
    parts = []
    for key, arr in arrays.items():
        a = np.asarray(arr)
        kb = key.encode("utf-8")
        dt = np.dtype(a.dtype).str.encode("ascii")
        if len(kb) > 0xFFFF or len(dt) > 0xFF or a.ndim > 0xFF:
            raise ProtocolError(f"unencodable entry {key!r}: "
                                f"key/dtype/ndim out of range")
        parts.append(_ENTRY_HEAD.pack(len(kb), len(dt), a.ndim))
        parts.append(kb)
        parts.append(dt)
        parts.append(struct.pack(f"<{a.ndim}I", *a.shape))
        parts.append(struct.pack("<Q", a.nbytes))
        parts.append(np.ascontiguousarray(a).tobytes())
    body = b"".join(parts)
    return _PACKED_HEAD.pack(PACKED_MAGIC, zlib.crc32(body),
                             len(arrays)) + body


def decode_payload_packed(data: bytes) -> dict:
    """Decode a packed v2 body into ``frombuffer`` views (zero-copy: the
    returned arrays alias ``data`` and are read-only)."""
    try:
        magic, crc, n_entries = _PACKED_HEAD.unpack_from(data, 0)
        if magic != PACKED_MAGIC:
            raise ProtocolError("bad packed-frame magic")
        body = memoryview(data)[_PACKED_HEAD.size:]
        if zlib.crc32(body) != crc:
            raise ProtocolError("packed-frame CRC mismatch")
        out = {}
        pos = 0
        for _ in range(n_entries):
            key_len, dt_len, ndim = _ENTRY_HEAD.unpack_from(body, pos)
            pos += _ENTRY_HEAD.size
            key = bytes(body[pos:pos + key_len]).decode("utf-8")
            pos += key_len
            dt = np.dtype(bytes(body[pos:pos + dt_len]).decode("ascii"))
            pos += dt_len
            shape = struct.unpack_from(f"<{ndim}I", body, pos)
            pos += 4 * ndim
            (nbytes,) = struct.unpack_from("<Q", body, pos)
            pos += 8
            count = int(np.prod(shape, dtype=np.int64)) if ndim else 1
            if nbytes != count * dt.itemsize or pos + nbytes > len(body):
                raise ProtocolError(
                    f"packed entry {key!r} inconsistent with body")
            # 0-d entries reshape to () like their npz counterparts.
            arr = np.frombuffer(body, dt, count,
                                offset=pos).reshape(shape)
            pos += nbytes
            out[key] = arr
        if pos != len(body):
            raise ProtocolError(f"{len(body) - pos} trailing bytes after "
                                "the last packed entry")
        return out
    except ProtocolError:
        raise
    except Exception as e:  # struct/unicode/dtype errors on mangled bytes
        raise ProtocolError(f"corrupt packed frame ({len(data)} bytes): "
                            f"{e}") from e


def encode_payload(arrays: dict, wire_format: str = "packed") -> bytes:
    """Serialize an array dict to a frame body (no length header).

    ``wire_format="packed"`` (default) emits the v2 columnar layout;
    ``"npz"`` keeps the v1 archive for old peers.  ``decode_payload``
    accepts either regardless of what this endpoint sends.
    """
    if wire_format == "npz":
        return encode_payload_npz(arrays)
    if wire_format != "packed":
        raise ValueError(f"unknown wire_format {wire_format!r}")
    return encode_payload_packed(arrays)


def decode_payload(data: bytes) -> dict:
    """Decode a frame body, sniffing the format off the leading magic; a
    mangled body of either format raises ``ProtocolError``."""
    if data[:4] == PACKED_MAGIC:
        return decode_payload_packed(data)
    try:
        with np.load(io.BytesIO(data)) as npz:
            return {k: npz[k] for k in npz.files}
    except Exception as e:  # zipfile/np.load raise a zoo of types
        raise ProtocolError(f"corrupt frame payload ({len(data)} bytes): "
                            f"{e}") from e


def encode_frame(arrays: dict, wire_format: str = "packed") -> bytes:
    data = encode_payload(arrays, wire_format)
    return HEADER.pack(len(data)) + data


class FrameAssembler:
    """Incremental length-prefixed frame decoder with a size cap.

    Feed raw bytes as they arrive; completed payloads (undecoded npz bytes)
    come out.  State survives across calls, so a transport can stop reading
    at a deadline mid-frame and resume on the next ``recv``.
    """

    def __init__(self, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.max_frame_bytes = int(max_frame_bytes)
        self._buf = bytearray()
        self._length: int | None = None

    def feed(self, data: bytes) -> list[bytes]:
        self._buf.extend(data)
        out = []
        while True:
            if self._length is None:
                if len(self._buf) < HEADER.size:
                    break
                (length,) = HEADER.unpack(bytes(self._buf[:HEADER.size]))
                if length > self.max_frame_bytes:
                    raise ProtocolError(
                        f"frame length header {length} exceeds the "
                        f"{self.max_frame_bytes}-byte cap (corrupt or "
                        "malicious peer?)")
                del self._buf[:HEADER.size]
                self._length = int(length)
            if len(self._buf) < self._length:
                break
            out.append(bytes(self._buf[:self._length]))
            del self._buf[:self._length]
            self._length = None
        return out

    @property
    def pending_bytes(self) -> int:
        """Bytes buffered toward an incomplete frame."""
        return len(self._buf)


# ---------------------------------------------------------------------------
# Blocking socket helpers (the original example wire functions, now capped)
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, arrays: dict) -> int:
    """Send one frame; returns bytes put on the wire."""
    frame = encode_frame(arrays)
    sock.sendall(frame)
    return len(frame)


def recv_frame(sock: socket.socket,
               max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> dict:
    """Blocking receive of one frame, header validated against the cap."""

    def recv_exact(k):
        chunks = []
        while k:
            c = sock.recv(k)
            if not c:
                raise ConnectionError("peer closed")
            chunks.append(c)
            k -= len(c)
        return b"".join(chunks)

    (length,) = HEADER.unpack(recv_exact(HEADER.size))
    if length > max_frame_bytes:
        raise ProtocolError(
            f"frame length header {length} exceeds the "
            f"{max_frame_bytes}-byte cap (corrupt or malicious peer?)")
    return decode_payload(recv_exact(int(length)))


# ---------------------------------------------------------------------------
# bf16 wire dtype (opt-in): round-to-nearest-even truncation to the high
# 16 bits of f32, shipped as uint16 — dependency-free (no ml_dtypes on the
# wire) and codec-agnostic (rides packed v2 and npz alike).
# ---------------------------------------------------------------------------

#: Documented bf16 wire parity bound: round-to-nearest bfloat16 keeps 7
#: explicit mantissa bits, so per-element relative error is at most
#: 2^-8 (half an ULP).  Tests assert round-trip error against this.
BF16_REL_ERR = 2.0 ** -8


def bf16_encode(arr: np.ndarray) -> np.ndarray:
    """f32/f64 -> uint16 holding the round-to-nearest-even bfloat16 bits."""
    f = np.ascontiguousarray(arr, np.float32)
    u = f.view(np.uint32)
    u = u + 0x7FFF + ((u >> 16) & 1)  # RNE: break ties toward even
    return (u >> 16).astype(np.uint16)


def bf16_decode(u16: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bits -> f32 (exact: bf16 embeds in f32)."""
    u = np.asarray(u16, np.uint32) << np.uint32(16)
    return u.view(np.float32)


# ---------------------------------------------------------------------------
# Pose-dictionary packing (the agent message vocabulary on the wire)
# ---------------------------------------------------------------------------

def pack_pose_dict(prefix: str, pose_dict: dict) -> dict:
    """Flatten {(robot, pose): block} to npz-safe ``{prefix}_{r}_{p}`` keys
    (the v1 per-pose vocabulary — one frame entry per pose block)."""
    return {f"{prefix}_{r}_{p}": np.asarray(block)
            for (r, p), block in pose_dict.items()}


def unpack_pose_dict(frame: dict, prefix: str) -> dict:
    out = {}
    for key, arr in frame.items():
        if key.startswith(prefix + "_"):
            _, r, p = key.rsplit("_", 2)
            out[(int(r), int(p))] = arr
    return out


# -- packed pose sets (v2 vocabulary: 3 frame entries for ANY pose count) ---

def pack_pose_arrays(prefix: str, robots: np.ndarray, poses: np.ndarray,
                     vals: np.ndarray, wire_dtype: str = "f64") -> dict:
    """Columnar pose payload: ``{prefix}:r`` / ``{prefix}:p`` int32 index
    vectors plus one contiguous ``[k, r, d+1]`` value payload
    (``{prefix}:x``, or ``{prefix}:xb`` uint16 when ``wire_dtype="bf16"``).
    """
    out = {f"{prefix}:r": np.asarray(robots, np.int32),
           f"{prefix}:p": np.asarray(poses, np.int32)}
    if wire_dtype == "bf16":
        out[f"{prefix}:xb"] = bf16_encode(vals)
    elif wire_dtype == "f32":
        out[f"{prefix}:x"] = np.asarray(vals, np.float32)
    elif wire_dtype == "f64":
        out[f"{prefix}:x"] = np.asarray(vals, np.float64)
    else:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}")
    return out


def pack_pose_set(prefix: str, pose_dict: dict,
                  wire_dtype: str = "f64") -> dict:
    """``pack_pose_arrays`` from a ``{(robot, pose): block}`` dict."""
    if not pose_dict:
        return {}
    keys = list(pose_dict)
    robots = np.fromiter((k[0] for k in keys), np.int32, len(keys))
    poses = np.fromiter((k[1] for k in keys), np.int32, len(keys))
    vals = np.stack([np.asarray(pose_dict[k]) for k in keys])
    return pack_pose_arrays(prefix, robots, poses, vals, wire_dtype)


def unpack_pose_arrays(frame: dict, prefix: str):
    """The packed-pose fast path: ``(robots, poses, vals_f64)`` with no
    per-pose Python, or None when the frame carries no packed set under
    ``prefix``.  bf16 payloads are widened through f32 on receipt (f32
    accumulate) before the f64 cast."""
    ri = frame.get(f"{prefix}:r")
    if ri is None:
        return None
    pi = frame[f"{prefix}:p"]
    xb = frame.get(f"{prefix}:xb")
    if xb is not None:
        vals = np.asarray(bf16_decode(np.asarray(xb)), np.float64)
    else:
        vals = np.asarray(frame[f"{prefix}:x"], np.float64)
    return (np.asarray(ri, np.int64).ravel(),
            np.asarray(pi, np.int64).ravel(), vals)


def unpack_pose_set(frame: dict, prefix: str) -> dict:
    """Pose dict from a frame in EITHER vocabulary: the packed ``:r/:p/:x``
    triplet when present, else the per-pose v1 keys."""
    packed = unpack_pose_arrays(frame, prefix)
    if packed is None:
        return unpack_pose_dict(frame, prefix)
    robots, poses, vals = packed
    return {(int(r), int(p)): vals[i]
            for i, (r, p) in enumerate(zip(robots, poses))}


# -- measurement batches (the serve-fleet RPC vocabulary) -------------------

def pack_measurements(prefix: str, meas) -> dict:
    """Columnar ``types.Measurements`` payload: the full struct-of-arrays
    batch as 12 frame entries under ``prefix`` — edge indices int32,
    value/precision columns float64, the inlier flags uint8.  Unlike the
    g2o-bytes upload this round-trips EVERYTHING (multi-robot indexing,
    GNC weights, known-inlier flags) bit-exactly, which is what lets an
    out-of-process fleet replica solve the same problem its parent
    constructed in memory."""
    return {
        f"{prefix}:d": np.int32(meas.d),
        f"{prefix}:n": np.int32(meas.num_poses),
        f"{prefix}:r1": np.asarray(meas.r1, np.int32),
        f"{prefix}:p1": np.asarray(meas.p1, np.int32),
        f"{prefix}:r2": np.asarray(meas.r2, np.int32),
        f"{prefix}:p2": np.asarray(meas.p2, np.int32),
        f"{prefix}:R": np.asarray(meas.R, np.float64),
        f"{prefix}:t": np.asarray(meas.t, np.float64),
        f"{prefix}:k": np.asarray(meas.kappa, np.float64),
        f"{prefix}:tau": np.asarray(meas.tau, np.float64),
        f"{prefix}:w": np.asarray(meas.weight, np.float64),
        f"{prefix}:in": np.asarray(meas.is_known_inlier, np.uint8),
    }


def unpack_measurements(frame: dict, prefix: str):
    """The ``Measurements`` under ``prefix``, or None when the frame does
    not carry one (``{prefix}:d`` absent)."""
    from ..types import Measurements  # local: protocol stays types-light

    if f"{prefix}:d" not in frame:
        return None
    return Measurements(
        d=int(np.asarray(frame[f"{prefix}:d"])),
        num_poses=int(np.asarray(frame[f"{prefix}:n"])),
        r1=np.asarray(frame[f"{prefix}:r1"], np.int64),
        p1=np.asarray(frame[f"{prefix}:p1"], np.int64),
        r2=np.asarray(frame[f"{prefix}:r2"], np.int64),
        p2=np.asarray(frame[f"{prefix}:p2"], np.int64),
        R=np.asarray(frame[f"{prefix}:R"], np.float64),
        t=np.asarray(frame[f"{prefix}:t"], np.float64),
        kappa=np.asarray(frame[f"{prefix}:k"], np.float64),
        tau=np.asarray(frame[f"{prefix}:tau"], np.float64),
        weight=np.asarray(frame[f"{prefix}:w"], np.float64),
        is_known_inlier=np.asarray(frame[f"{prefix}:in"], bool),
    )


# ---------------------------------------------------------------------------
# Trace context + clock stamps (the distributed-tracing wire vocabulary)
# ---------------------------------------------------------------------------

#: Optional trace-context entries a sender MAY attach to any frame: ids as
#: one int64 triplet, send timestamps as one float64 pair.  They ride both
#: codecs unchanged (just two more dict entries) and old peers ignore the
#: keys — ``unpack_pose_*`` matches on the pose prefix, ``apply_peer_frame``
#: pops them before parsing — so mixed traced/untraced fleets interoperate.
TRACE_IDS_KEY = "_trace"    # int64 [trace_id, span_id, sender_robot]
TRACE_T_KEY = "_trace_t"    # float64 [t_send_mono, t_send_wall]

#: Channel-level clock stamp (``ReliableChannel`` attaches one per outgoing
#: frame — heartbeats included — when telemetry is on): float64
#: [origin, t_send_mono, t_send_wall].  ``origin`` is the sender's robot id,
#: -1 for the bus hub, -2 when unknown.  The receiver pops it and records a
#: ``clock_sample`` event; ``obs.timeline`` estimates pairwise clock
#: offsets from the send/receive timestamp pairs.
CLOCK_KEY = "_ts"

#: Named negative ``origin`` / trace ``robot`` sentinels.  Robot ids are
#: non-negative; everything else on a timeline identifies itself with one
#: of these.  ``obs.timeline`` maps the serving-plane pair (<= -3) onto
#: the host track, the hub onto the bus track.
ORIGIN_BUS_HUB = -1
ORIGIN_UNKNOWN = -2
ORIGIN_SERVE_CLIENT = -3   # serve front-end client (solve_g2o)
ORIGIN_SERVE_SERVER = -4   # serve server/worker side
ORIGIN_FLEET_PARENT = -5   # fleet launcher/manager parent process

#: Fleet-plane actor id bands (ISSUE 20): every process on a merged
#: generation timeline identifies itself with one id.  Robots stay
#: non-negative and the serving sentinels keep -1..-5; multihost ranks
#: occupy -100-rank and out-of-process replicas -200-index, so
#: ``obs.timeline`` can give each process its own track and the clock
#: aligner can tell the launcher, every rank, and every replica apart.
_MH_RANK_BASE = 100
_PROC_REPLICA_BASE = 200


def mh_rank_actor(rank: int) -> int:
    """Timeline actor id of multihost rank ``rank`` (rank 0 -> -100)."""
    return -(_MH_RANK_BASE + int(rank))


def proc_replica_actor(replica_id) -> int:
    """Timeline actor id of an out-of-process replica.  Accepts an index
    or a replica-id string (``"r3"`` -> -203); non-numeric ids hash into
    the band deterministically."""
    if isinstance(replica_id, (int, np.integer)):
        idx = int(replica_id)
    else:
        digits = "".join(ch for ch in str(replica_id) if ch.isdigit())
        idx = int(digits) if digits else \
            sum(str(replica_id).encode("utf-8")) % 97
    return -(_PROC_REPLICA_BASE + abs(idx))


def pack_trace_entries(trace_id: int, span_id: int, robot: int) -> dict:
    """The optional trace-context frame entries for one outgoing message,
    stamped with the send time."""
    return {
        TRACE_IDS_KEY: np.asarray([trace_id, span_id, robot], np.int64),
        TRACE_T_KEY: np.asarray([time.monotonic(), time.time()],
                                np.float64),
    }


def unpack_trace_entries(frame: dict, pop: bool = True):
    """``(trace_id, span_id, robot, t_send_mono, t_send_wall)`` from a
    frame carrying trace context, else None.  ``pop=True`` (default)
    removes the entries so downstream parsers never see them.  A mangled
    context is dropped (None), never fatal — tracing must not break the
    data path."""
    get = frame.pop if pop else frame.get
    ids = get(TRACE_IDS_KEY, None)
    ts = get(TRACE_T_KEY, None)
    if ids is None or ts is None:
        return None
    try:
        ids = np.asarray(ids, np.int64).ravel()
        ts = np.asarray(ts, np.float64).ravel()
        return (int(ids[0]), int(ids[1]), int(ids[2]),
                float(ts[0]), float(ts[1]))
    except (ValueError, IndexError, TypeError):
        return None


def attach_clock(frame: dict, origin: int) -> dict:
    """Stamp ``frame`` with the channel-level clock entry — the SAME
    float64 triplet ``ReliableChannel`` attaches ([origin, t_send_mono,
    t_send_wall] under ``CLOCK_KEY``) — and return it.  Callers guard on
    ``obs.get_run()``: with telemetry off no stamp is attached and the
    wire stays byte-identical."""
    frame[CLOCK_KEY] = np.asarray(
        [float(origin), time.monotonic(), time.time()], np.float64)
    return frame


def pop_clock(frame: dict):
    """``(origin, t_send_mono, t_send_wall)`` popped off a stamped frame,
    else None.  Always pops (mixed telemetry-on/off peers interoperate);
    a mangled stamp is dropped, never fatal."""
    ts = frame.pop(CLOCK_KEY, None)
    if ts is None:
        return None
    try:
        ts = np.asarray(ts, np.float64).ravel()
        return (int(ts[0]), float(ts[1]), float(ts[2]))
    except (ValueError, IndexError, TypeError):
        return None


def pose_payload_nbytes(frame: dict, prefix: str) -> int:
    """Wire bytes of the pose set under ``prefix`` — read off the packed
    entries directly (no per-block iteration) when present."""
    n = 0
    for suffix in (":r", ":p", ":x", ":xb"):
        arr = frame.get(prefix + suffix)
        if arr is not None:
            n += np.asarray(arr).nbytes
    if n:
        return n
    return sum(np.asarray(v).nbytes for k, v in frame.items()
               if k.startswith(prefix + "_"))
