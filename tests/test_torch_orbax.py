"""The port's Orbax checkpoint pair on the CPU, against the JAX package's:

* ``utils.zstd`` against the ``zstandard`` package (property-based, on
  random, repetitive and float payloads at levels -5 to 22, one block or
  many, with and without checksums, concatenated and skippable frames),
  and on hand-built frames that need no package;
* ``utils.ocdbt`` against ``tensorstore`` on a store with interior nodes,
  and its refusals (CRC, magic, length, compression, a second process);
* ``utils.orbax_store``: chunk grids with edge chunks, raw and zstd
  chunks, and the layouts it refuses;
* ``utils.logger.save_checkpoint_orbax`` / ``load_checkpoint_orbax``: a
  checkpoint either package writes loads in the other bit for bit, with
  and without ``like``; the committed fixture written by the JAX package
  loads with no Orbax installed; a robust JAX solve checkpointed mid-GNC
  resumes in the port as the uninterrupted JAX solve continues.
"""

import json
import os
import re
import shutil
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dpgo_tpu.utils import logger as jlogger
from dpgo_tpu_torch.config import AgentParams
from dpgo_tpu_torch.models import rbcd
from dpgo_tpu_torch.utils import logger, ocdbt, orbax_store, zstd
from dpgo_tpu_torch.utils.partition import partition_contiguous
from dpgo_tpu_torch.utils.synthetic import make_measurements

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_data", "orbax_seed0")
LEVELS = (-5, 1, 3, 19, 22)
SIZES = (0, 1, 100, 5000, 70_000, 200_000, 2 * 128 * 1024)
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])

# zstandard 0.25, level 19 with a checksum: one compressed block with
# sequences (64 distinct bytes repeated 40 times, then b"tail").
SEQ_FRAME = bytes.fromhex(
    "28b52ffd6404097502004404000102030405060708090a0b0c0d0e0f101112131415"
    "161718191a1b1c1d1e1f202122232425262728292a2b2c2d2e2f303132333435363738"
    "393a3b3c3d3e3f7461696c0100406f063f4401223eecee")
SEQ_CONTENT = bytes(range(64)) * 40 + b"tail"


WORDS = [b"pose", b"graph", b"edge", b"robot", b"loop", b"closure", b"x"]


def payload(kind: str, size: int, seed: int) -> bytes:
    """Test data: random bytes, runs, a 4-letter alphabet, words, f32 or
    f64 normals, or ``masked``, a random 128 KiB block and its copy with
    every 100th byte set to one value (so the second block's literals
    are one repeated byte: RLE literals)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.bytes(size)
    if kind == "alpha4":
        return rng.integers(0, 4, size, dtype=np.uint8).tobytes()
    if kind == "words":
        return b" ".join(WORDS[i] for i in
                         rng.integers(0, len(WORDS), size // 4 + 1))[:size]
    if kind == "masked":
        block = np.frombuffer(rng.bytes(zstd.BLOCK_MAX), np.uint8)
        copy = block.copy()
        copy[::100] = ord("Q")
        return (block.tobytes() + copy.tobytes())[:size]
    if kind == "runs":
        runs = rng.integers(1, 300, size // 4 + 1)
        vals = rng.integers(0, 256, runs.size).astype(np.uint8)
        return np.repeat(vals, runs).tobytes()[:size]
    dtype = np.float32 if kind == "f32" else np.float64
    n = -(-size // np.dtype(dtype).itemsize)
    return rng.standard_normal(n).astype(dtype).tobytes()[:size]


def skippable(n: int, seed: int) -> bytes:
    return (struct.pack("<II", zstd.SKIPPABLE_MAGIC + seed % 16, n)
            + np.random.default_rng(seed).bytes(n))


def raw_frame(blocks, checksum: bool = False) -> bytes:
    """A frame of hand-built blocks: ``("raw", data)`` or ``("rle", byte,
    count)``, with a one-byte window and no content size."""
    out = bytearray(struct.pack("<I", zstd.FRAME_MAGIC))
    out += bytes([0x04 if checksum else 0x00, 0x58])   # window 1 MiB
    content = bytearray()
    for i, b in enumerate(blocks):
        last = i == len(blocks) - 1
        if b[0] == "raw":
            out += (last | (0 << 1) | (len(b[1]) << 3)).to_bytes(3, "little")
            out += b[1]
            content += b[1]
        else:
            out += (last | (1 << 1) | (b[2] << 3)).to_bytes(3, "little")
            out.append(b[1])
            content += bytes([b[1]]) * b[2]
    if checksum:
        out += struct.pack("<I", zstd.xxh64(bytes(content)) & 0xFFFFFFFF)
    return bytes(out)


# ---------------------------------------------------------------------------
# utils.zstd
# ---------------------------------------------------------------------------

@SETTINGS
@given(kind=st.sampled_from(["random", "runs", "alpha4", "words", "f32",
                            "f64", "masked"]),
       size=st.sampled_from(SIZES), seed=st.integers(0, 2**32 - 1),
       level=st.sampled_from(LEVELS), checksum=st.booleans(),
       content_size=st.booleans())
def test_zstd_decodes_what_zstandard_writes(kind, size, seed, level,
                                            checksum, content_size):
    """Every frame zstandard writes decodes to its payload, the same bytes
    every time (frames above 128 KiB hold several blocks; the payloads
    reach raw, RLE, Huffman and treeless literals in one and four
    streams, direct and FSE Huffman weights, and every sequence table
    mode)."""
    zs = pytest.importorskip("zstandard")
    data = payload(kind, size, seed)
    frame = zs.ZstdCompressor(level=level, write_checksum=checksum,
                              write_content_size=content_size).compress(data)
    first = zstd.decompress(frame)
    assert first == data
    assert zstd.decompress(frame) == first


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(parts=st.lists(st.tuples(st.sampled_from(["random", "runs", "words",
                                                "f32"]),
                                st.sampled_from(SIZES[:5]),
                                st.integers(0, 2**32 - 1),
                                st.sampled_from(LEVELS),
                                st.integers(-1, 40)),
                      min_size=1, max_size=4))
def test_zstd_concatenated_and_skippable_frames(parts):
    """Concatenated frames decode to their payloads joined; skippable
    frames between them (``skip`` >= 0 bytes) contribute nothing."""
    zs = pytest.importorskip("zstandard")
    stream, want = b"", b""
    for kind, size, seed, level, skip in parts:
        data = payload(kind, size, seed)
        stream += zs.ZstdCompressor(level=level).compress(data)
        want += data
        if skip >= 0:
            stream += skippable(skip, seed)
    assert zstd.decompress(stream) == want


def test_zstd_hand_built_frames():
    """Raw and RLE blocks, a content checksum, and a fixed frame with a
    compressed block and sequences, decoded with no zstd package; a
    flipped checksum byte raises."""
    data = np.random.default_rng(5).bytes(3000)
    blocks = [("raw", data[:1000]), ("rle", 0xAB, 70_000),
              ("raw", data[1000:]), ("rle", 0x00, 1)]
    want = data[:1000] + b"\xab" * 70_000 + data[1000:] + b"\x00"
    for checksum in (False, True):
        assert zstd.decompress(raw_frame(blocks, checksum)) == want
    assert zstd.decompress(SEQ_FRAME) == SEQ_CONTENT
    assert zstd.decompress(SEQ_FRAME + skippable(7, 3) + SEQ_FRAME) == \
        SEQ_CONTENT * 2
    for frame in (raw_frame(blocks, True), SEQ_FRAME):
        bad = bytearray(frame)
        bad[-2] ^= 0x10
        with pytest.raises(ValueError, match="checksum"):
            zstd.decompress(bytes(bad))


def test_xxh64_reference_values():
    """XXH64 at seed 0 against the algorithm's published values."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


@pytest.mark.parametrize("fault", ["dictionary", "reserved_block", "magic",
                                   "truncated", "fcs_mismatch"])
def test_zstd_refuses(fault):
    """A dictionary, a reserved block type, a foreign magic, a cut frame
    and a wrong content size each raise ``ZstdError`` (a ValueError)."""
    frame = bytearray(raw_frame([("raw", b"hello")]))
    if fault == "dictionary":
        frame = (struct.pack("<I", zstd.FRAME_MAGIC) + bytes([0x01, 0x58, 7])
                 + frame[6:])
    elif fault == "reserved_block":
        frame[6] |= 0b110
    elif fault == "magic":
        frame[0] ^= 1
    elif fault == "truncated":
        frame = frame[:-2]
    else:
        # single segment, 1-byte content size 4 for 5 bytes of content
        frame = (struct.pack("<I", zstd.FRAME_MAGIC) + bytes([0x20, 4])
                 + frame[6:])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame))


# ---------------------------------------------------------------------------
# utils.ocdbt and utils.orbax_store
# ---------------------------------------------------------------------------

def test_ocdbt_interior_nodes_match_tensorstore(tmp_path):
    """A store tensorstore wrote with small nodes (a B-tree of height > 1,
    values inline and in data files) reads every key as tensorstore does,
    and absent keys as absent."""
    ts = pytest.importorskip("tensorstore")
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{tmp_path}/",
        "config": {"max_decoded_node_bytes": 300,
                   "max_inline_value_bytes": 16}}).result()
    with ts.Transaction() as txn:
        for i in range(120):
            kv.with_transaction(txn)[f"key{i:04d}/sub"] = \
                (b"v%d" % i) * (1 + i % 9)
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert store._root[3] > 1                  # the root's height
    keys = [k.decode() for k in kv.list().result()]
    assert len(keys) == 120
    for k in keys:
        assert store.get(k) == kv.read(k).result().value
    for absent in ("key0050/su", "key0050/subs", "a", "zzz"):
        assert store.get(absent) is None


def fixture_copy(tmp_path) -> str:
    dst = os.path.join(str(tmp_path), "ck")
    shutil.copytree(FIXTURE, dst)
    return dst


@pytest.mark.parametrize("fault", ["crc", "magic", "length", "compression",
                                   "second_process"])
def test_ocdbt_refuses_with_the_file_named(tmp_path, fault):
    """A flipped CRC byte, a wrong magic or length field, an unknown
    compression id and a second process's tree raise ValueError naming
    the file."""
    ck = fixture_copy(tmp_path)
    state = os.path.join(ck, "state")
    name = os.path.join(state, "manifest.ocdbt")
    with open(name, "rb") as f:
        buf = bytearray(f.read())
    if fault == "second_process":
        name = os.path.join(state, "ocdbt.process_1")
        os.makedirs(name)
    else:
        if fault == "crc":
            buf[-1] ^= 0x01
        elif fault == "magic":
            buf[1] ^= 0x01
        elif fault == "length":
            buf += b"\x00"
        elif fault == "compression":
            buf[13] = 7
            buf[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(buf[:-4])))
        with open(name, "wb") as f:
            f.write(buf)
    with pytest.raises(ValueError, match=re.escape(name)):
        logger.load_checkpoint_orbax(ck)


def write_zarr(leaf: str, a: np.ndarray, chunks, compressor=None,
               **over) -> None:
    """A zarr v2 array in the per-directory layout, chunked by hand."""
    os.makedirs(leaf)
    meta = {"chunks": list(chunks), "compressor": compressor,
            "dimension_separator": ".", "dtype": a.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2, **over}
    with open(os.path.join(leaf, ".zarray"), "w") as f:
        json.dump(meta, f)
    grid = [-(-s // c) for s, c in zip(a.shape, chunks)]
    for idx in np.ndindex(*grid):
        block = np.zeros(chunks, a.dtype)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, a.shape))
        part = a[sl]
        block[tuple(slice(0, n) for n in part.shape)] = part
        raw = block.tobytes()
        if meta["compressor"] == {"id": "zstd", "level": 3}:
            raw = pytest.importorskip("zstandard").ZstdCompressor(
                level=3).compress(raw)
        with open(os.path.join(leaf, ".".join(map(str, idx))), "wb") as f:
            f.write(raw)


def tree_dir(tmp_path, arrays: dict, chunks: dict, compressor=None,
             **over) -> str:
    """An Orbax checkpoint of ``arrays`` in the per-directory layout."""
    path = os.path.join(str(tmp_path), "state")
    os.makedirs(path)
    meta = {}
    for name, a in arrays.items():
        write_zarr(os.path.join(path, name), a, chunks[name], compressor,
                   **over)
        meta[str((name,))] = {"key_metadata": [{"key": name,
                                                "key_type": 2}]}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": False,
                   "use_zarr3": False}, f)
    return path


@pytest.mark.parametrize("compressor", [None, {"id": "zstd", "level": 3}])
def test_chunk_grid_with_edge_chunks(tmp_path, compressor):
    """A C-order grid of chunks, edge chunks padded as zarr v2 stores
    them, raw and zstd, assembles to the array."""
    rng = np.random.default_rng(11)
    arrays = {"X": rng.standard_normal((5, 7, 3)).astype(np.float32),
              "w": rng.integers(-9, 9, (10,), dtype=np.int64)}
    path = tree_dir(tmp_path, arrays, {"X": (2, 3, 2), "w": (4,)},
                    compressor)
    out = orbax_store.read_tree(path)
    for name, a in arrays.items():
        assert out[name].dtype == a.dtype
        assert out[name].tobytes() == a.tobytes()


@pytest.mark.parametrize("fault", ["compressor", "filters", "order",
                                   "zarr3"])
def test_refused_layouts_name_what_they_refuse(tmp_path, fault):
    """An unknown compressor, a filter, F order and a zarr v3 checkpoint
    each raise ValueError with the name."""
    over, match = {
        "compressor": ({"compressor": {"id": "blosc", "cname": "lz4"}},
                       "blosc"),
        "filters": ({"filters": [{"id": "delta", "dtype": "<f8"}]},
                    "delta"),
        "order": ({"order": "F"}, "order 'F'"),
        "zarr3": ({}, "zarr v3")}[fault]
    path = tree_dir(tmp_path, {"X": np.arange(6.0).reshape(2, 3)},
                    {"X": (2, 3)}, **over)
    if fault == "zarr3":
        with open(os.path.join(path, "_METADATA")) as f:
            meta = json.load(f)
        meta["use_zarr3"] = True
        with open(os.path.join(path, "_METADATA"), "w") as f:
            json.dump(meta, f)
    with pytest.raises(ValueError, match=match):
        orbax_store.read_tree(path)


# ---------------------------------------------------------------------------
# utils.logger's Orbax pair, against the JAX package's
# ---------------------------------------------------------------------------

def checkpoint(x_shape, x_dtype, w_shape, seed: int, cls=logger.Checkpoint):
    rng = np.random.default_rng(seed)
    return cls(X=rng.standard_normal(x_shape).astype(x_dtype),
               weights=rng.uniform(size=w_shape), mu=0.014 * (seed + 1),
               iteration=123 + seed)


def like_of(ck, x_dtype, w_dtype, cls):
    return cls(X=np.zeros(np.shape(ck.X), x_dtype),
               weights=np.zeros(np.shape(ck.weights), w_dtype), mu=0.0,
               iteration=0)


def same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


SHAPES = [((3, 6, 5, 4), np.float64, (3, 9)),
          ((8, 316, 5, 4), np.float32, (8, 700)),
          ((2, 5, 5, 4), np.float64, (2, 6))]
LIKES = [None, "saved", (np.float32, np.float64), (np.float64, np.float32)]


@pytest.mark.parametrize("like", LIKES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: str(s[0]))
def test_port_checkpoint_loads_in_jax(tmp_path, shape, like):
    """What the port writes (``mu`` and ``iteration`` 0-d float64 and
    int64), the JAX package's loader restores bit for bit, untyped and
    against a ``like`` (the saved dtypes or others), as the port's own
    loader does."""
    pytest.importorskip("orbax.checkpoint")
    ck = checkpoint(*shape, seed=len(str(like)))
    logger.save_checkpoint_orbax(ck, str(tmp_path))
    tree = orbax_store.read_tree(os.path.join(str(tmp_path), "state"))
    assert (tree["mu"].shape, tree["mu"].dtype) == ((), np.float64)
    assert (tree["iteration"].shape, tree["iteration"].dtype) == \
        ((), np.int64)
    jlike = plike = None
    if like is not None:
        dt = (ck.X.dtype, ck.weights.dtype) if like == "saved" else like
        jlike = like_of(ck, *dt, jlogger.Checkpoint)
        plike = like_of(ck, *dt, logger.Checkpoint)
    j = jlogger.load_checkpoint_orbax(str(tmp_path), like=jlike)
    p = logger.load_checkpoint_orbax(str(tmp_path), like=plike)
    assert same(j.X, p.X) and same(j.weights, p.weights)
    assert j.mu == p.mu == ck.mu and j.iteration == p.iteration == \
        ck.iteration
    if like in (None, "saved"):
        assert same(p.X, ck.X) and same(p.weights, ck.weights)


@pytest.mark.parametrize("like", LIKES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: str(s[0]))
def test_jax_checkpoint_loads_in_port(tmp_path, shape, like):
    """What the JAX package writes (OCDBT, zstd chunks; at the stand-in's
    agent shape values lie in data files and frames hold several
    blocks), the port restores bit for bit as the JAX loader does,
    untyped and against a ``like`` of the saved or another dtype."""
    pytest.importorskip("orbax.checkpoint")
    ck = checkpoint(*shape, seed=7 + len(str(like)), cls=jlogger.Checkpoint)
    jlogger.save_checkpoint_orbax(ck, str(tmp_path))
    jlike = plike = None
    if like is not None:
        dt = (ck.X.dtype, ck.weights.dtype) if like == "saved" else like
        jlike = like_of(ck, *dt, jlogger.Checkpoint)
        plike = like_of(ck, *dt, logger.Checkpoint)
    j = jlogger.load_checkpoint_orbax(str(tmp_path), like=jlike)
    p = logger.load_checkpoint_orbax(str(tmp_path), like=plike)
    assert same(j.X, p.X) and same(j.weights, p.weights)
    assert j.mu == p.mu == ck.mu and j.iteration == p.iteration == \
        ck.iteration
    if like in (None, "saved"):
        assert same(p.X, ck.X) and same(p.weights, ck.weights)


@pytest.mark.parametrize("target", ["bigger", "other_rank"])
def test_like_of_another_shape_keeps_the_saved_shape(tmp_path, target):
    """A ``like`` whose shapes differ from the saved ones: the JAX loader
    returns the saved shapes at ``like``'s dtypes, and so does the
    port."""
    pytest.importorskip("orbax.checkpoint")
    ck = checkpoint((2, 5, 5, 4), np.float64, (2, 6), seed=3,
                    cls=jlogger.Checkpoint)
    jlogger.save_checkpoint_orbax(ck, str(tmp_path))
    shapes = {"bigger": ((2, 6, 5, 4), (2, 8)),
              "other_rank": ((10, 5, 4), (12,))}[target]
    kw = dict(X=np.zeros(shapes[0], np.float32),
              weights=np.zeros(shapes[1], np.float16), mu=0.0, iteration=0)
    j = jlogger.load_checkpoint_orbax(str(tmp_path),
                                      like=jlogger.Checkpoint(**kw))
    p = logger.load_checkpoint_orbax(str(tmp_path),
                                     like=logger.Checkpoint(**kw))
    assert p.X.shape == ck.X.shape and p.X.dtype == np.float32
    assert same(j.X, p.X) and same(j.weights, p.weights)


def fixture_arrays() -> logger.Checkpoint:
    rng = np.random.default_rng(0)
    return logger.Checkpoint(
        X=rng.standard_normal((2, 40, 5, 4)).astype(np.float32),
        weights=rng.uniform(size=(2, 50)), mu=0.25, iteration=17)


def test_committed_fixture_loads_in_the_port():
    """``tests/torch_data/orbax_seed0`` was written once by the JAX
    package's pair, from the repo root::

        import numpy as np
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from dpgo_tpu.utils import logger

        rng = np.random.default_rng(0)
        logger.save_checkpoint_orbax(logger.Checkpoint(
            X=rng.standard_normal((2, 40, 5, 4)).astype(np.float32),
            weights=rng.uniform(size=(2, 50)), mu=0.25, iteration=17),
            "tests/torch_data/orbax_seed0")

    It loads through the port to the seed's arrays, bit for bit, with no
    Orbax, tensorstore or zstandard (X's chunk is a Huffman-coded block
    in four streams, weights' a raw block)."""
    want = fixture_arrays()
    for like in (None, want):
        got = logger.load_checkpoint_orbax(FIXTURE, like=like)
        assert same(got.X, want.X) and same(got.weights, want.weights)
        assert got.mu == want.mu and got.iteration == want.iteration


def test_loading_imports_no_jax_orbax_or_zstd_package():
    """Importing the port's logger and loading the fixture leaves jax,
    orbax, tensorstore and zstandard out of ``sys.modules`` (a fresh
    interpreter: this one has imported them)."""
    code = ("import sys; from dpgo_tpu_torch.utils import logger; "
            f"ck = logger.load_checkpoint_orbax({FIXTURE!r}); "
            "assert ck.iteration == 17; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'orbax', 'tensorstore', 'zstandard', "
            "'dpgo_tpu')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_save_replaces_atomically_and_takes_tensors(tmp_path):
    """A second save replaces the first and leaves no temporary sibling;
    tensors are saved through numpy and a tensor ``like`` sets the
    dtypes."""
    first = checkpoint((2, 5, 5, 4), np.float64, (2, 6), seed=1)
    logger.save_checkpoint_orbax(first, str(tmp_path))
    second = logger.Checkpoint(
        X=torch.arange(40, dtype=torch.float32).reshape(2, 5, 4),
        weights=torch.ones(3, dtype=torch.float64),
        mu=torch.tensor(0.5, dtype=torch.float64), iteration=4)
    logger.save_checkpoint_orbax(second, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["state"]
    got = logger.load_checkpoint_orbax(str(tmp_path))
    assert same(got.X, second.X.numpy())
    assert same(got.weights, second.weights.numpy())
    assert got.mu == 0.5 and got.iteration == 4
    like = logger.Checkpoint(X=torch.zeros(1, dtype=torch.float64),
                             weights=torch.zeros(1, dtype=torch.float16),
                             mu=0.0, iteration=0)
    got = logger.load_checkpoint_orbax(str(tmp_path), like=like)
    assert got.X.dtype == np.float64 and got.weights.dtype == np.float16


def test_mid_gnc_jax_orbax_checkpoint_resumes_in_the_port(tmp_path):
    """A robust GNC-TLS JAX solve checkpointed mid-GNC through the JAX
    package's Orbax pair resumes in the port through the port's
    ``load_checkpoint_orbax`` (fresh state, ``refresh_problem`` for the
    carried factors) and continues as the uninterrupted JAX solve does,
    at rtol 1e-9."""
    pytest.importorskip("orbax.checkpoint")
    from dpgo_tpu.config import AgentParams as JAgentParams
    from dpgo_tpu.config import RobustCostParams as JRobust
    from dpgo_tpu.config import RobustCostType as JType
    from dpgo_tpu.models import rbcd as jrbcd
    from dpgo_tpu.utils.partition import partition_contiguous as jpart
    from dpgo_tpu_torch.config import RobustCostParams, RobustCostType

    meas = make_measurements(np.random.default_rng(42), n=20, d=3,
                             num_lc=10, outlier_lc=3, rot_noise=0.01,
                             trans_noise=0.01)[0]
    rk = dict(gnc_barc=0.5)
    jparams = JAgentParams(d=3, r=5, num_robots=4,
                           robust=JRobust(cost_type=JType.GNC_TLS, **rk),
                           robust_opt_inner_iters=10)
    params = AgentParams(d=3, r=5, num_robots=4,
                         robust=RobustCostParams(
                             cost_type=RobustCostType.GNC_TLS, **rk),
                         robust_opt_inner_iters=10)

    def j_step_to(state, graph, meta, start, stop):
        for it in range(start, stop):
            state = jrbcd.rbcd_step(state, graph, meta, jparams,
                                    update_weights=(it + 1) % 10 == 0)
        return state

    jp = jpart(meas, 4)
    jgraph, jmeta = jrbcd.build_graph(jp, 5, jnp.float64)
    jX0 = jrbcd.centralized_chordal_init(jp, jmeta, jgraph, jnp.float64)
    jstate = j_step_to(jrbcd.init_state(jgraph, jmeta, jX0, params=jparams),
                       jgraph, jmeta, 0, 25)
    assert 0.0 < float(jstate.mu) and int(jstate.iteration) == 25
    jlogger.save_checkpoint_orbax(jlogger.Checkpoint(
        X=np.asarray(jstate.X), weights=np.asarray(jstate.weights),
        mu=float(jstate.mu), iteration=int(jstate.iteration)),
        str(tmp_path))
    jfull = j_step_to(jstate, jgraph, jmeta, 25, 40)

    part = partition_contiguous(meas, 4)
    graph, meta = rbcd.build_graph(part, 5, torch.float64, device="cpu")
    X0 = rbcd.centralized_chordal_init(part, meta, graph, torch.float64)
    fresh = rbcd.init_state(graph, meta, X0, params=params)
    ck = logger.load_checkpoint_orbax(
        str(tmp_path), like=logger.Checkpoint(X=fresh.X,
                                              weights=fresh.weights,
                                              mu=0.0, iteration=0))
    st = fresh._replace(X=torch.from_numpy(ck.X),
                        weights=torch.from_numpy(ck.weights),
                        mu=torch.tensor(ck.mu, dtype=torch.float64),
                        iteration=int(ck.iteration))
    st = rbcd.refresh_problem(st, graph, meta, params)
    for it in range(ck.iteration, 40):
        st = rbcd.rbcd_segment(st, graph, 1, meta, params,
                               first_update_weights=(it + 1) % 10 == 0)
    assert st.iteration == int(jfull.iteration) == 40
    np.testing.assert_allclose(st.X.numpy(), np.asarray(jfull.X),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(st.weights.numpy(),
                               np.asarray(jfull.weights), rtol=1e-9,
                               atol=1e-12)
    assert np.isclose(float(st.mu), float(jfull.mu), rtol=1e-12)


def test_load_timing_script_reports_on_the_fixture(capsys):
    """``experiments.orbax_load_timing`` decodes X's frame at every step
    length and through the one-lookup loop to the same bytes, and prints
    its JSON line (here on the committed fixture)."""
    from dpgo_tpu_torch.experiments import orbax_load_timing

    assert orbax_load_timing.main([FIXTURE, "--reps", "1"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["content_bytes"] == 2 * 40 * 5 * 4 * 4
    assert sorted(row["decode_s_by_levels"]) == \
        sorted(str(lv) for lv in orbax_load_timing.LEVELS)
    assert row["decode_s_one_lookup"] > 0
    assert zstd._huf_streams.__module__ == zstd.__name__
