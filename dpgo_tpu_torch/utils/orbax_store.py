"""The Orbax ``StandardCheckpointer`` layout of a tree of arrays, read and
written without Orbax: zarr v2 arrays under one directory, with Orbax's
``_METADATA`` and ``_CHECKPOINT_METADATA`` beside them.

* ``read_tree`` reads what Orbax writes either way: with ``use_ocdbt``
  (the default of orbax-checkpoint 0.11, which the JAX package's
  ``save_checkpoint_orbax`` writes) every ``<leaf>/.zarray`` and chunk is
  a key of the OCDBT store in the directory (``utils.ocdbt``); without
  it, they are files of a directory per leaf.  Any C-order chunk grid is
  assembled, edge chunks included, from chunks stored raw (compressor
  ``null``) or as zstd frames (``utils.zstd``).  Another compressor, a
  filter, F order or zarr v3 raises ``ValueError`` naming it.
* ``write_tree`` writes the per-directory layout (``"use_ocdbt":
  false``), each array uncompressed in one chunk, which Orbax restores
  as it restores its own.  The commit is atomic: the tree is written to
  a temporary sibling directory, which is then renamed into place; an
  existing checkpoint there is replaced (Orbax's ``force=True``).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time

import numpy as np

from . import zstd
from .ocdbt import OcdbtStore

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
#: The handler orbax-checkpoint 0.11 names for ``StandardCheckpointer``.
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
#: Orbax's ``key_type`` of a dict key.
DICT_KEY = 2


def _leaf_names(meta: dict, where: str) -> list[str]:
    names = []
    for entry in meta.get("tree_metadata", {}).values():
        keys = entry.get("key_metadata", [])
        if not keys:
            raise ValueError(f"{where}: a tree entry without keys")
        names.append(".".join(str(k["key"]) for k in keys))
    return names


def _chunk_bytes(raw: bytes, compressor, where: str) -> bytes:
    if compressor is None:
        return raw
    if compressor.get("id") == "zstd":
        try:
            return zstd.decompress(raw)
        except zstd.ZstdError as e:
            raise ValueError(f"{where}: {e}") from None
    raise ValueError(f"{where}: compressor {compressor.get('id')!r} is not "
                     "read (only null and zstd)")


def _array(zarray: dict, chunk, where: str) -> np.ndarray:
    """Assemble one zarr v2 array; ``chunk(key)`` returns a chunk's stored
    bytes, or ``None`` where the chunk is absent (then it is fill)."""
    if zarray.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr format {zarray.get('zarr_format')} "
                         "(only 2 is read)")
    if zarray.get("order", "C") != "C":
        raise ValueError(f"{where}: order {zarray['order']!r} (only C is "
                         "read)")
    if zarray.get("filters"):
        raise ValueError(f"{where}: filters {zarray['filters']!r} are not "
                         "read")
    dtype = np.dtype(zarray["dtype"])
    if dtype.hasobject or dtype.fields is not None:
        raise ValueError(f"{where}: dtype {zarray['dtype']!r} is not read")
    shape = tuple(int(s) for s in zarray["shape"])
    chunks = tuple(int(c) for c in zarray["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{where}: chunks {list(chunks)} do not fit shape "
                         f"{list(shape)}")
    sep = zarray.get("dimension_separator", ".")
    fill = zarray.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    compressor = zarray.get("compressor")
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = sep.join(str(i) for i in idx) if idx else "0"
        raw = chunk(key)
        if raw is None:
            continue
        data = _chunk_bytes(raw, compressor, f"{where}/{key}")
        want = math.prod(chunks) * dtype.itemsize
        if len(data) != want:
            raise ValueError(f"{where}/{key}: {len(data)} bytes, expected "
                             f"{want}")
        block = np.frombuffer(data, dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def read_tree(path: str) -> dict[str, np.ndarray]:
    """Every leaf of the Orbax checkpoint at ``path`` (the directory that
    holds ``_METADATA``), by its name (keys joined by ``.``)."""
    path = os.path.abspath(path)
    where = os.path.join(path, METADATA)
    with open(where) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{where}: zarr v3 arrays are not read")
    if meta.get("use_ocdbt"):
        store = OcdbtStore(path)
        get = store.get
    else:
        def get(key: str) -> bytes | None:
            name = os.path.join(path, *key.split("/"))
            if not os.path.isfile(name):
                return None
            with open(name, "rb") as fh:
                return fh.read()
    tree = {}
    for name in _leaf_names(meta, where):
        leaf = os.path.join(path, name)
        raw = get(f"{name}/.zarray")
        if raw is None:
            raise ValueError(f"{leaf}: no .zarray")
        tree[name] = _array(json.loads(raw), lambda k: get(f"{name}/{k}"),
                            leaf)
    return tree


def _zarray(a: np.ndarray) -> dict:
    return {"chunks": [max(s, 1) for s in a.shape], "compressor": None,
            "dimension_separator": ".", "dtype": a.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(a.shape), "zarr_format": 2}


def write_tree(path: str, tree: dict[str, np.ndarray]) -> None:
    """Write ``tree`` (name -> array) as an Orbax checkpoint at ``path``,
    replacing what is there, through a temporary sibling and a rename."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    start = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{start}-{os.getpid()}"
    os.makedirs(tmp)
    try:
        meta = {}
        for name, value in tree.items():
            a = np.asarray(value)
            leaf = os.path.join(tmp, name)
            os.makedirs(leaf)
            with open(os.path.join(leaf, ".zarray"), "w") as f:
                json.dump(_zarray(a), f, sort_keys=True,
                          separators=(",", ":"))
            if a.size:
                key = ".".join("0" for _ in a.shape) or "0"
                with open(os.path.join(leaf, key), "wb") as f:
                    f.write(a.tobytes())
            meta[str((name,))] = {
                "key_metadata": [{"key": name, "key_type": DICT_KEY}],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"tree_metadata": meta, "use_ocdbt": False,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": start,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    old = None
    if os.path.lexists(path):
        old = f"{path}.orbax-checkpoint-old-{start}-{os.getpid()}"
        os.rename(path, old)
    os.rename(tmp, path)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
