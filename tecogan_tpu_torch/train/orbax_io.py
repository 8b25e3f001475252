"""The JAX package's orbax checkpoints, read and written without JAX,
orbax, tensorstore or a zstd library (counterpart of
``tecogan_tpu/train/checkpoint.py:38-67``).

A step directory that ``save_checkpoint`` writes there holds
``_CHECKPOINT_METADATA`` and ``default/``. ``default/_METADATA`` (JSON)
maps each leaf's key tuple to its shape, and says where the arrays are:

- ``use_ocdbt: true`` (orbax's default): one OCDBT key-value store in
  ``default/`` (:class:`OcdbtReader`), whose keys are
  ``<param>/.zarray`` and ``<param>/<chunk>``;
- ``use_ocdbt: false``: one directory a leaf, ``default/<param>/.zarray``
  and ``default/<param>/<chunk>``.

``<param>`` is the key tuple joined with dots (``gen_opt.0.mu.conv_tran1.kernel``);
each leaf is a zarr v2 array (:func:`read_zarr_v2`), its chunks zstd
frames (``utils/zstd.py``) or raw.

The OCDBT format (tensorstore's "optionally-cooperative distributed
B+tree"): a manifest and B-tree nodes, each framed as a big-endian magic
(``0cdb3a2a`` manifest, ``0cdb20de`` node), its length (u64 LE), a version
varint (0), a compression varint (0 none, 1 zstd), the body and a CRC-32C
(LE) of everything before it. The manifest's body holds the store's
config and its versions; the newest version names the root node. A node
holds a table of data files (paths prefix-compressed, each with a base
path that its references inherit), then prefix-compressed keys with
either child references (interior nodes) or values (leaves), a value
inline or as (data file, offset, length). A numbered manifest
(``manifest.<n>``, ``manifest_kind`` 1) is refused with
:class:`OrbaxFormatError`: orbax writes the single kind.

:func:`read_jax_checkpoint` returns the tree as nested dicts (and lists
for sequences), numpy arrays at the leaves (``torch.bfloat16`` tensors for
bfloat16), ``None`` where the JAX state had ``None``.
:func:`write_jax_checkpoint` writes the ``use_ocdbt: false`` layout with
uncompressed chunks (``compressor: null``), which the JAX package's
``restore_checkpoint`` and ``latest_step`` read. It writes
``_CHECKPOINT_METADATA``, ``default/_METADATA`` and
``default/array_metadatas/process_0``; orbax's ``default/_sharding`` names
the saving process's devices and is left out, since a restore needs none
of it (a template's or the default sharding applies).
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import time
from itertools import product
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tecogan_tpu_torch.utils import zstd
from tecogan_tpu_torch.utils.tb_events import crc32c

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")
_DTYPES = {"<f4": np.float32, "<f2": np.float16, "<i4": np.int32, "<i8": np.int64,
           "|b1": np.bool_, "bfloat16": np.uint16}
_KEY_DICT, _KEY_SEQUENCE = 2, 1


class OrbaxFormatError(ValueError):
    """A checkpoint file this reader refuses: corrupt, or a feature of the
    format that orbax does not write for the JAX package."""


class _Bytes:
    """A cursor over a decoded body: varints, bytes and little-endian ints."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of a framed manifest or node, CRC and length checked."""
    if len(data) < 18 or struct.unpack(">I", data[:4])[0] != magic:
        raise OrbaxFormatError(f"{what}: bad magic")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise OrbaxFormatError(f"{what}: length field disagrees with the file")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise OrbaxFormatError(f"{what}: CRC-32C mismatch")
    head = _Bytes(data[:-4], what)
    head.pos = 12
    if head.varint() != 0:
        raise OrbaxFormatError(f"{what}: unknown format version")
    compression = head.varint()
    body = data[head.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise OrbaxFormatError(f"{what}: unknown compression {compression}")
    return body


_FileId = Tuple[str, str]  # (base path, relative path) under the store's root


def _data_files(r: _Bytes, base: str) -> List[_FileId]:
    """A data file table; each entry's base path follows ``base``, the base
    path of the file the table was read from."""
    n = r.varint()
    shared = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OrbaxFormatError(f"{r.what}: bad data file path prefix")
        path = prev[:shared[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise OrbaxFormatError(f"{r.what}: bad data file base path")
        files.append((base + path[:base_len[i]].decode(), path[base_len[i]:].decode()))
        prev = path
    return files


def _keys(r: _Bytes, n: int, extra: int = 0) -> Tuple[List[bytes], List[int]]:
    """``n`` prefix-compressed keys; ``extra`` reads one more varint a key
    between the lengths and the key bytes (interior nodes' subtree common
    prefix lengths), returned second."""
    shared = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    more = r.varints(n) if extra else []
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise OrbaxFormatError(f"{r.what}: bad key prefix")
        prev = prev[:shared[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, more


class OcdbtReader:
    """The newest version of the OCDBT store at ``root``: :meth:`keys` and
    :meth:`read`. Every manifest and node is CRC-checked as it is read."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        if not os.path.isfile(path):
            numbered = [f for f in os.listdir(root) if f.startswith("manifest.")] \
                if os.path.isdir(root) else []
            raise OrbaxFormatError(
                f"{root}: no manifest.ocdbt" + (f" (numbered manifests {sorted(numbered)} "
                                                 "are not read)" if numbered else ""))
        with open(path, "rb") as f:
            r = _Bytes(_unframe(f.read(), _MANIFEST_MAGIC, path), path)
        r.take(16)  # the store's uuid
        if r.varint() != 0:
            raise OrbaxFormatError(f"{path}: a numbered manifest (manifest_kind 1) "
                                   "is not read")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version tree arity (log2)
        if r.varint() == 1:  # zstd, with its level
            r.take(4)
        files = _data_files(r, "")
        n = r.varint()
        if n == 0:
            raise OrbaxFormatError(f"{path}: the store has no version")
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self._values: Dict[bytes, Any] = {}
        if num_keys[newest]:
            self._walk(self._file(files, file_id[newest]), offset[newest], length[newest],
                       height[newest], b"")

    def _file(self, files: List[_FileId], i: int) -> _FileId:
        if i >= len(files):
            raise OrbaxFormatError(f"{self.root}: data file id {i} out of range")
        return files[i]

    def _read_file(self, fid: _FileId, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, fid[0] + fid[1])
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OrbaxFormatError(f"{path}: {length} bytes at {offset} run past the file")
        return data

    def _walk(self, fid: _FileId, offset: int, length: int, height: int, prefix: bytes):
        what = f"{fid[0] + fid[1]}@{offset}"
        r = _Bytes(_unframe(self._read_file(fid, offset, length), _NODE_MAGIC, what), what)
        if r.byte() != height:
            raise OrbaxFormatError(f"{what}: node height disagrees with its parent")
        files = _data_files(r, fid[0])
        n = r.varint()
        if height == 0:
            keys, _ = _keys(r, n)
            lengths = r.varints(n)
            kinds = r.varints(n)
            indirect = [i for i in range(n) if kinds[i] == 1]
            if any(k > 1 for k in kinds):
                raise OrbaxFormatError(f"{what}: unknown value kind")
            ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
            refs = dict(zip(indirect, zip(ids, offsets)))
            for i, key in enumerate(keys):
                if i in refs:
                    i_file, i_off = refs[i]
                    value = (self._file(files, i_file), i_off, lengths[i])
                else:
                    value = r.take(lengths[i])
                self._values[prefix + key] = value
            return
        keys, common = _keys(r, n, extra=1)
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        for key, c, i_file, i_off, i_len in zip(keys, common, ids, offsets, lengths):
            self._walk(self._file(files, i_file), i_off, i_len, height - 1, prefix + key[:c])

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self._values)

    def read(self, key: str) -> bytes:
        value = self._values[key.encode()]
        return value if isinstance(value, bytes) else self._read_file(*value)

    def get(self, key: str) -> Optional[bytes]:
        """:meth:`read`, or None for a missing key."""
        return self.read(key) if key.encode() in self._values else None


def _directory_getter(root: str) -> Callable[[str], Optional[bytes]]:
    def get(key: str) -> Optional[bytes]:
        path = os.path.join(root, *key.split("/"))
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()
    return get


def _fill_value(value) -> Any:
    """A zarr v2 ``fill_value`` as a number (null -> 0)."""
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_zarr_v2(get: Callable[[str], Optional[bytes]], name: str):
    """The zarr v2 array ``name`` from a key-value getter (None for a
    missing key): a numpy array, or a ``torch.bfloat16`` tensor. Any chunk
    grid, ``dimension_separator`` ``.`` or ``/``, C order, compressor zstd
    or none; a missing chunk is ``fill_value`` (0 for null)."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format {meta.get('zarr_format')}, not 2")
    if meta["dtype"] not in _DTYPES:
        raise OrbaxFormatError(f"{name}: dtype {meta['dtype']!r} is not read")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']!r} is not read")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters {meta['filters']} are not read")
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor not in (None, "zstd"):
        raise OrbaxFormatError(f"{name}: compressor {compressor!r} is not read "
                               "(zstd or none)")
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill_value(meta.get("fill_value")), dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in product(*grid):
        data = get(f"{name}/{sep.join(map(str, idx)) if idx else '0'}")
        if data is None:
            continue
        if compressor == "zstd":
            data = zstd.decompress(data)
        if len(data) != dtype.itemsize * int(np.prod(chunks)):
            raise OrbaxFormatError(f"{name}: chunk {idx} holds {len(data)} bytes")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.copy()).view(torch.bfloat16)
    return out


def read_jax_checkpoint(step_dir: str) -> Dict[str, Any]:
    """The tree saved in ``step_dir`` (``<ckpt_dir>/<step>``) by the JAX
    package's ``save_checkpoint`` or by :func:`write_jax_checkpoint`."""
    root = os.path.join(step_dir, "default")
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{root}: zarr v3 leaves (use_zarr3) are not read")
    get = OcdbtReader(root).get if meta.get("use_ocdbt") else _directory_getter(root)
    tree: Dict[str, Any] = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if value["value_type"] == "None":
            leaf = None
        else:
            leaf = read_zarr_v2(get, ".".join(k["key"] for k in keys))
        node: Any = tree
        for k, nxt in zip(keys, keys[1:]):
            child = {} if nxt["key_type"] == _KEY_DICT else []
            node = _child(node, k, child)
        _set(node, keys[-1], leaf)
    return tree


def _child(node, key, default):
    if isinstance(node, list):
        i = int(key["key"])
        node.extend([None] * (i + 1 - len(node)))
        if node[i] is None:
            node[i] = default
        return node[i]
    return node.setdefault(key["key"], default)


def _set(node, key, leaf):
    if isinstance(node, list):
        i = int(key["key"])
        node.extend([None] * (i + 1 - len(node)))
        node[i] = leaf
    else:
        node[key["key"]] = leaf


def jax_steps(ckpt_dir: str) -> List[int]:
    """The steps under ``ckpt_dir`` in the JAX package's layout."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and is_jax_step(os.path.join(ckpt_dir, d)))


def is_jax_step(step_dir: str) -> bool:
    return os.path.isfile(os.path.join(step_dir, "default", "_METADATA"))


def _flatten(tree, path=()) -> List[Tuple[Tuple[Tuple[str, int], ...], Any]]:
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, path + ((str(k), _KEY_DICT),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, path + ((str(i), _KEY_SEQUENCE),))]
    return [(path, tree)]


def _leaf_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a C-order numpy array and its zarr dtype."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.contiguous().view(torch.uint16).numpy(), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf, order="C")  # ascontiguousarray would make a scalar 1-d
    for name, dtype in _DTYPES.items():
        if name != "bfloat16" and arr.dtype == dtype:
            return arr, name
    raise TypeError(f"no zarr dtype for {arr.dtype}")


def write_jax_checkpoint(ckpt_dir: str, step: int, tree: Dict[str, Any],
                         keep: int = 50) -> str:
    """Write ``tree`` (nested dicts and lists or tuples of arrays, tensors
    and None) as step ``step`` of ``ckpt_dir`` in the JAX package's
    layout (``use_ocdbt: false``, uncompressed chunks); keep the newest
    ``keep`` of its steps, as ``CheckpointManagerOptions(max_to_keep=keep)``.
    Written to a temporary directory and renamed into place; raises
    FileExistsError if the step is there."""
    final = os.path.join(ckpt_dir, str(step))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint {final} exists")
    start = time.time_ns()
    tmp = f"{final}.tmp{os.getpid()}"
    root = os.path.join(tmp, "default")
    os.makedirs(os.path.join(root, "array_metadatas"), exist_ok=True)
    tree_meta: Dict[str, Any] = {}
    arrays = []
    for path, leaf in _flatten(tree):
        key_meta = [{"key": k, "key_type": t} for k, t in path]
        keys = tuple(k for k, _ in path)
        if leaf is None:
            tree_meta[repr(keys)] = {"key_metadata": key_meta, "value_metadata": {
                "value_type": "None", "skip_deserialize": True}}
            continue
        arr, dtype = _leaf_array(leaf)
        shape = list(arr.shape)
        tree_meta[repr(keys)] = {"key_metadata": key_meta, "value_metadata": {
            "value_type": "jax.Array", "skip_deserialize": False, "write_shape": shape}}
        name = ".".join(keys)
        leaf_dir = os.path.join(root, name)
        os.makedirs(leaf_dir)
        zarray = {"chunks": shape, "compressor": None, "dimension_separator": ".",
                  "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
                  "shape": shape, "zarr_format": 2}
        with open(os.path.join(leaf_dir, ".zarray"), "w") as f:
            json.dump(zarray, f, separators=(",", ":"))
        with open(os.path.join(leaf_dir, ".".join(["0"] * arr.ndim) or "0"), "wb") as f:
            f.write(arr.tobytes())
        arrays.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                          "chunk_shape": shape, "ext_metadata": None}})
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(root, "array_metadatas", "process_0"), "w") as f:
        json.dump({"array_metadatas": arrays}, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": {"default": _HANDLER}, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": start,
                   "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)
    os.replace(tmp, final)
    for old in jax_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return final
