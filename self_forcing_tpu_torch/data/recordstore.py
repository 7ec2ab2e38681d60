"""The record-shard store (port of ``self_forcing_tpu/data/recordstore.py``):
the ``SFRS0001`` shard format, byte for byte.

A shard is the magic ``SFRS0001``, the record count and the index offset
(two little-endian uint64), then the records, each 8-byte aligned, and
at the end the index: for each record its offset and size (uint64) and
its key's length (uint32) followed by the key.  :class:`RecordWriter`
writes shards; :class:`RecordReader` reads them through ``np.memmap``
and returns each record as a read-only view of the mapped file (an ODE
row is ~21 MB, a latent row ~4 MB, read once a step: the JAX package's
native reader is not needed for that).

The key conventions are the reference's LMDB ones: ``{name}_shape``
holds a space-separated shape string and ``{name}_{i}_data`` row i of
array ``name``.
"""
from __future__ import annotations

import struct
from typing import Iterable, Mapping

import numpy as np

_MAGIC = b"SFRS0001"


class RecordWriter:
    """Append-only shard writer; the index is written at close."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_MAGIC + struct.pack("<QQ", 0, 0))
        self._index: list[tuple[int, int, bytes]] = []

    def put(self, key: str | bytes, value: bytes | np.ndarray) -> None:
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, np.ndarray):
            value = value.tobytes()
        pos = self._f.tell()
        pad = (-pos) % 8
        if pad:
            self._f.write(b"\0" * pad)
            pos += pad
        self._f.write(value)
        self._index.append((pos, len(value), key))

    def close(self) -> None:
        if self._f.closed:
            return
        idx_off = self._f.tell()
        for off, size, key in self._index:
            self._f.write(struct.pack("<QQI", off, size, len(key)) + key)
        self._f.seek(8)
        self._f.write(struct.pack("<QQ", len(self._index), idx_off))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """A shard mapped read-only; :meth:`get` returns zero-copy views."""

    def __init__(self, path: str):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        head = bytes(self._mm[:24])
        if len(head) < 24 or head[:8] != _MAGIC:
            raise ValueError(f"{path}: not an SFRS0001 record shard")
        n, idx_off = struct.unpack("<QQ", head[8:24])
        buf = bytes(self._mm[idx_off:])
        self.index: dict[bytes, tuple[int, int]] = {}
        p = 0
        for _ in range(n):
            off, size, klen = struct.unpack_from("<QQI", buf, p)
            p += 20
            self.index[bytes(buf[p:p + klen])] = (off, size)
            p += klen

    def get(self, key: str | bytes) -> np.ndarray | None:
        """The record as a read-only uint8 view of the mapped file, or
        None."""
        if isinstance(key, str):
            key = key.encode()
        hit = self.index.get(key)
        if hit is None:
            return None
        off, size = hit
        return self._mm[off:off + size]

    def keys(self) -> list[bytes]:
        return list(self.index)

    def __len__(self) -> int:
        return len(self.index)

    def close(self) -> None:
        """Drop this reader's map (views already returned keep it)."""
        self._mm = None


def get_array_shape(reader: RecordReader, array_name: str) -> tuple:
    raw = reader.get(f"{array_name}_shape")
    if raw is None:
        raise KeyError(f"{reader.path}: no {array_name}_shape record")
    return tuple(int(x) for x in bytes(raw).decode().split())


def store_arrays(writer: RecordWriter, arrays_dict: Mapping[str, Iterable],
                 start_index: int = 0) -> None:
    """Store the rows of several arrays (a str row as UTF-8)."""
    for name, array in arrays_dict.items():
        for i, row in enumerate(array):
            data = row.encode() if isinstance(row, str) else \
                np.asarray(row).tobytes()
            writer.put(f"{name}_{start_index + i}_data", data)


def write_shape_header(writer: RecordWriter, array_name: str,
                       shape: tuple) -> None:
    writer.put(f"{array_name}_shape",
               " ".join(str(s) for s in shape).encode())


def retrieve_row(reader: RecordReader, array_name: str, dtype,
                 row_index: int, shape: tuple | None = None):
    """Row ``row_index`` of ``array_name``: a str for ``dtype=str``, else
    a numpy copy in ``dtype`` (reshaped to ``shape``)."""
    raw = reader.get(f"{array_name}_{row_index}_data")
    if raw is None:
        raise KeyError(f"{reader.path}: no {array_name}_{row_index}_data "
                       "record")
    if dtype is str:
        return bytes(raw).decode()
    arr = np.frombuffer(bytes(raw), dtype=dtype)
    return arr.reshape(shape) if shape else arr
