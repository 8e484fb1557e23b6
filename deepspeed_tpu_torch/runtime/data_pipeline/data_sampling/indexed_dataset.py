"""Megatron-style binary indexed datasets, mmap flavor.

BIT-COMPATIBLE with the reference's on-disk format
(``deepspeed/runtime/data_pipeline/data_sampling/indexed_dataset.py:369``
``MMapIndexedDataset``): corpora tokenized by Megatron-LM / the reference's
data tooling load directly, and datasets built here load there.

Layout: ``<prefix>.bin`` holds the raw token stream; ``<prefix>.idx`` is

    b'MMIDIDX\\x00\\x00' | <Q version=1> | <B dtype code> |
    <Q n_sequences> | <Q n_docs> |
    sizes  int32[n_sequences]   (elements per sequence)
    pointers int64[n_sequences] (byte offset of each sequence in .bin)
    doc_idx int64[n_docs]       (sequence index where each document starts)

The port's own copy of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/indexed_dataset.py``
(the port imports nothing of the JAX package): the same names, the
same numbers, the same bytes on disk.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

_HDR_MAGIC = b"MMIDIDX\x00\x00"

dtypes = {
    1: np.uint8,
    2: np.int8,
    3: np.int16,
    4: np.int32,
    5: np.int64,
    6: np.float64,
    7: np.double,
    8: np.uint16,
    9: np.uint32,
    10: np.uint64,
}


def code(dtype) -> int:
    for c, dt in dtypes.items():
        if dt == dtype:
            return c
    raise ValueError(f"unsupported dtype {dtype}")


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDataset:
    """Random-access reader over the mmap'd .bin/.idx pair."""

    class Index:
        def __init__(self, path: str):
            with open(path, "rb") as stream:
                magic = stream.read(9)
                assert magic == _HDR_MAGIC, (
                    f"{path} is not an MMIDIDX index (got {magic!r})"
                )
                (version,) = struct.unpack("<Q", stream.read(8))
                assert version == 1, f"unsupported index version {version}"
                (dtype_code,) = struct.unpack("<B", stream.read(1))
                self.dtype = dtypes[dtype_code]
                (self._len,) = struct.unpack("<Q", stream.read(8))
                (self._doc_count,) = struct.unpack("<Q", stream.read(8))
                offset = stream.tell()
            buf = memoryview(np.memmap(path, mode="r", order="C"))
            self.sizes = np.frombuffer(buf, dtype=np.int32, count=self._len, offset=offset)
            self.pointers = np.frombuffer(
                buf, dtype=np.int64, count=self._len, offset=offset + self.sizes.nbytes
            )
            self.doc_idx = np.frombuffer(
                buf,
                dtype=np.int64,
                count=self._doc_count,
                offset=offset + self.sizes.nbytes + self.pointers.nbytes,
            )

        def __len__(self) -> int:
            return self._len

    def __init__(self, prefix: str):
        self._prefix = prefix
        self._index = self.Index(index_file_path(prefix))
        self._bin = np.memmap(data_file_path(prefix), mode="r", order="C")

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        size = int(self._index.sizes[idx])
        ptr = int(self._index.pointers[idx])
        dtype = self._index.dtype
        return np.frombuffer(self._bin, dtype=dtype, count=size, offset=ptr)

    def get(self, idx: int, offset: int = 0, length: Optional[int] = None) -> np.ndarray:
        """Partial sequence read (reference ``get``)."""
        seq = self[idx]
        stop = None if length is None else offset + length
        return seq[offset:stop]

    @property
    def sizes(self) -> np.ndarray:
        return self._index.sizes

    @property
    def doc_idx(self) -> np.ndarray:
        return self._index.doc_idx

    @property
    def dtype(self):
        return self._index.dtype

    @staticmethod
    def exists(prefix: str) -> bool:
        return os.path.exists(index_file_path(prefix)) and os.path.exists(
            data_file_path(prefix)
        )


class MMapIndexedDatasetBuilder:
    """Streaming writer producing the reference's exact file pair."""

    def __init__(self, out_file: str, dtype=np.int32):
        self._data_file = open(out_file, "wb")
        self._dtype = dtype
        self._sizes: List[int] = []
        self._doc_idx: List[int] = [0]

    def add_item(self, tokens: Sequence[int]) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        self._data_file.write(arr.tobytes(order="C"))
        self._sizes.append(arr.size)

    def end_document(self) -> None:
        self._doc_idx.append(len(self._sizes))

    def merge_file_(self, other_prefix: str) -> None:
        """Append another dataset's sequences (reference merge for parallel
        builders)."""
        other = MMapIndexedDataset(other_prefix)
        doc_offset = len(self._sizes)
        for i in range(len(other)):
            self.add_item(other[i])
        for d in other.doc_idx[1:]:
            self._doc_idx.append(int(d) + doc_offset)

    def finalize(self, index_file: str) -> None:
        self._data_file.close()
        with open(index_file, "wb") as f:
            f.write(_HDR_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", code(self._dtype)))
            f.write(struct.pack("<Q", len(self._sizes)))
            f.write(struct.pack("<Q", len(self._doc_idx)))
            sizes32 = np.asarray(self._sizes, dtype=np.int32)
            f.write(sizes32.tobytes(order="C"))
            itemsize = np.dtype(self._dtype).itemsize
            pointers = np.zeros(len(self._sizes), dtype=np.int64)
            if len(self._sizes) > 1:
                pointers[1:] = np.cumsum(sizes32[:-1].astype(np.int64) * itemsize)
            f.write(pointers.tobytes(order="C"))
            f.write(np.asarray(self._doc_idx, dtype=np.int64).tobytes(order="C"))


def make_builder(out_file: str, impl: str = "mmap", dtype=np.int32) -> MMapIndexedDatasetBuilder:
    if impl != "mmap":
        raise NotImplementedError(f"dataset impl {impl!r}; only 'mmap' is supported")
    return MMapIndexedDatasetBuilder(out_file, dtype=dtype)


def make_dataset(prefix: str, impl: str = "mmap") -> MMapIndexedDataset:
    if impl != "mmap":
        raise NotImplementedError(f"dataset impl {impl!r}; only 'mmap' is supported")
    return MMapIndexedDataset(prefix)
