"""Async file I/O op (ZeRO-Infinity disk swapping).

Counterpart of ``deepspeed_tpu/ops/aio/__init__.py``: the Python surface of
the host library ``csrc/host/deepspeed_aio.cpp`` (built by
``ops/native.build_host``), the reference's ``AsyncIOBuilder`` op
(``op_builder/async_io.py``) and its ``aio_handle`` class
(``csrc/aio/py_lib/py_ds_aio.cpp``):

    handle = AsyncIOHandle(block_size=1MB, queue_depth=8,
                           single_submit=False, overlap_events=True,
                           thread_count=1)
    handle.async_pwrite(np_array, "/nvme/t.bin"); ...; handle.wait()

Buffers are numpy arrays, often the ``numpy()`` view of a pinned torch CPU
tensor (the staging the reference keeps in pinned CPU tensors); callers own
a buffer until the matching wait(). Files are opened without O_DIRECT:
every read and write goes through the page cache (``IO_MODE``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.ops import native

# how the library opens its files (csrc/host/deepspeed_aio.cpp, aio_async_pread / aio_async_pwrite)
IO_MODE = "buffered"

AIO_DEFAULT_DICT = {
    "block_size": 1048576,
    "queue_depth": 8,
    "thread_count": 1,
    "single_submit": False,
    "overlap_events": True,
}


class AsyncIOBuilder:
    """Availability probe matching the reference builder's surface."""

    NAME = "async_io"

    def is_compatible(self) -> bool:
        try:
            native.load_host("aio")
        except (RuntimeError, OSError):
            return False
        return True

    def load(self):
        return native.load_host("aio")


def _lib() -> ctypes.CDLL:
    lib = AsyncIOBuilder().load()
    lib.aio_handle_create.restype = ctypes.c_void_p
    lib.aio_handle_create.argtypes = [
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.aio_handle_destroy.argtypes = [ctypes.c_void_p]
    lib.aio_wait.argtypes = [ctypes.c_void_p]
    lib.aio_file_size.restype = ctypes.c_int64
    lib.aio_file_size.argtypes = [ctypes.c_char_p]
    for fn in (lib.aio_async_pread, lib.aio_sync_pread):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    for fn in (lib.aio_async_pwrite, lib.aio_sync_pwrite):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
    return lib


class AsyncIOHandle:
    """The reference's ``aio_handle`` (py_ds_aio.cpp:17-20)."""

    def __init__(
        self,
        block_size: int = AIO_DEFAULT_DICT["block_size"],
        queue_depth: int = AIO_DEFAULT_DICT["queue_depth"],
        single_submit: bool = AIO_DEFAULT_DICT["single_submit"],
        overlap_events: bool = AIO_DEFAULT_DICT["overlap_events"],
        thread_count: int = AIO_DEFAULT_DICT["thread_count"],
    ):
        self._lib = _lib()
        self._handle = self._lib.aio_handle_create(
            block_size, queue_depth, int(single_submit), int(overlap_events), thread_count
        )
        if not self._handle:
            raise RuntimeError("aio_handle_create failed")
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.single_submit = single_submit
        self.overlap_events = overlap_events
        self.thread_count = thread_count
        self._inflight = 0

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            try:
                self._lib.aio_wait(handle)
                self._lib.aio_handle_destroy(handle)
            except Exception:
                pass
            self._handle = None

    @staticmethod
    def _buf_ptr(arr: np.ndarray):
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("aio buffers must be C-contiguous")
        return arr.ctypes.data_as(ctypes.c_void_p)

    # --- async: caller must wait() before touching the buffer ------------
    def async_pread(self, buffer: np.ndarray, filename: str) -> int:
        rc = self._lib.aio_async_pread(
            self._handle, self._buf_ptr(buffer), filename.encode(), buffer.nbytes
        )
        if rc != 0:
            raise IOError(f"aio async_pread submit failed for {filename}")
        self._inflight += 1
        return 0

    def async_pwrite(self, buffer: np.ndarray, filename: str) -> int:
        rc = self._lib.aio_async_pwrite(
            self._handle, self._buf_ptr(buffer), filename.encode(), buffer.nbytes
        )
        if rc != 0:
            raise IOError(f"aio async_pwrite submit failed for {filename}")
        self._inflight += 1
        return 0

    def wait(self) -> int:
        """Block until all submitted ops finish; returns completed op count
        (raises on any I/O failure)."""
        errors = self._lib.aio_wait(self._handle)
        done = self._inflight
        self._inflight = 0
        if errors:
            raise IOError(f"aio: {errors} chunk operations failed")
        return done

    # --- sync convenience (reference sync_pread/sync_pwrite) -------------
    def sync_pread(self, buffer: np.ndarray, filename: str) -> int:
        rc = self._lib.aio_sync_pread(
            self._handle, self._buf_ptr(buffer), filename.encode(), buffer.nbytes
        )
        if rc != 0:
            raise IOError(f"aio sync_pread failed for {filename}")
        return buffer.nbytes

    def sync_pwrite(self, buffer: np.ndarray, filename: str) -> int:
        rc = self._lib.aio_sync_pwrite(
            self._handle, self._buf_ptr(buffer), filename.encode(), buffer.nbytes
        )
        if rc != 0:
            raise IOError(f"aio sync_pwrite failed for {filename}")
        return buffer.nbytes


def aio_read(buffer: np.ndarray, filename: str) -> int:
    """Module-level sync read (reference py_ds_aio.cpp:14 ``aio_read``)."""
    h = AsyncIOHandle()
    return h.sync_pread(buffer, filename)


def aio_write(buffer: np.ndarray, filename: str) -> int:
    h = AsyncIOHandle()
    return h.sync_pwrite(buffer, filename)


def file_size(filename: str) -> int:
    lib = _lib()
    return lib.aio_file_size(filename.encode())
