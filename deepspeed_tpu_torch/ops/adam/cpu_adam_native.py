"""Native vectorized Adam and Adagrad on host partitions.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam_native.py``: the Python
surface of ``csrc/host/cpu_adam.cpp`` and ``cpu_adagrad.cpp`` (the
reference's ``DeepSpeedCPUAdam``), built by ``ops/native.build_host``.
They update fp32 master partitions living in host memory in place, through
``ctypes`` pointers to numpy arrays. A pinned torch CPU tensor's
``t.numpy()`` is a numpy array of the same memory, so host state can be
both an operand here and the source or target of a ``non_blocking`` copy.
Used by the offload engines (``runtime/zero/offload_states.py``,
``param_offload.py``), so the card never holds optimizer moments under
``offload_optimizer.device=cpu|nvme`` or ``offload_param``.

A failed build raises (there is no numpy Adam in its place);
``native_adam_available`` is the probe that answers False instead.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.ops import native

_ids = itertools.count()


def _lib() -> ctypes.CDLL:
    lib = native.load_host("cpu_adam")
    lib.create_adam.argtypes = [
        ctypes.c_int,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int,
    ]
    lib.destroy_adam.argtypes = [ctypes.c_int]
    lib.adam_update.argtypes = [
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.adam_simd_width.restype = ctypes.c_int
    return lib


def native_adam_available() -> bool:
    """Whether the host Adam builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def simd_width() -> int:
    """The SIMD lane width compiled in: 16 (AVX-512), 8 (AVX2) or 1."""
    return _lib().adam_simd_width()


def _fptr(a: np.ndarray):
    assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeCPUAdam:
    """Host-side fused Adam over flat fp32 numpy partitions.

    The reference class API (`DeepSpeedCPUAdam`): construct with hyperparams,
    call :meth:`step` per partition with (params, grads, exp_avg, exp_avg_sq)
    — all updated in place on the host.
    """

    def __init__(
        self,
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        amsgrad: bool = False,
        adamw_mode: bool = True,
        fp32_optimizer_states: bool = True,  # noqa: ARG002 - parity
    ):
        if amsgrad:
            raise NotImplementedError("amsgrad is not supported (reference cpu_adam.py parity)")
        self.lib = _lib()
        self.opt_id = next(_ids)
        self.lr = lr
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        rc = self.lib.create_adam(
            self.opt_id, lr, betas[0], betas[1], eps, weight_decay, int(adamw_mode)
        )
        if rc != 0:
            raise RuntimeError("create_adam failed")

    def __del__(self):
        lib = getattr(self, "lib", None)
        if lib is not None:
            try:
                lib.destroy_adam(self.opt_id)
            except Exception:
                pass

    def step(
        self,
        params: np.ndarray,
        grads: np.ndarray,
        exp_avg: np.ndarray,
        exp_avg_sq: np.ndarray,
        step: Optional[int] = None,
        lr: Optional[float] = None,
        bias_correction: bool = True,
    ) -> None:
        """In-place fused update of one flat partition."""
        if step is None:
            self.step_count += 1
            step = self.step_count
        n = params.size
        assert grads.size == n and exp_avg.size == n and exp_avg_sq.size == n
        rc = self.lib.adam_update(
            self.opt_id,
            step,
            self.lr if lr is None else lr,
            self.betas[0],
            self.betas[1],
            self.eps,
            self.weight_decay,
            int(bias_correction),
            _fptr(params),
            _fptr(grads),
            _fptr(exp_avg),
            _fptr(exp_avg_sq),
            n,
        )
        if rc != 0:
            raise RuntimeError("adam_update failed (unknown optimizer id)")


class NativeCPUAdagrad:
    """Host-side Adagrad (csrc/adagrad/cpu_adagrad.cpp)."""

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        self.lib = native.load_host("cpu_adagrad")
        self.lib.create_adagrad.argtypes = [
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.c_float,
        ]
        self.lib.adagrad_update.argtypes = [
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        self.lib.destroy_adagrad.argtypes = [ctypes.c_int]
        self.opt_id = next(_ids)
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.lib.create_adagrad(self.opt_id, lr, eps, weight_decay)

    def __del__(self):
        lib = getattr(self, "lib", None)
        if lib is not None:
            try:
                lib.destroy_adagrad(self.opt_id)
            except Exception:
                pass

    def step(self, params: np.ndarray, grads: np.ndarray, accum: np.ndarray, lr: Optional[float] = None) -> None:
        rc = self.lib.adagrad_update(
            self.opt_id,
            self.lr if lr is None else lr,
            self.eps,
            self.weight_decay,
            _fptr(params),
            _fptr(grads),
            _fptr(accum),
            params.size,
        )
        if rc != 0:
            raise RuntimeError("adagrad_update failed")
