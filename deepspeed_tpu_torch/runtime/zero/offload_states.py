"""Host-offloaded optimizer state: the legacy ZeRO-Offload path.

Counterpart of ``deepspeed_tpu/runtime/zero/offload_states.py``
(``HostOffloadAdam``): ``offload_optimizer.device=cpu|nvme`` with
``pipeline_read`` and ``pipeline_write`` both off (the reference's stage-1/2
CPU offload with ``DeepSpeedCPUAdam``, ``stage_1_and_2.py:1101``, and the
stage-3 NVMe swapping of ``stage3.py:542``).

The card holds the compute-dtype parameters and the fp32 gradient
accumulator; the fp32 master and the Adam moments live on the host, one
record per (leaf, this rank's slice), updated by the native host Adam
(``csrc/host/cpu_adam.cpp``). Under ``device=nvme`` the moments swap to
``<nvme_path>/ds_tpu_swap`` between steps through the pipelined swapper,
the next leaf's read in flight while the current leaf updates.

The step (the engine computes the norm and the overflow flag on the card
first):

    card → host:  every leaf's gradient slice, enqueued at once into pinned
                  staging, one event a leaf
    host:         per leaf, once its event has fired: scale and clip, the
                  host Adam on the master, the cast to the parameter dtype
    host → card:  the new parameter slice
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam.cpu_adam_native import NativeCPUAdam
from deepspeed_tpu_torch.utils.logging import log_dist


class _LeafShard:
    """Host state of this rank's slice of one leaf (flat fp32)."""

    __slots__ = ("index", "master", "exp_avg", "exp_avg_sq", "param_id")

    def __init__(self, index, master: np.ndarray, param_id: str):
        self.index = index  # [(start, stop)] per dim of the whole leaf; None = whole dim
        self.master = master
        self.exp_avg = np.zeros_like(master)
        self.exp_avg_sq = np.zeros_like(master)
        self.param_id = param_id


class HostOffloadAdam:
    """Adam/AdamW whose state lives entirely off the card.

    ``master`` maps each leaf (in the engine's checkpoint order: JAX's tree
    order) to this rank's fp32 slice; ``index`` to where that slice sits in
    the whole leaf; ``param_dtypes`` to the dtype the new parameters take.
    """

    STATE_NAMES = ("exp_avg", "exp_avg_sq")

    def __init__(self, master: Dict[str, torch.Tensor], index: Dict[str, list], param_dtypes: Dict[str, torch.dtype],
                 offload_config, device, aio_param_dict: Optional[dict] = None, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, adamw_mode: bool = True, rank: int = 0):
        self.adam = NativeCPUAdam(betas=betas, eps=eps, weight_decay=weight_decay, adamw_mode=adamw_mode)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        pin = bool(getattr(offload_config, "pin_memory", False)) and self._cuda
        self.step_count = 0
        self.names = list(master)
        self._shapes = {k: tuple(t.shape) for k, t in master.items()}
        self._param_dtypes = dict(param_dtypes)
        self._shards: Dict[str, _LeafShard] = {}
        for li, (k, t) in enumerate(master.items()):
            host = torch.empty(t.numel(), dtype=torch.float32, pin_memory=pin)
            host.copy_(t.detach().reshape(-1))
            self._shards[k] = _LeafShard(index[k], host.numpy(), f"leaf{li}_d{rank}")
        # pinned staging, allocated once: each leaf's gradient (fp32) and its new parameters
        self._grad_host = {k: torch.empty(t.numel(), dtype=torch.float32, pin_memory=pin) for k, t in master.items()}
        self._param_host = {k: torch.empty(t.numel(), dtype=self._param_dtypes[k], pin_memory=pin)
                            for k, t in master.items()}

        # nvme: the moments swap to disk between steps (the master stays in memory: every step needs it)
        self.swapper = None
        if offload_config is not None and str(getattr(offload_config.device, "value", offload_config.device)) == "nvme":
            from deepspeed_tpu_torch.runtime.swap_tensor.aio_config import get_aio_config
            from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_optimizer_swapper import (
                PartitionedOptimizerSwapper,
            )

            nvme_path = str(offload_config.nvme_path or tempfile.gettempdir())
            largest = max((sh.master.size for sh in self._shards.values()), default=1)
            self.swapper = PartitionedOptimizerSwapper(
                swap_config=offload_config, aio_config=get_aio_config(aio_param_dict or {}),
                base_folder=os.path.join(nvme_path, "ds_tpu_swap"), largest_numel=largest, device_id=rank)
            for sh in self._shards.values():
                self.swapper.register_param(sh.param_id, sh.master.size, self.STATE_NAMES)
                self.swapper.swap_out_param(sh.param_id, {"exp_avg": sh.exp_avg, "exp_avg_sq": sh.exp_avg_sq})
                sh.exp_avg = None  # the moments live on disk now
                sh.exp_avg_sq = None
        n_bytes = sum(sh.master.nbytes for sh in self._shards.values())
        log_dist(f"HostOffloadAdam: {n_bytes * (3 if self.swapper is None else 1) / 1024**2:.1f} MB host state "
                 f"({'moments on nvme' if self.swapper else 'all in memory'})", ranks=[0])
        self._timing = {"adam_ms": 0.0, "swap_read_ms": 0.0, "swap_write_ms": 0.0}

    def step(self, grads: Dict[str, torch.Tensor], lr: float, inv_scale: float, clip_coef: float
             ) -> Dict[str, torch.Tensor]:
        """One update from ``grads`` (this rank's slice of each leaf, on the
        card, shaped like the master slice); returns the new parameter
        slices on the card in each leaf's parameter dtype."""
        import time

        self.step_count += 1
        self._timing = {"adam_ms": 0.0, "swap_read_ms": 0.0, "swap_write_ms": 0.0}
        landed = {}
        if self._cuda:  # every gradient enqueued host-ward before any is awaited
            for k in self.names:
                self._grad_host[k].copy_(grads[k].reshape(-1), non_blocking=True)
                landed[k] = torch.cuda.Event()
                landed[k].record()
        else:
            for k in self.names:
                self._grad_host[k].copy_(grads[k].reshape(-1))
        coef = inv_scale * clip_coef
        if self.swapper is not None and self.names:
            self.swapper.prefetch_param(self._shards[self.names[0]].param_id)
        out = {}
        for n, k in enumerate(self.names):
            sh = self._shards[k]
            if k in landed:
                landed[k].synchronize()  # the host Adam never reads a gradient before its copy has landed
            g = self._grad_host[k].numpy()
            if coef != 1.0:
                g = g * coef
            if self.swapper is not None:
                t0 = time.perf_counter()
                m, v = np.empty_like(sh.master), np.empty_like(sh.master)
                self.swapper.fetch_param(sh.param_id, {"exp_avg": m, "exp_avg_sq": v})
                if n + 1 < len(self.names):
                    self.swapper.prefetch_param(self._shards[self.names[n + 1]].param_id)
                self._timing["swap_read_ms"] += (time.perf_counter() - t0) * 1e3
            else:
                m, v = sh.exp_avg, sh.exp_avg_sq
            t0 = time.perf_counter()
            self.adam.step(sh.master, g, m, v, step=self.step_count, lr=lr)
            self._timing["adam_ms"] += (time.perf_counter() - t0) * 1e3
            if self.swapper is not None:
                t0 = time.perf_counter()
                self.swapper.writeback_param(sh.param_id, {"exp_avg": m, "exp_avg_sq": v})
                self._timing["swap_write_ms"] += (time.perf_counter() - t0) * 1e3
            staged = self._param_host[k]
            staged.copy_(torch.from_numpy(sh.master))  # the cast to the parameter dtype
            out[k] = staged.to(self.device, non_blocking=True).reshape(self._shapes[k])
        if self.swapper is not None:
            t0 = time.perf_counter()
            self.swapper.drain_writes()
            self._timing["swap_write_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def timing(self) -> Dict[str, float]:
        """The last step's host Adam and swap read/write wall (ms)."""
        return dict(self._timing)

    # --- checkpoint surface ---------------------------------------------------
    def _moments(self, sh: _LeafShard) -> Tuple[np.ndarray, np.ndarray]:
        if self.swapper is None:
            return sh.exp_avg, sh.exp_avg_sq
        m, v = np.empty_like(sh.master), np.empty_like(sh.master)
        self.swapper.fetch_param(sh.param_id, {"exp_avg": m, "exp_avg_sq": v})
        self.swapper.writeback_param(sh.param_id, {"exp_avg": m, "exp_avg_sq": v})
        return m, v

    def leaf_state(self, name: str) -> Dict[str, np.ndarray]:
        """Copies of one leaf's master and moments (flat, this rank's slice)."""
        sh = self._shards[name]
        m, v = self._moments(sh)
        out = {"master": sh.master.copy(), "exp_avg": m.copy(), "exp_avg_sq": v.copy()}
        if self.swapper is not None:
            self.swapper.drain_writes()
        return out

    def state_dict(self) -> Dict[str, Any]:
        """JAX's layout: ``{"step", "leaves": [[{"index", "master",
        "exp_avg", "exp_avg_sq"}, ...], ...]}``, one record list a leaf in
        tree order, one record a slice (flat fp32 tensors)."""
        leaves = []
        for k in self.names:
            rec = {f: torch.from_numpy(a) for f, a in self.leaf_state(k).items()}
            leaves.append([dict(index=list(self._shards[k].index), **rec)])
        return {"step": self.step_count, "leaves": leaves}

    def drain_writes(self) -> None:
        """The write fence (the streamed engine's API; the legacy path has
        no deferred writebacks outside ``step``)."""

    def load_state_dict(self, state: Dict[str, Any], leaf=None) -> None:
        """Adopt a checkpoint's records; ``leaf(name, key)`` returns this
        rank's flat slice of field ``key`` of leaf ``name`` (the engine
        reassembles the records, whatever slices they were saved in)."""
        if isinstance(state, dict) and state.get("format") == "streamed":
            raise ValueError(
                "this checkpoint's offloaded optimizer state was saved by the STREAMED ZeRO-Infinity engine "
                "(runtime/zero/host_offload.py); load it with offload_optimizer.pipeline_read/pipeline_write "
                "enabled, or pass load_optimizer_states=False to adopt the module weights only")
        self.step_count = int(state["step"])
        for k, sh in self._shards.items():
            sh.master[:] = leaf(k, "master")
            m, v = leaf(k, "exp_avg"), leaf(k, "exp_avg_sq")
            if self.swapper is not None:
                self.swapper.swap_out_param(sh.param_id, {"exp_avg": m, "exp_avg_sq": v})
            else:
                sh.exp_avg[:] = m
                sh.exp_avg_sq[:] = v

    def load_master_only(self, state: Dict[str, Any], leaf=None) -> None:
        """Restore just the fp32 master (module-only load)."""
        if isinstance(state, dict) and state.get("format") == "streamed":
            raise ValueError(
                "streamed-format (ZeRO-Infinity) offload checkpoint cannot restore into the legacy host-Adam "
                "engine; enable offload_optimizer.pipeline_read/pipeline_write to load it")
        for k, sh in self._shards.items():
            sh.master[:] = leaf(k, "master")

    def set_leaf_state(self, name: str, field: str, flat: np.ndarray) -> None:
        """Overwrite one field (``master``, ``exp_avg``, ``exp_avg_sq``) of
        this rank's slice of leaf ``name`` (through the swap files for the
        moments under ``nvme``)."""
        sh = self._shards[name]
        flat = np.asarray(flat, np.float32).reshape(-1)
        if field == "master":
            sh.master[:] = flat
        elif self.swapper is not None:
            m, v = np.empty_like(sh.master), np.empty_like(sh.master)
            self.swapper.fetch_param(sh.param_id, {"exp_avg": m, "exp_avg_sq": v})
            {"exp_avg": m, "exp_avg_sq": v}[field][:] = flat
            self.swapper.swap_out_param(sh.param_id, {"exp_avg": m, "exp_avg_sq": v})
            self.swapper.drain_writes()
        else:
            getattr(sh, field)[:] = flat

    def set_master_leaves(self, leaves: Dict[str, Any]) -> None:
        """Overwrite the host master (this rank's slices, by name)."""
        for k, sh in self._shards.items():
            x = leaves[k]
            x = x.detach().to("cpu", torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
            sh.master[:] = x.reshape(-1)

    def master_leaves(self) -> Dict[str, torch.Tensor]:
        """Copies of the fp32 master slices, shaped."""
        return {k: torch.from_numpy(sh.master.copy()).reshape(self._shapes[k]) for k, sh in self._shards.items()}


def assemble_records(records: List[Dict[str, Any]], key: str, shape) -> np.ndarray:
    """A whole leaf from its slice records (JAX ``zero_to_fp32``'s rule:
    each record's flat ``key`` written at its ``index``)."""
    full = np.zeros(shape, np.float32)
    for rec in records:
        sl = tuple(slice(a, b) for a, b in rec["index"])
        x = rec[key]
        x = x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
        full[sl] = x.reshape(full[sl].shape)
    return full
