"""ZeRO-Infinity parameter offload: layer-streamed training and inference.

Counterpart of ``deepspeed_tpu/runtime/zero/param_offload.py``
(``LayerParamStore``, ``ParamStreamEngine``): the path of
``offload_param.device=cpu|nvme`` (ZeRO stage 3), and of ZeRO-Inference
(``init_inference(zero={"stage": 3, "offload_param": {...}})``).

* The model's stacked decoder layers live off the card: compute-dtype
  tensors in host memory (``device=cpu``, pinned on a card) or on local
  disk through the aio library (``device=nvme``), one file a layer, read
  into ``buffer_count`` pinned staging buffers.
* The forward runs the model's ``stream_fns()`` layer by layer: layer
  ``i+1``'s file read and card copy (a side stream) overlap layer ``i``'s
  compute. Each layer's input is stashed, on the host under
  ``activation_checkpointing.cpu_checkpointing``.
* The backward goes from the top layer down: layer ``i-1`` is prefetched,
  layer ``i`` is recomputed with grad from its stash (the same dropout
  seed, so the same masks) and back-propagated, and its gradient goes to
  the host (a pinned buffer, while layer ``i-1`` computes) and is summed
  into an fp32 accumulator there. At dp > 1 each layer's gradient is
  summed over the data group first (the update divides by dp).
* The step never touches the card's optimizer: the fp32 master and the
  Adam moments stay in host memory and update through the native host Adam
  (``csrc/host/cpu_adam.cpp``); the new compute-dtype layers are written
  back to the store and the resident parameters copied to the card.

The card holds the resident (non-layer) parameters, two layers, the stash
(unless it is on the host), and one layer's transient compute; the head's
logits dominate at large vocabularies.
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.adam.cpu_adam_native import NativeCPUAdam
from deepspeed_tpu_torch.utils.logging import log_dist


def _pinned(shape, dtype, pin: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=pin)


class LayerParamStore:
    """Per-layer compute-dtype leaves in host memory or on disk.

    ``layers_host`` is one ``name -> CPU tensor`` dict a layer (names in
    tree order). Disk mode packs a layer's leaves into one buffer written to
    ``<dir>/layer_<i>.bin``, with ``buffer_count`` pinned staging buffers and
    one aio handle a buffer, so the read of layer ``i+1`` overlaps the
    card's compute of layer ``i``."""

    def __init__(self, layers_host: List[Dict[str, torch.Tensor]], device: str, target: torch.device,
                 nvme_dir: Optional[str] = None, buffer_count: int = 2):
        self.n_layers = len(layers_host)
        self.device = device
        self.target = torch.device(target)
        self._cuda = self.target.type == "cuda"
        first = layers_host[0]
        self._names = list(first)
        self._shapes = [tuple(t.shape) for t in first.values()]
        self._dtypes = [t.dtype for t in first.values()]
        self._sizes = [int(np.prod(s)) for s in self._shapes]
        self._nbytes = [s * torch.empty((), dtype=d).element_size() for s, d in zip(self._sizes, self._dtypes)]
        self._offsets = np.cumsum([0] + self._nbytes).tolist()
        self.layer_nbytes = self._offsets[-1]
        self._stream = torch.cuda.Stream(self.target) if self._cuda else None
        self.h2d_bytes = 0
        self.read_bytes = 0
        self._timed: List[tuple] = []  # (start, end) events of the layer copies not yet read
        self._h2d_ms = 0.0

        if device == "nvme":
            from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

            self._dir = nvme_dir or os.path.join(tempfile.gettempdir(), "ds_tpu_param_swap")
            os.makedirs(self._dir, exist_ok=True)
            n_buf = max(2, buffer_count)
            self._read_handles = [AsyncIOHandle() for _ in range(n_buf)]
            self._write_handle = AsyncIOHandle()
            self._staging = [_pinned(self.layer_nbytes, torch.uint8, self._cuda) for _ in range(n_buf)]
            self._staged_layer = [-1] * n_buf  # the layer each buffer holds
            self._pending = [False] * n_buf  # a read in flight
            self._copied = [None] * n_buf  # the event after which a buffer's card copy has read it
            self._write_bufs: List[np.ndarray] = []
            for i, tree in enumerate(layers_host):
                self._write_handle.sync_pwrite(self._pack(tree), self._file(i))
            self._dram = None
        else:
            self._dram = [{k: _pinned(t.shape, t.dtype, self._cuda).copy_(t) for k, t in tree.items()}
                          for tree in layers_host]

    def _file(self, i: int) -> str:
        return os.path.join(self._dir, f"layer_{i}.bin")

    def _pack(self, tree: Dict[str, torch.Tensor]) -> np.ndarray:
        buf = np.empty(self.layer_nbytes, np.uint8)
        for t, off, nb in zip(tree.values(), self._offsets, self._nbytes):
            buf[off:off + nb] = t.detach().cpu().contiguous().view(torch.uint8).reshape(-1).numpy()
        return buf

    def _unpack(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: buf[off:off + nb].view(dt).reshape(shape)
                for k, off, nb, dt, shape in zip(self._names, self._offsets, self._nbytes, self._dtypes, self._shapes)}

    def _buf_slot(self, i: int) -> int:
        return i % len(self._staging)

    def start_fetch(self, i: int) -> None:
        """Begin reading layer ``i`` from disk into its staging buffer."""
        if self._dram is not None or not (0 <= i < self.n_layers):
            return
        slot = self._buf_slot(i)
        if self._staged_layer[slot] == i:
            return
        if self._pending[slot]:
            self._read_handles[slot].wait()
            self._pending[slot] = False
        if self._copied[slot] is not None:  # the buffer's last card copy must have read it
            self._copied[slot].synchronize()
            self._copied[slot] = None
        self._read_handles[slot].async_pread(self._staging[slot].numpy(), self._file(i))
        self.read_bytes += self.layer_nbytes
        self._staged_layer[slot] = i
        self._pending[slot] = True

    def host_layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s host tensors (a disk read waited on; on disk the
        views are of a staging buffer a later fetch reuses)."""
        if self._dram is not None:
            return self._dram[i]
        slot = self._buf_slot(i)
        if self._staged_layer[slot] != i:
            self.start_fetch(i)
        if self._pending[slot]:
            self._read_handles[slot].wait()
            self._pending[slot] = False
        return self._unpack(self._staging[slot])

    def to_device(self, i: int):
        """Layer ``i`` on the card: ``(tensors, ready)``, copied on the side
        stream; the compute stream waits on ``ready`` (``wait``)."""
        host = self.host_layer(i)
        self.h2d_bytes += self.layer_nbytes
        if not self._cuda:
            return {k: t.clone() for k, t in host.items()}, None
        with torch.cuda.stream(self._stream):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            dev = {k: t.to(self.target, non_blocking=True) for k, t in host.items()}
            ready = torch.cuda.Event(enable_timing=True)
            ready.record()
        self._timed.append((start, ready))
        if self._dram is None:
            self._copied[self._buf_slot(i)] = ready
        return dev, ready

    def h2d_ms(self) -> float:
        """Card time of every layer copy so far (CUDA events; 0 on the CPU):
        with ``h2d_bytes`` the stream's copy rate."""
        for start, end in self._timed:
            end.synchronize()
            self._h2d_ms += start.elapsed_time(end)
        self._timed.clear()
        return self._h2d_ms

    def wait(self, dev: Dict[str, torch.Tensor], ready) -> None:
        """Make the compute stream wait for a layer's copy, and hand it the
        tensors (freed only after the compute stream's use of them)."""
        if ready is not None:
            compute = torch.cuda.current_stream(self.target)
            compute.wait_event(ready)
            for t in dev.values():
                t.record_stream(compute)

    def update_layer(self, i: int, new_tree: Dict[str, torch.Tensor]) -> None:
        """Write back an updated layer (asynchronously on disk; ``flush``)."""
        if self._dram is not None:
            for k, t in new_tree.items():
                self._dram[i][k].copy_(t)
            return
        buf = self._pack(new_tree)
        self._write_bufs.append(buf)  # alive until flush
        self._write_handle.async_pwrite(buf, self._file(i))
        slot = self._buf_slot(i)
        if self._staged_layer[slot] == i:
            if self._pending[slot]:
                self._read_handles[slot].wait()
                self._pending[slot] = False
            self._staged_layer[slot] = -1  # the staged copy is stale now

    def flush(self) -> None:
        if self._dram is None:
            self._write_handle.wait()
            self._write_bufs.clear()


class _HostLeafState:
    """fp32 master and Adam moments of a group of leaves, flat. The moments
    are made at the first optimizer step, so inference never pays them."""

    __slots__ = ("master", "exp_avg", "exp_avg_sq")

    def __init__(self, flat_master: np.ndarray):
        self.master = flat_master
        self.exp_avg: Optional[np.ndarray] = None
        self.exp_avg_sq: Optional[np.ndarray] = None

    def ensure_moments(self) -> None:
        if self.exp_avg is None:
            self.exp_avg = np.zeros_like(self.master)
            self.exp_avg_sq = np.zeros_like(self.master)


class ParamStreamEngine:
    """Forward, backward and step over a layer store (module docstring).

    ``params`` is the whole tree as flat ``path -> array`` (numpy or CPU
    tensors, any float dtype), stacked ``layers/...`` leaves included."""

    def __init__(self, module, params: Dict[str, Any], zero_config, optimizer_params: Dict[str, Any],
                 compute_dtype: torch.dtype, device, fp16: bool = False, act_offload: bool = False,
                 attn_impl: Optional[str] = None, dp: int = 1, dp_rank: int = 0):
        if not hasattr(module, "stream_fns"):
            raise ValueError("offload_param needs a layer-streamable model: the module must expose stream_fns(); "
                             f"got {type(module).__name__}")
        self.module = module
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.fp16 = fp16
        self.act_offload = act_offload
        self.attn_impl = attn_impl
        self.dp, self.dp_rank = dp, dp_rank
        off = zero_config.offload_param
        self.embed_fwd, self.layer_fwd, self.head_loss = module.stream_fns()

        flat = {k: _cpu32(v) for k, v in params.items()}
        layer_paths = sorted(k for k in flat if k.startswith("layers/"))
        self._layer_names = [k[len("layers/"):] for k in layer_paths]
        self._resident_names = sorted(k for k in flat if not k.startswith("layers/"))
        self.n_layers = int(flat[layer_paths[0]].shape[0])
        self._layer_shapes = [tuple(flat[k].shape[1:]) for k in layer_paths]
        self._layer_sizes = [int(np.prod(s)) for s in self._layer_shapes]
        self._resident_shapes = [tuple(flat[k].shape) for k in self._resident_names]
        pin = self._cuda

        def host_flat(parts) -> np.ndarray:
            n = sum(p.numel() for p in parts)
            out = _pinned(n, torch.float32, pin)
            if n:
                torch.cat([p.reshape(-1) for p in parts], out=out)
            return out.numpy()

        self._layer_state = [_HostLeafState(host_flat([flat[k][i] for k in layer_paths])) for i in range(self.n_layers)]
        self._resident_state = _HostLeafState(host_flat([flat[k] for k in self._resident_names]))
        self.resident = {k: flat[k].to(device=self.device, dtype=compute_dtype) for k in self._resident_names}
        layers_host = [{name: flat[p][i].to(compute_dtype) for name, p in zip(self._layer_names, layer_paths)}
                       for i in range(self.n_layers)]
        del flat
        self.store = LayerParamStore(
            layers_host, device=str(getattr(off.device, "value", off.device)), target=self.device,
            nvme_dir=os.path.join(str(off.nvme_path), "ds_tpu_param_swap") if getattr(off, "nvme_path", None) else None,
            buffer_count=int(getattr(off, "buffer_count", 2) or 2))
        del layers_host

        # the host Adam is built at the first step: inference needs neither its build nor the moments
        self._optimizer_params = dict(optimizer_params)
        self._adam: Optional[NativeCPUAdam] = None
        self.step_count = 0
        self._grad_acc = [np.zeros_like(s.master) for s in self._layer_state]
        self._grad_acc_res = np.zeros_like(self._resident_state.master)
        self._micro_in_window = 0
        self._acts: List[torch.Tensor] = []
        self._act_host: List[torch.Tensor] = []  # pinned stash buffers, made once
        self._grad_stage = [_pinned(sum(self._layer_sizes), torch.float32, pin) for _ in range(2)]
        self._stash = None
        n_host = sum(s.master.nbytes * 3 for s in self._layer_state)
        log_dist(f"ParamStreamEngine: {self.n_layers} streamed layers, {self.store.layer_nbytes / 1024**2:.1f} MB/layer "
                 f"on {self.store.device}, {n_host / 1024**2:.1f} MB host optimizer state", ranks=[0])

    @property
    def adam(self) -> NativeCPUAdam:
        if self._adam is None:
            p = self._optimizer_params
            self._adam = NativeCPUAdam(betas=tuple(p.get("betas", (0.9, 0.999))), eps=p.get("eps", 1e-8),
                                       weight_decay=p.get("weight_decay", 0.0), adamw_mode=p.get("adam_w_mode", True))
        return self._adam

    # --- the layer stream ---------------------------------------------------
    def _positions(self, tokens):
        B, T = tokens.shape
        return torch.arange(T, dtype=torch.int32, device=tokens.device)[None].expand(B, T)

    def _resident_tree(self, resident: Dict[str, torch.Tensor]) -> Dict:
        from deepspeed_tpu_torch.checkpoint.jax_params import unflatten_tree

        return unflatten_tree(resident)

    def _stream_layers(self, h, positions, seed, train: bool, stash: bool):
        """Prefetch layer ``i+1`` (disk → staging and staging → card) while
        layer ``i`` computes."""
        store = self.store
        store.start_fetch(0)
        nxt = store.to_device(0) if self.n_layers else None
        for i in range(self.n_layers):
            store.start_fetch(i + 1)
            (dev, ready), nxt = nxt, None
            store.wait(dev, ready)
            if stash:
                self._stash_act(i, h)
            h_out = self.layer_fwd(dev, h, positions, None if seed is None else seed + i, train=train,
                                   attn_impl=self.attn_impl)
            if i + 1 < self.n_layers:
                nxt = store.to_device(i + 1)  # overlaps layer i's compute
            h = h_out
            del dev
        return h

    @torch.no_grad()
    def eval_forward(self, tokens, labels=None):
        """Deterministic forward (no dropout, no stash, no loss scale): the
        logits with ``labels=None``, else the loss."""
        res = self._resident_tree(self.resident)
        h = self.embed_fwd(res, tokens)
        h = self._stream_layers(h, self._positions(tokens), None, train=False, stash=False)
        return self.head_loss(res, h, labels)

    def forward(self, tokens, labels, seed: int, weight=None):
        """The training forward; returns this rank's loss with the head's
        graph (``weight`` scales what ``backward`` propagates: the rank's
        share of the global batch times dp)."""
        positions = self._positions(tokens)
        res = self._resident_tree(self.resident)
        self._acts = []
        with torch.no_grad():
            h = self.embed_fwd(res, tokens)
            h = self._stream_layers(h, positions, seed, train=True, stash=True)
        h_last = h.detach().requires_grad_(True)
        leaves = {k: t.detach().requires_grad_(True) for k, t in self.resident.items()}
        with torch.enable_grad():
            loss = self.head_loss(self._resident_tree(leaves), h_last, labels)
        self._stash = (tokens, positions, seed, h_last, leaves, loss, weight)
        return loss

    def _stash_act(self, i: int, h) -> None:
        if not self.act_offload:
            self._acts.append(h)
            return
        if len(self._act_host) <= i or self._act_host[i].shape != h.shape or self._act_host[i].dtype != h.dtype:
            buf = _pinned(h.shape, h.dtype, self._cuda)
            if len(self._act_host) <= i:
                self._act_host.append(buf)
            else:
                self._act_host[i] = buf
        self._act_host[i].copy_(h, non_blocking=True)  # on the compute stream: ordered before the backward's copy back
        self._acts.append(self._act_host[i])

    def _fetch_act(self, i: int):
        h = self._acts[i]
        return h.to(self.device, non_blocking=True) if self.act_offload else h

    def _reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        out = [g.float() for g in grads]
        if self.dp > 1:
            comm.all_reduce_coalesced(out)
        return out

    def _to_host(self, grads: List[torch.Tensor], slot: int):
        """Enqueue one layer's fp32 gradients into pinned staging; returns
        the event after which the host may read them."""
        buf, off = self._grad_stage[slot], 0
        for g in grads:
            n = g.numel()
            buf[off:off + n].copy_(g.reshape(-1), non_blocking=True)
            off += n
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _accumulate(self, acc: np.ndarray, slot: int, ev) -> None:
        if ev is not None:
            ev.synchronize()  # the host never reads a gradient before its copy has landed
        acc += self._grad_stage[slot].numpy()[:acc.size]

    def backward(self, scale: float) -> None:
        """Stream the backward; accumulate fp32 gradients on the host."""
        tokens, positions, seed, h_last, leaves, loss, weight = self._stash
        res_names = list(leaves)
        seed_loss = loss.float() * scale
        if weight is not None:
            seed_loss = seed_loss * weight
        g = torch.autograd.grad(seed_loss, [h_last] + [leaves[k] for k in res_names], allow_unused=True)
        g_h = g[0]
        res_acc = np.zeros_like(self._grad_acc_res)
        _accumulate_res(res_acc, self._reduce(_dense(g[1:], leaves, res_names)))
        store = self.store
        store.start_fetch(self.n_layers - 1)
        nxt = store.to_device(self.n_layers - 1) if self.n_layers else None
        pending = None
        for i in range(self.n_layers - 1, -1, -1):
            store.start_fetch(i - 1)
            (dev, ready), nxt = nxt, None
            store.wait(dev, ready)
            h_in = self._fetch_act(i).detach().requires_grad_(True)
            params = {k: t.requires_grad_(True) for k, t in dev.items()}
            with torch.enable_grad():
                out = self.layer_fwd(params, h_in, positions, None if seed is None else seed + i, train=True,
                                     attn_impl=self.attn_impl)
                grads = torch.autograd.grad(out, [h_in] + [params[k] for k in self.store._names], g_h)
            if i - 1 >= 0:
                nxt = store.to_device(i - 1)
            g_h = grads[0]
            ev = self._to_host(self._reduce(list(grads[1:])), i % 2)
            if pending is not None:  # the host sums layer i+1 while the card runs layer i
                self._accumulate(*pending)
            pending = (self._grad_acc[i], i % 2, ev)
            del dev, params, out, grads
        if pending is not None:
            self._accumulate(*pending)
        res = {k: t.detach().requires_grad_(True) for k, t in self.resident.items()}
        with torch.enable_grad():
            h0 = self.embed_fwd(self._resident_tree(res), tokens)
            ge = torch.autograd.grad(h0, [res[k] for k in res_names], g_h, allow_unused=True)
        _accumulate_res(res_acc, self._reduce(_dense(ge, res, res_names)))
        self._grad_acc_res += res_acc
        self._micro_in_window += 1
        self._acts = []
        self._stash = None

    def step(self, lr: float, scale: float, clip: float):
        """The host optimizer over every layer and the resident parameters
        (JAX ``ParamStreamEngine.step``'s arithmetic but for the squared
        norm's sum; the gradients were summed over dp, so the unscale
        divides by it too). Returns
        ``(grad_norm, overflow)``; an fp16 overflow skips the update."""
        inv = 1.0 / (scale * max(self._micro_in_window, 1) * self.dp)
        sq = 0.0
        finite = True
        for acc in self._grad_acc + [self._grad_acc_res]:
            a = acc * inv
            # the fp32 squares summed pairwise in float64; JAX's np.dot sums 38.6 M fp32 products of
            # GPT-2's embedding in fp32 (5e-5 relative off the card engine's norm, through the clip into
            # every update)
            s = float(np.sum(np.square(a), dtype=np.float64))
            if not math.isfinite(s):
                finite = False
                break
            sq += s
        overflow = self.fp16 and not finite
        grad_norm = math.sqrt(sq) if finite else float("nan")
        if not overflow:
            coef = inv * (min(1.0, clip / (grad_norm + 1e-6)) if clip > 0 else 1.0)
            self.step_count += 1
            for i in range(self.n_layers):
                st = self._layer_state[i]
                st.ensure_moments()
                g = self._grad_acc[i] * coef
                self.adam.step(st.master, g, st.exp_avg, st.exp_avg_sq, step=self.step_count, lr=lr)
                self.store.update_layer(i, self._layer_tree(st.master, self.compute_dtype))
            if self._resident_state.master.size:
                st = self._resident_state
                st.ensure_moments()
                g = self._grad_acc_res * coef
                self.adam.step(st.master, g, st.exp_avg, st.exp_avg_sq, step=self.step_count, lr=lr)
                self._refresh_resident()
            self.store.flush()
        for acc in self._grad_acc:
            acc[:] = 0.0
        self._grad_acc_res[:] = 0.0
        self._micro_in_window = 0
        return grad_norm, overflow

    def _layer_tree(self, flat: np.ndarray, dtype) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        src = torch.from_numpy(flat)
        for name, shape, size in zip(self._layer_names, self._layer_shapes, self._layer_sizes):
            out[name] = src[off:off + size].reshape(shape).to(dtype)
            off += size
        return out

    def _resident_flat(self, flat: np.ndarray, dtype) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        src = torch.from_numpy(flat)
        for name, shape in zip(self._resident_names, self._resident_shapes):
            size = int(np.prod(shape))
            out[name] = src[off:off + size].reshape(shape).to(dtype)
            off += size
        return out

    @torch.no_grad()
    def _refresh_resident(self) -> None:
        for k, t in self._resident_flat(self._resident_state.master, self.compute_dtype).items():
            self.resident[k].copy_(t)

    # --- introspection and checkpoints ------------------------------------------
    def gathered_params(self) -> Dict[str, torch.Tensor]:
        """The whole compute-dtype tree, flat paths, as CPU tensors."""
        out = {k: t.detach().cpu() for k, t in self.resident.items()}
        per = [{k: t.clone() for k, t in self.store.host_layer(i).items()} for i in range(self.n_layers)]
        for name in self._layer_names:
            out[f"layers/{name}"] = torch.stack([p[name] for p in per])
        return out

    def master_params(self) -> Dict[str, torch.Tensor]:
        """The whole fp32 master, flat paths, as CPU tensors."""
        out = {k: t.clone() for k, t in self._resident_flat(self._resident_state.master, torch.float32).items()}
        per = [self._layer_tree(st.master, torch.float32) for st in self._layer_state]
        for name in self._layer_names:
            out[f"layers/{name}"] = torch.stack([p[name] for p in per])
        return out

    def num_parameters(self) -> int:
        return sum(st.master.size for st in self._layer_state) + self._resident_state.master.size

    def _leaf_slices(self, name: str):
        """``(host state, start, stop, shape)`` of leaf ``name`` in the flat
        host state: one a layer for a stacked leaf, one for a resident leaf."""
        if name.startswith("layers/"):
            j = self._layer_names.index(name[len("layers/"):])
            a = sum(self._layer_sizes[:j])
            return [(st, a, a + self._layer_sizes[j], self._layer_shapes[j]) for st in self._layer_state]
        j = self._resident_names.index(name)
        a = sum(int(np.prod(s)) for s in self._resident_shapes[:j])
        shape = self._resident_shapes[j]
        return [(self._resident_state, a, a + int(np.prod(shape)), shape)]

    def leaf_state(self, name: str, field: str) -> Optional[np.ndarray]:
        """One leaf's whole fp32 ``master``, ``exp_avg`` or ``exp_avg_sq``
        (the utils/tensor_fragment surface); None for an unknown field."""
        if field not in ("master", "exp_avg", "exp_avg_sq"):
            return None
        parts = []
        for st, a, b, shape in self._leaf_slices(name):
            if field != "master":
                st.ensure_moments()
            parts.append(getattr(st, field)[a:b].reshape(shape).copy())
        return np.stack(parts) if name.startswith("layers/") else parts[0]

    def set_leaf_state(self, name: str, field: str, value: np.ndarray) -> bool:
        """Overwrite one leaf's whole fp32 field; a new master refreshes the
        streamed store and the resident parameters."""
        if field not in ("master", "exp_avg", "exp_avg_sq"):
            return False
        value = np.asarray(value, np.float32)
        stacked = name.startswith("layers/")
        for i, (st, a, b, _) in enumerate(self._leaf_slices(name)):
            if field != "master":
                st.ensure_moments()
            getattr(st, field)[a:b] = (value[i] if stacked else value).reshape(-1)
        if field == "master":
            self.materialize_from_master()
        return True

    def debug_grads(self):
        """The host fp32 gradient accumulators as the JAX tree (JAX
        ``param_offload.py:573``, the ``safe_get_full_grad`` surface): the
        raw scaled sum of this accumulation window's microbatches; None
        when the window is empty (right after ``step()``)."""
        if self._micro_in_window == 0:
            return None
        from deepspeed_tpu_torch.checkpoint.jax_params import tensors_to_jax_tree

        out = self._resident_flat(self._grad_acc_res, torch.float32)
        per = [self._layer_tree(acc, torch.float32) for acc in self._grad_acc]
        for name in self._layer_names:
            out[f"layers/{name}"] = torch.stack([p[name] for p in per])
        return tensors_to_jax_tree(out)

    @staticmethod
    def _leaf_state_dict(st: _HostLeafState) -> Dict[str, torch.Tensor]:
        st.ensure_moments()
        return {k: torch.from_numpy(getattr(st, k).copy()) for k in ("master", "exp_avg", "exp_avg_sq")}

    def state_dict(self) -> Dict[str, Any]:
        """JAX's ``optimizer["param_stream"]`` record: ``{"step", "layers":
        [{master, exp_avg, exp_avg_sq}], "resident": {...}}`` (flat fp32)."""
        return {"step": self.step_count, "layers": [self._leaf_state_dict(st) for st in self._layer_state],
                "resident": self._leaf_state_dict(self._resident_state)}

    def load_master_state(self, state: Dict[str, Any]) -> None:
        """Module-only load: the checkpoint's fp32 masters with fresh
        moments and step count."""
        for st, rec in zip(self._layer_state, state["layers"]):
            st.master[:] = _np32(rec["master"])
            st.exp_avg = st.exp_avg_sq = None
        self._resident_state.master[:] = _np32(state["resident"]["master"])
        self._resident_state.exp_avg = self._resident_state.exp_avg_sq = None
        self.step_count = 0
        self.materialize_from_master()

    @staticmethod
    def _load_leaf_state(st: _HostLeafState, rec: Dict[str, Any]) -> None:
        st.master[:] = _np32(rec["master"])
        st.exp_avg = np.array(_np32(rec["exp_avg"]), dtype=np.float32)
        st.exp_avg_sq = np.array(_np32(rec["exp_avg_sq"]), dtype=np.float32)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step_count = int(state["step"])
        for st, rec in zip(self._layer_state, state["layers"]):
            self._load_leaf_state(st, rec)
        self._load_leaf_state(self._resident_state, state["resident"])
        self.materialize_from_master()

    def set_master(self, flat: Dict[str, Any]) -> None:
        """Adopt a whole tree (flat paths) as the fp32 master and refresh
        the store and the resident parameters; the moments are kept."""
        for i, st in enumerate(self._layer_state):
            st.master[:] = np.concatenate([_np32(flat[f"layers/{n}"])[i].ravel() for n in self._layer_names])
        if self._resident_state.master.size:
            self._resident_state.master[:] = np.concatenate([_np32(flat[k]).ravel() for k in self._resident_names])
        self.materialize_from_master()

    def materialize_from_master(self) -> None:
        """The compute-dtype store and resident parameters from the master."""
        for i, st in enumerate(self._layer_state):
            self.store.update_layer(i, self._layer_tree(st.master, self.compute_dtype))
        if self._resident_state.master.size:
            self._refresh_resident()
        self.store.flush()


def _cpu32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy().ravel()
    return np.asarray(x, dtype=np.float32).ravel()


def _dense(grads, leaves: Dict[str, torch.Tensor], names: List[str]) -> List[torch.Tensor]:
    """Unused resident leaves (``allow_unused``) as zero gradients."""
    return [torch.zeros_like(leaves[k]) if g is None else g for g, k in zip(grads, names)]


def _accumulate_res(acc: np.ndarray, grads: List[torch.Tensor]) -> None:
    """acc += the flattened fp32 gradients of the resident leaves."""
    off = 0
    for g in grads:
        a = g.detach().cpu().numpy().ravel()
        acc[off:off + a.size] += a
        off += a.size
