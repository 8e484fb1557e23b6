"""Inference engine: weights in the engine dtype, generation and paged serving.

Counterpart of ``deepspeed_tpu/inference/engine.py`` for the inference
main paths: ``init_inference(TransformerLM(cfg), dtype=..., paged_kv={...})``,
the weights (``set_params`` / ``load_jax_params``, the JAX tree as numpy),
``forward`` / ``engine(batch)`` (the model's logits, or its loss when the
batch carries labels), ``generate`` (the dense KV-cached loop: greedy,
sampling, beam search), ``profile_model_time`` / ``model_times``, and
``serve`` / ``serve_stats``
over a ``PagedServer`` (ragged, with multi-step windows under
``paged_kv.multi_step``, or bucketed with ``paged_kv.ragged=False``; with
speculative decoding under ``spec_decode``, the crash-recovery journal
under ``journal``, int8 serving weights under
``paged_kv.sharded.weight_quant_bits=8``, tensor-parallel under
``paged_kv.sharded.tp_degree`` (or ``tensor_parallel.tp_size``) and, under
``traffic``, the multi-tenant SLA front ``MultiTenantServer``) built as the
JAX ``_build_paged_server`` builds it for the ported options. With
``quant.enabled`` every floating leaf of rank >= 2 of the installed tree is
fake-quantized by groups (``ops/quantizer.fake_quantize``), as JAX's
``set_params`` does, so ``forward``, ``generate`` and ``serve`` all see the
round-tripped weights.
The port's ``TransformerLM`` is the converted family (JAX's
``_ds_config`` path), so ``generate`` always takes the KV-cached loop. The
engine runs on ``cuda`` unless the caller passes another device; without
a card it raises.

Tensor parallelism runs one rank per process over ``torch.distributed``
(``deepspeed_tpu_torch.comm``; every rank builds the same engine and makes
the same calls). With ``tensor_parallel.tp_size > 1`` each rank keeps only
its shard of the weights (``inference/tp.py``'s layout, sliced from the
whole tree at ``set_params``), and ``forward`` and ``generate`` run
sharded: ``forward`` returns the full logits on every rank, and every
``generate`` mode gives every rank the same tokens. The serving degree is
``paged_kv.sharded.tp_degree``, or ``tensor_parallel.tp_size`` when that
is 0 (JAX ``engine.py:666-683``). ``save_mp_checkpoint`` writes the
pre-sharded inference checkpoint (``inference/mp_checkpoint.py``; rank 0
writes every file from the gathered leaves), ``save_mp_checkpoint_path``
writes it at ``set_params``, and ``checkpoint=`` /
``load_checkpoint`` boot from one.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint.jax_params import _checked_flat, flatten_tree, load_jax_params, unflatten_tree
from deepspeed_tpu_torch.compression.int8 import quantize_params_int8
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig, DtypeEnum, unported_switches
from deepspeed_tpu_torch.inference.journal import RequestJournal
from deepspeed_tpu_torch.inference.mp_checkpoint import MANIFEST_NAME, is_mp_checkpoint, load_mp_checkpoint
from deepspeed_tpu_torch.inference.mp_checkpoint import save_mp_checkpoint as write_mp_checkpoint
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.inference.tp import TPServing, gather_tree, require_ranks
from deepspeed_tpu_torch.inference.traffic import MultiTenantServer
from deepspeed_tpu_torch.models.transformer import TransformerLM, _split_batch, param_shapes
from deepspeed_tpu_torch.module_inject.auto_tp import AutoTP
from deepspeed_tpu_torch.ops.quantizer import fake_quantize
from deepspeed_tpu_torch.profiling.tracer import MetricsRegistry
from deepspeed_tpu_torch.utils.logging import log_dist

_DTYPES = {DtypeEnum.fp32: torch.float32, DtypeEnum.fp16: torch.float16, DtypeEnum.bf16: torch.bfloat16}


class InferenceEngine:
    def __init__(self, model: TransformerLM, config: Optional[DeepSpeedInferenceConfig] = None, device=None):
        self._config = config or DeepSpeedInferenceConfig()
        unported = unported_switches(self._config)
        if unported:
            raise NotImplementedError("not ported to deepspeed_tpu_torch yet: " + "; ".join(unported))
        if self._config.dtype not in _DTYPES:
            # JAX's dtype int8 casts each weight with astype (no scales); the port's int8 paths are
            # paged_kv.sharded.weight_quant_bits=8 and quant.enabled
            raise NotImplementedError(
                "dtype int8 is not ported: JAX casts each weight to int8 without scales, which is not "
                "quantization; use paged_kv.sharded.weight_quant_bits=8 or quant.enabled "
                "(ROADMAP, Reference caveats)"
            )
        if not isinstance(model, TransformerLM):
            raise NotImplementedError(
                "deepspeed_tpu_torch serves its own TransformerLM; other modules are not ported yet"
            )
        if model.config.embed_norm or not model.config.prenorm:
            raise NotImplementedError("embed_norm / post-LN models are not on the paged serving path")
        self.device = resolve_device(device)
        self.dtype = _DTYPES[self._config.dtype]
        self.module = model
        self._ds_config = model.config
        self.metrics = MetricsRegistry()
        self._paged_server = None
        # the dense path's tensor-parallel group (JAX builds a model-axis mesh here, engine.py:44-53): each
        # rank then holds only its shard of the weights (self._tp_params)
        tp_size = int(self._config.tensor_parallel.tp_size or 1)
        require_ranks(self.serving_tp_degree())
        self._tp = TPServing(degree=tp_size, comm_chunks=1) if tp_size > 1 else None
        if self._tp is not None:
            self._tp.validate_cfg(model.config)
        self._tp_params = None
        # the counterpart of JAX's PRNGKey(0): sampled generate calls draw
        # from (and advance) this generator
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self.model_profile_enabled = False
        self._model_times = []
        if not any(p.is_meta for p in model.parameters()):
            # weights already made (e.g. init_weights): move them once (a tensor-parallel rank keeps its shard)
            if self._tp is not None:
                self._install_tp(flatten_tree(model.param_tree()))
            else:
                with torch.no_grad():
                    for path, leaf in flatten_tree(model.param_tree()).items():
                        model.set_leaf(path, leaf.to(device=self.device, dtype=self.dtype))
                self._quantize_weights()
        # a checkpoint handed to init_inference (JAX engine.py:117-136): a pre-sharded manifest or its dir
        if self._config.checkpoint is not None:
            self.load_checkpoint(self._config.checkpoint)
        log_dist(f"InferenceEngine: dtype={self._config.dtype.value} device={self.device} "
                 f"tp_size={tp_size}", ranks=[0])

    def serving_tp_degree(self) -> int:
        """The paged server's tensor-parallel degree: ``sharded.tp_degree``,
        or ``tensor_parallel.tp_size`` when that is 0 (FOLLOW mode), where
        the bucketed oracle (``ragged=False``) stays single-rank (JAX
        ``engine.py:666-683``)."""
        pcfg = self._config.paged_kv
        scfg = pcfg.sharded
        degree = int(scfg.tp_degree or self._config.tensor_parallel.tp_size or 1)
        if degree > 1 and not pcfg.ragged and scfg.tp_degree == 0:
            return 1
        return degree

    # --- weights --------------------------------------------------------
    def set_params(self, params) -> None:
        """Install the JAX parameter tree (numpy arrays, nested or under
        flat paths) on the engine's device in the engine dtype; a
        tensor-parallel rank keeps its shard. With
        ``save_mp_checkpoint_path`` the pre-sharded checkpoint is written
        at once (JAX ``engine.py:230-234``)."""
        if self._tp is not None:
            self._install_tp(params)
        else:
            load_jax_params(self.module, params, device=self.device, dtype=self.dtype)
            self._quantize_weights()
        self._paged_server = None
        if self._config.save_mp_checkpoint_path:
            self.save_mp_checkpoint(self._config.save_mp_checkpoint_path)

    load_jax_params = set_params

    @torch.no_grad()
    def _install_tp(self, params) -> None:
        """This rank's shard of the tree: each leaf cast to the engine
        dtype on the device and fake-quantized whole (``quant.enabled``),
        then sliced by the tensor-parallel layout. The module keeps no
        weights."""
        full = {}
        for path, leaf in _checked_flat(self.module.config, params).items():
            t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf, np.float32, order="C"))
            full[path] = self._fake_quantize(t.to(device=self.device, dtype=self.dtype))
        self._tp_params = self._tp.shard_params(self.module.config, unflatten_tree(full))
        for path, shape in param_shapes(self.module.config).items():
            self.module.set_leaf(path, torch.empty(shape, device="meta"))

    def _full_params(self):
        """The whole tree on this rank: the module's, or a tensor-parallel
        rank's shards gathered from the group (every rank must call it)."""
        if self._tp is not None:
            return gather_tree(self._tp, self._tp_params)
        return self.module.param_tree()

    @torch.no_grad()
    def _quantize_weights(self) -> None:
        """``quant.enabled``: after the cast to the engine dtype, each
        floating leaf of rank >= 2 of the JAX tree layout (norm scales and
        embeddings too) becomes its quantize-dequantize round trip, in
        ``size // group_size`` groups when that divides evenly, else one
        (JAX ``inference/engine.py:196-212``)."""
        if not self._config.quant.enabled:
            return
        for path, leaf in flatten_tree(self.module.param_tree()).items():
            self.module.set_leaf(path, self._fake_quantize(leaf))

    def _fake_quantize(self, leaf: torch.Tensor) -> torch.Tensor:
        """One leaf through ``quant.enabled``'s round trip (unchanged when
        the switch is off, or the leaf is not a floating matrix)."""
        qcfg = self._config.quant
        if not qcfg.enabled or leaf.ndim < 2 or not leaf.is_floating_point():
            return leaf
        gs = int(qcfg.group_size or 64)
        groups = leaf.numel() // gs if gs and leaf.numel() % gs == 0 else 1
        return fake_quantize(leaf, num_groups=groups, num_bits=int(qcfg.num_bits or 8))

    def _weights_ready(self) -> bool:
        if self._tp is not None:
            return self._tp_params is not None
        return not any(p.is_meta for p in self.module.parameters())

    # --- pre-sharded inference checkpoints ---------------------------------
    def _tp_rules(self, params):
        """The checkpoint's shard dims: the model's ``tp_partition_rules``
        when it has them, else the AutoTP walk (JAX ``engine.py:236-247``)."""
        rules = None
        if hasattr(self.module, "tp_partition_rules"):
            rules = self.module.tp_partition_rules(params)
        if rules is None:
            rules = AutoTP().partition_specs(params)
        return rules

    def save_mp_checkpoint(self, save_path: str, tag: str = "ds-inference") -> str:
        """Write the pre-sharded inference checkpoint and its manifest,
        split ``tensor_parallel.tp_size`` ways by the model's rules (JAX
        ``engine.py:249-273``); returns the manifest path. Under tensor
        parallelism every rank gathers the shards and rank 0 writes every
        file while the others wait at a barrier. Boot from it with
        ``init_inference(..., checkpoint=<manifest or its dir>)`` or
        ``load_checkpoint``."""
        if not self._weights_ready():
            raise RuntimeError("save_mp_checkpoint before weights are set")
        params = self._full_params()
        mpath = os.path.join(save_path, MANIFEST_NAME)
        if self._tp is None or self._tp.rank == 0:
            mpath = write_mp_checkpoint(params, self._tp_rules(params), save_path, tag=tag,
                                        tp_size=max(1, int(self._config.tensor_parallel.tp_size or 1)))
        if self._tp is not None:
            comm.barrier(self._tp.group)
        return mpath

    def load_checkpoint(self, path) -> None:
        """Install the weights of a pre-sharded inference checkpoint (the
        manifest or its directory; written by either package): the whole
        tree is loaded, then a tensor-parallel rank slices its shard (JAX
        ``engine.py:323-333``)."""
        if isinstance(path, str) and is_mp_checkpoint(path):
            params, _ = load_mp_checkpoint(path)
            self.set_params(params)
            return
        raise NotImplementedError(
            f"checkpoint={path!r}: only the pre-sharded inference checkpoint (a ds_inference_config.json "
            "manifest or its directory) is ported; engine checkpoint directories and SD-loader "
            "descriptors wait for the checkpoint engine (ROADMAP T3)"
        )

    # --- forward --------------------------------------------------------
    def profile_model_time(self, use_cuda_events: bool = True) -> None:  # noqa: ARG002
        """Record the wall time of each ``forward`` and ``generate`` call, the
        device drained before the clock stops (JAX ``engine.py:340``)."""
        self.model_profile_enabled = True

    def model_times(self):
        """Collected ``forward`` / ``generate`` latencies in seconds, cleared
        on read."""
        assert self.model_profile_enabled, "model profiling is not enabled"
        times = self._model_times
        self._model_times = []
        return times

    def forward(self, *inputs, **kwargs):
        """The model's forward in inference mode (JAX ``engine.py:354``):
        ``TransformerLM.apply(params, batch, train=False)``, the logits
        ``[B, T, V]``, or the scalar loss when the batch carries labels. The
        batch is one argument (a token array, ``(tokens, labels)`` or
        ``{"input_ids", "labels"}``), several positional arguments taken as
        a tuple, or keyword arguments taken as a dict, as JAX reads them.
        With ``profile_model_time()`` on, the wall time until one output
        element reaches the host is appended to ``model_times()``. Raises
        before weights are set: the port takes its weights only as the JAX
        tree (``set_params`` / ``load_jax_params``), where JAX would build
        them from its seed."""
        if not self.model_profile_enabled:
            return self._forward_impl(*inputs, **kwargs)
        t0 = time.perf_counter()
        out = self._forward_impl(*inputs, **kwargs)
        out.reshape(-1)[:1].cpu()  # drain: wait for one output element
        self._model_times.append(time.perf_counter() - t0)
        return out

    __call__ = forward

    def _forward_impl(self, *inputs, **kwargs):
        if not self._weights_ready():
            raise RuntimeError("forward() before weights are set: call set_params / load_jax_params")
        batch = inputs[0] if len(inputs) == 1 else (inputs if inputs else kwargs)
        tokens, labels = _split_batch(batch)
        tokens = torch.as_tensor(tokens, device=self.device)
        labels = None if labels is None else torch.as_tensor(labels, device=self.device)
        params = self._tp_params if self._tp is not None else self.module.param_tree()
        with torch.no_grad():  # (tokens, None) is the unlabelled batch: apply returns the logits
            return self.module.apply(params, (tokens, labels), train=False, tp=self._tp)

    # --- generation -----------------------------------------------------
    def generate(self, *args, **kwargs):
        """Latency-recording wrapper over ``_generate_impl`` (whose
        signature this function adopts via ``functools.wraps`` below)."""
        if not self.model_profile_enabled:
            return self._generate_impl(*args, **kwargs)
        t0 = time.perf_counter()
        out = self._generate_impl(*args, **kwargs)
        out[..., -1:].cpu()  # drain: wait for the last emitted token
        self._model_times.append(time.perf_counter() - t0)
        return out

    def _generate_impl(
        self,
        input_ids,
        max_new_tokens: int = 32,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        num_beams: int = 1,
        length_penalty: float = 1.0,
    ):
        """Token generation through the KV-cached loop: greedy by default;
        temperature / top-k / top-p sampling drawn from the engine's
        generator; ``num_beams > 1`` is beam search (deterministic, so it
        refuses the sampling controls). Returns ``[B, prompt + emitted]``
        int32 on the engine's device."""
        from deepspeed_tpu_torch.inference.decode import beam_generate, generate

        if not self._weights_ready():
            raise RuntimeError("generate() before weights are set: call set_params / load_jax_params")
        params = self._tp_params if self._tp is not None else self.module.param_tree()
        if num_beams > 1:
            if temperature or top_k or top_p < 1.0:
                raise ValueError(
                    "beam search is deterministic; temperature/top_k/top_p "
                    "cannot be combined with num_beams > 1"
                )
            return beam_generate(
                self._ds_config, params, input_ids, max_new_tokens, num_beams=num_beams,
                eos_token_id=eos_token_id, pad_token_id=pad_token_id, length_penalty=length_penalty, tp=self._tp,
            )
        return generate(
            self._ds_config, params, input_ids, max_new_tokens, eos_token_id=eos_token_id,
            temperature=temperature, generator=self._generator, top_k=top_k, top_p=top_p,
            pad_token_id=pad_token_id, tp=self._tp,
        )

    # the public generate adopts _generate_impl's signature and doc
    generate = functools.wraps(_generate_impl)(generate)

    # --- paged serving --------------------------------------------------
    def _build_paged_server(self):
        if not self._weights_ready():
            raise RuntimeError("serve() before weights are set: call set_params / load_jax_params")
        pcfg = self._config.paged_kv
        if not pcfg.enabled:
            raise ValueError("paged serving is disabled (inference config paged_kv.enabled)")
        scfg = pcfg.sharded
        tp_degree = self.serving_tp_degree()
        if not pcfg.ragged and scfg.tp_degree == 0 and int(self._config.tensor_parallel.tp_size or 1) > 1:
            log_dist(
                "paged_kv.ragged=False: bucketed serving stays single-rank "
                f"(tensor_parallel.tp_size={self._config.tensor_parallel.tp_size} keeps driving the "
                "dense generate path; enable ragged or set paged_kv.sharded.tp_degree to shard serving)",
                ranks=[0],
            )
        # tensor-parallel serving: every rank runs the same scheduler on its shard; the TP context slices
        # the whole tree (quantized first: per-output-channel scales stay global)
        tp_ctx = None
        if tp_degree > 1:
            tp_ctx = TPServing(degree=tp_degree, quantized_allreduce=scfg.quantized_allreduce,
                               comm_chunks=scfg.comm_chunks)
        # the crash-recovery journal: replay the directory before the new writer opens its segment,
        # then hand the replayed state to the fresh server, which resumes every journaled stream. Under
        # tensor parallelism every rank replays and rank 0 alone writes: the barriers keep every rank
        # from reading before rank 0's earlier writes are synced, or after its new segment opened
        journal, states, next_uid = None, None, 0
        jcfg = self._config.journal
        if jcfg.enabled:
            if not jcfg.dir:
                raise ValueError("inference.journal.enabled requires journal.dir")
            if tp_ctx is not None:
                comm.barrier(tp_ctx.group)
            states, next_uid = RequestJournal.replay(jcfg.dir)
            if tp_ctx is not None:
                comm.barrier(tp_ctx.group)
            if tp_ctx is None or tp_ctx.rank == 0:
                journal = RequestJournal(jcfg.dir, segment_bytes=jcfg.segment_bytes, fsync=jcfg.fsync)
        params = self._full_params()
        if scfg.weight_quant_bits == 8:
            # the server's tree only: forward and generate keep the engine's weights, as in JAX
            params = quantize_params_int8(params)
        server = PagedServer(
            self._ds_config,
            params,
            page_size=pcfg.page_size,
            num_pages=pcfg.num_pages,
            max_slots=pcfg.max_slots,
            slot_buckets=pcfg.slot_buckets or None,
            max_seq_len=pcfg.max_seq_len,
            prefill_chunk=pcfg.prefill_chunk,
            attn_impl=pcfg.attn_impl,
            dtype=self.dtype,
            device=self.device,
            prefix_cache=pcfg.prefix_cache,
            metrics=self.metrics,
            ragged=pcfg.ragged,
            multi_step=pcfg.multi_step,
            spec_decode=self._config.spec_decode,
            journal=journal,
            tp=tp_ctx,
        )
        if states:
            server.recover(states, next_uid)
        tcfg = self._config.traffic
        if tcfg.enabled:
            # weighted-deficit and priority admission, queue caps, per-tenant stats: the same surface
            server = MultiTenantServer(server, tenants=[t.model_dump() for t in tcfg.tenants])
        return server

    def serve(self, prompts, max_new_tokens=32, eos_token_id=None):
        """Continuous-batching greedy generation over the paged KV pool:
        requests are admitted and evicted every step; prompts prefill in
        chunks riding the same step as running decoders, each step one call
        of the ragged step (or, with ``paged_kv.ragged=False``, one call per
        chunk and one bucketed decode round per step; with
        ``paged_kv.multi_step`` a stable running set takes windows of
        ``horizon`` decode rounds in one call). With
        ``spec_decode.enable`` host-side n-gram drafts verify inside the
        same step, token-exact under greedy; with ``journal.enabled`` a
        server built on a journal that holds records recovers it first
        (its requests' results are then the server's, by uid). Takes a list of 1-D
        prompts and a scalar or per-request ``max_new_tokens``; returns one
        1-D array per request (prompt + generated) in submission order. The
        server and its page pool persist across calls."""
        if self._paged_server is None:
            self._paged_server = self._build_paged_server()
        return self._paged_server.serve(prompts, max_new_tokens=max_new_tokens, eos_token_id=eos_token_id)

    def serve_stats(self):
        """The live server's ``serve_stats()`` ({} before the first serve)."""
        if self._paged_server is None:
            return {}
        return self._paged_server.serve_stats()
