"""Inference engine: weights in the engine dtype, generation and paged serving.

Counterpart of ``deepspeed_tpu/inference/engine.py`` for the inference
main paths: ``init_inference(TransformerLM(cfg), dtype=..., paged_kv={...})``,
the weights (``set_params`` / ``load_jax_params``, the JAX tree as numpy),
``forward`` / ``engine(batch)`` (the model's logits, or its loss when the
batch carries labels), ``generate`` (the dense KV-cached loop: greedy,
sampling, beam search), ``profile_model_time`` / ``model_times``, and
``serve`` / ``serve_stats``
over a ``PagedServer`` (ragged, with multi-step windows under
``paged_kv.multi_step``, or bucketed with ``paged_kv.ragged=False``) built
as the JAX ``_build_paged_server`` builds it for the ported options.
The port's ``TransformerLM`` is the converted family (JAX's
``_ds_config`` path), so ``generate`` always takes the KV-cached loop. The
engine runs on ``cuda`` unless the caller passes another device; without
a card it raises.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, load_jax_params
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig, DtypeEnum, unported_switches
from deepspeed_tpu_torch.inference.scheduler import PagedServer
from deepspeed_tpu_torch.models.transformer import TransformerLM, _split_batch
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
            raise NotImplementedError("dtype int8 (weight quantization) is not ported yet (ROADMAP S8)")
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
        # the counterpart of JAX's PRNGKey(0): sampled generate calls draw
        # from (and advance) this generator
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        self.model_profile_enabled = False
        self._model_times = []
        if not any(p.is_meta for p in model.parameters()):
            # weights already made (e.g. init_weights): move them once
            with torch.no_grad():
                for path, leaf in flatten_tree(model.param_tree()).items():
                    model.set_leaf(path, leaf.to(device=self.device, dtype=self.dtype))
        log_dist(f"InferenceEngine: dtype={self._config.dtype.value} device={self.device}", ranks=[0])

    # --- weights --------------------------------------------------------
    def set_params(self, params) -> None:
        """Install the JAX parameter tree (numpy arrays, nested or under
        flat paths) on the engine's device in the engine dtype."""
        load_jax_params(self.module, params, device=self.device, dtype=self.dtype)
        self._paged_server = None

    load_jax_params = set_params

    def _weights_ready(self) -> bool:
        return not any(p.is_meta for p in self.module.parameters())

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
        with torch.no_grad():  # (tokens, None) is the unlabelled batch: apply returns the logits
            return self.module.apply(self.module.param_tree(), (tokens, labels), train=False)

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
        params = self.module.param_tree()
        if num_beams > 1:
            if temperature or top_k or top_p < 1.0:
                raise ValueError(
                    "beam search is deterministic; temperature/top_k/top_p "
                    "cannot be combined with num_beams > 1"
                )
            return beam_generate(
                self._ds_config, params, input_ids, max_new_tokens, num_beams=num_beams,
                eos_token_id=eos_token_id, pad_token_id=pad_token_id, length_penalty=length_penalty,
            )
        return generate(
            self._ds_config, params, input_ids, max_new_tokens, eos_token_id=eos_token_id,
            temperature=temperature, generator=self._generator, top_k=top_k, top_p=top_p,
            pad_token_id=pad_token_id,
        )

    # the public generate adopts _generate_impl's signature and doc
    generate = functools.wraps(_generate_impl)(generate)

    # --- paged serving --------------------------------------------------
    def _build_paged_server(self) -> PagedServer:
        if not self._weights_ready():
            raise RuntimeError("serve() before weights are set: call set_params / load_jax_params")
        pcfg = self._config.paged_kv
        if not pcfg.enabled:
            raise ValueError("paged serving is disabled (inference config paged_kv.enabled)")
        return PagedServer(
            self._ds_config,
            self.module.param_tree(),
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
        )

    def serve(self, prompts, max_new_tokens=32, eos_token_id=None):
        """Continuous-batching greedy generation over the paged KV pool:
        requests are admitted and evicted every step; prompts prefill in
        chunks riding the same step as running decoders, each step one call
        of the ragged step (or, with ``paged_kv.ragged=False``, one call per
        chunk and one bucketed decode round per step; with
        ``paged_kv.multi_step`` a stable running set takes windows of
        ``horizon`` decode rounds in one call). Takes a list of 1-D
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
