"""Training variants against the JAX package on the CPU: the remat API,
ALiBi and head_dim 80.

* the activation-checkpointing API: ``configure`` (its config equal to
  JAX's after the same calls), the policies (a name PyTorch cannot express
  raises), ``checkpoint`` / ``checkpoint_wrapper`` / ``CheckpointFunction``
  with the gradients of the plain call, the ``dots`` policy, CPU
  checkpointing;
* ALiBi training: the model's loss and gradients against ``jax.grad`` in
  the grouped-GQA and the equal-heads forms within 1e-5, and the engine
  trains; the KV-cached paths keep refusing it;
* the plain flash functions at head_dim 80 against JAX's Pallas flash in
  interpret mode, at the shapes of JAX's own tests (B=2, T=256, N=4,
  blocks of 128).
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import TransformerLM as JaxLM
from deepspeed_tpu.models import config as jax_model_config
from deepspeed_tpu.models.transformer import cross_entropy_loss as jax_cross_entropy
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu_torch.checkpoint.jax_params import flatten_tree, unflatten_tree
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ac

jax_fa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

GPT2 = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2, max_seq_len=128, dtype="float32",
            remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(model_kw):
    return unflatten_tree(init_params(TransformerConfig(**model_kw), 0))


def _batch(rows=2, seed=4):
    t = np.random.RandomState(seed).randint(0, GPT2["vocab_size"], (rows, 17)).astype(np.int32)
    return {"input_ids": t[:, :-1], "labels": t[:, 1:]}


# --- the remat API ----------------------------------------------------------------------------
def test_activation_checkpointing_api():
    from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jax_ac
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    ac.reset()
    assert not ac.is_configured()
    ac.configure(deepspeed_config=DeepSpeedConfig({"activation_checkpointing": {"partition_activations": True}}),
                 num_checkpoints=3)
    jax_ac.configure(deepspeed_config=JaxDeepSpeedConfig({"activation_checkpointing": {"partition_activations": True}}),
                     num_checkpoints=3)
    assert ac.is_configured() and ac.get_partition_activations() is True
    assert ac._config == jax_ac._config
    assert [ac.policy_from_name(n) for n in (None, "default", "dots", "dots_no_batch", "everything", "nothing")] == \
        ["nothing", "nothing", "dots", "dots_no_batch", "everything", "nothing"]
    with pytest.raises(ValueError, match="no PyTorch counterpart"):
        ac.policy_from_name("offload_dot_products_to_host")
    ac.model_parallel_cuda_manual_seed(1)
    rs = np.random.RandomState(0)
    w1, w2 = (torch.tensor(rs.randn(16, 16).astype(np.float32), requires_grad=True) for _ in range(2))
    x = torch.tensor(rs.randn(4, 16).astype(np.float32))
    calls = []

    def block(h):
        calls.append(1)
        return torch.tanh(h @ w1) @ w2

    def grads(run):
        w1.grad = w2.grad = None
        calls.clear()
        run().square().sum().backward()
        return w1.grad.clone(), w2.grad.clone(), len(calls)

    ref = grads(lambda: block(x))
    for run, n in ((lambda: ac.checkpoint(block, x), 2), (lambda: ac.checkpoint_wrapper(block)(x), 2),
                   (lambda: ac.CheckpointFunction.apply(block, x), 2), (lambda: ac.checkpoint(block, x, policy="dots"), 2),
                   (lambda: ac.checkpoint(block, x, policy="everything"), 1)):
        g1, g2, count = grads(run)
        assert count == n  # the forward reran in backward, or (everything) did not
        assert torch.equal(g1, ref[0]) and torch.equal(g2, ref[1])
    ac.configure(checkpoint_in_cpu=True)
    g1, g2, _ = grads(lambda: ac.checkpoint(block, x))
    assert torch.equal(g1, ref[0]) and torch.equal(g2, ref[1])
    ac.reset()
    jax_ac.reset()
    ac.configure(checkpoint_in_cpu=False, partition_activations=False, num_checkpoints=None)
    ac.reset()
    assert not ac.is_configured()


# --- ALiBi training -------------------------------------------------------------------------
ALIBI = {
    "equal heads": dict(GPT2, num_heads=4, position="alibi", flash_attention=True),
    "grouped GQA": dict(GPT2, num_heads=4, num_kv_heads=2, position="alibi", norm="rmsnorm", activation="swiglu",
                        use_bias=False, tie_embeddings=False),
}


@pytest.mark.parametrize("name", sorted(ALIBI))
def test_alibi_training_matches_jax(name):
    """The loss and every gradient within 1e-5 of ``jax.grad`` (the flash
    switch is on in the equal-heads form: ALiBi passes by the kernels, as
    in JAX); then the engine trains on it."""
    model_kw = ALIBI[name]
    tree = _tree(model_kw)
    batch = _batch()
    jm = JaxLM(jax_model_config.TransformerConfig(**model_kw))
    tokens, labels = jnp.asarray(batch["input_ids"]), jnp.asarray(batch["labels"])
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_cross_entropy(jm.apply(p, tokens, train=True), labels)))(tree)
    model = TransformerLM(TransformerConfig(**model_kw))
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in flatten_tree(tree).items()}
    before = fa.launches_fwd
    loss = model.apply(unflatten_tree(leaves), (torch.from_numpy(batch["input_ids"]).long(),
                                                torch.from_numpy(batch["labels"]).long()), train=True)
    loss.backward()
    assert fa.launches_fwd == before
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)
    for k, g in flatten_tree(jax.tree_util.tree_map(np.asarray, grads_ref)).items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, rtol=1e-5, atol=1e-6, err_msg=k)
    e, *_ = dst.initialize(model=TransformerLM(TransformerConfig(**model_kw)), model_parameters=tree, device="cpu",
                           config={"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
                                   "optimizer": {"type": "adam", "params": {"lr": 1e-3}}})
    losses = [e.train_batch(batch=batch) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_alibi_stays_refused_on_the_cached_paths():
    from deepspeed_tpu_torch.inference.decode import _check_cached_cfg

    with pytest.raises(NotImplementedError, match="alibi"):
        _check_cached_cfg(TransformerConfig(**ALIBI["equal heads"]))


# --- head_dim 80 --------------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_flash_at_head_dim_80_matches_pallas(causal):
    """K1-K3's plain functions at D = 80 against the Pallas kernels in
    interpret mode (O and LSE within 2e-5, gradients within 5e-4, JAX's own
    tolerances); the kernels take 80 (``HEAD_DIMS``)."""
    B, T, N, D, blk = 2, 256, 4, 80, 128
    scale = 1.0 / np.sqrt(D)
    rs = np.random.RandomState(8)
    q, k, v, do = (rs.randn(B, T, N, D).astype(np.float32) for _ in range(4))
    bn = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * N, T, D)  # noqa: E731
    back = lambda x: np.asarray(x).reshape(B, N, T, D).transpose(0, 2, 1, 3)  # noqa: E731
    o_ref, lse_ref = jax_fa._flash_fwd(bn(q), bn(k), bn(v), scale, causal, blk, blk, True)
    dq_ref, dk_ref, dv_ref = jax_fa._flash_bwd((bn(q), bn(k), bn(v), o_ref, lse_ref), bn(do), scale, causal, blk,
                                               blk, True)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    o, lse = fa.flash_fwd_plain(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), back(o_ref), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=2e-5, rtol=0)
    delta = fa.flash_delta(t(back(o_ref)), t(do))
    dq = fa.flash_dq_plain(t(q), t(k), t(v), t(do), t(lse_ref), delta, causal=causal)
    dk, dv = fa.flash_dkv_plain(t(q), t(k), t(v), t(do), t(lse_ref), delta, causal=causal)
    for got, ref in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        np.testing.assert_allclose(got.numpy(), back(ref), atol=5e-4, rtol=0)
    assert 80 in fa.HEAD_DIMS
