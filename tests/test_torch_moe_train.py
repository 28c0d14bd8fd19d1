"""Retrieval training with ``--moe_experts`` (train/retrieval.py) against
the JAX package's step on the CPU, at small widths (vocabulary 60, embed
32, FFN 64, 2 experts a text layer, images 16x16, batch 8, sequence 8;
4 text layers), from one init (the port's, carried to flax) with every
ternary layer at its optimal alpha, dropout 0 and float images (no random
draw).

- One plain step and one GradCache step (N = 2, with distillation, so the
  pass-2 aux term carries ``1 - distill_weight``) against JAX's: the loss,
  which holds ``0.01 · mean(aux)``, within 1e-4 relative; each gradient
  leaf within tests/test_torch_gradcache.py's group tolerances of its own
  L2 norm, the expert stacks and gates among them.
- ``--grad_checkpointing``: the plain and the GradCache step give the same
  loss and gradients with and without it (the recompute's aux losses go to
  a list of its own and are not counted twice).
- ``--use_amp``: every MoE layer computes in float32 (what the AMP
  ``norm2`` gives it), as JAX's does: the eval text embeddings against
  JAX's ``compute_dtype=bfloat16`` ones by tests/test_torch_retrieval_amp.py's
  ratio, with a planted bfloat16 MoE that must fail; and the trainer's
  step 0, its loss within 3e-2 of JAX's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from unittest import mock

from atq_tpu.losses.contrastive import (
    ContrastiveLearningManager as JaxManager,
    HardNegativeMiningInfoNCE as JaxInfoNCE,
)
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.train import retrieval as jtrain
from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.nn import transformer as ttr
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils.jax_interop import to_jax_variables

VOCAB, EMBED, HIDDEN, SIZE, SEQ, EXPERTS, BATCH = 60, 32, 64, 16, 8, 2, 8
LOSS_RTOL, ROUNDING = 1e-4, 1e-6
LEAF_RTOL = {"trunk": 5e-2, "scalar": 0.15, "tensor": 1e-3}
AMP_LOSS_RTOL, AMP_TEXT_LIMIT = 3e-2, 0.06
# (GradCache microbatches, distillation)
CASES = {"plain": (1, False), "gradcache_distill": (2, True)}
# JAX jitted with its bf16 outputs kept bf16
# (tests/test_torch_retrieval_amp.py).
LITERAL = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _optimal_alphas(params, quant):
    for k, node in params.items():
        if not isinstance(node, dict):
            continue
        q = quant.get(k, {}) if isinstance(quant, dict) else {}
        if "alpha" in node and "weight" in node:
            _, a = adaptive_ternary_quantization(
                torch.from_numpy(np.array(node["weight"])),
                sparsity_target=float(q.get("sparsity_target", 0.3)))
            node["alpha"] = np.full((1,), float(a), np.float32)
        else:
            _optimal_alphas(node, q)


def _port_model(v=None, amp=False):
    model = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
        use_residual=True, max_seq_length=SEQ, dropout=0.0,
        text_moe_experts=EXPERTS,
        compute_dtype=torch.bfloat16 if amp else None, device="cpu",
        generator=torch.Generator().manual_seed(3))
    if v is not None:
        model.load_jax_variables(v)
    return model


@pytest.fixture(scope="module")
def setup():
    v = _port_model().jax_variables()
    _optimal_alphas(v["params"], v["quant"])
    rng = np.random.RandomState(1)
    batch = (rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
             rng.randint(4, VOCAB, (BATCH, SEQ)).astype(np.int32),
             rng.randint(2, SEQ + 1, BATCH).astype(np.int32))
    base = tuple(rng.randn(BATCH, EMBED).astype(np.float32)
                 for _ in range(2))
    return v, batch, base


def _config(module, n_accum, remat=False):
    return module.RetrievalConfig(
        use_residual=True, embed_dim=EMBED, hidden_dim=HIDDEN,
        contrastive_reg=0.05, grad_accum_steps=n_accum,
        grad_checkpointing=remat, moe_experts=EXPERTS)


def _capture():
    """An optax transformation that keeps the gradients in its state."""
    def update(u, s, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}

    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}, update)


def _jax_step(v, batch, base, n_accum, amp=False):
    model = JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED,
                         hidden_dim=HIDDEN, use_residual=True,
                         max_seq_length=SEQ, dropout=0.0,
                         text_moe_experts=EXPERTS,
                         compute_dtype=jnp.bfloat16 if amp else None)
    crit = JaxInfoNCE(temperature=0.07, lambda_reg=0.05)
    step = jtrain.build_retrieval_train_step(
        model, _capture(), crit, JaxManager(criterion=crit),
        _config(jtrain, n_accum))
    state = {"params": v["params"], "quant": v["quant"],
             "constants": v["constants"], "batch_stats": v["batch_stats"],
             "opt_state": _capture().init(v["params"]),
             "step": jnp.asarray(0, jnp.int32)}
    new, loss = jax.jit(step, compiler_options=LITERAL if amp else None)(
        state, tuple(map(jnp.asarray, batch)), jnp.float32(0.07),
        jnp.int32(0), jax.random.PRNGKey(1),
        None if base is None else tuple(map(jnp.asarray, base)))
    return float(loss), dict(_leaves(_np(new["opt_state"]["g"])))


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's float32 steps, computed once."""
    v, batch, base = setup
    return {case: _jax_step(v, batch, base if distill else None, n_accum)
            for case, (n_accum, distill) in CASES.items()}


class _NoUpdate:
    def step(self):
        pass


def _grads(model):
    sd = {**model.state_dict(),
          **{k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}}
    return dict(_leaves(to_jax_variables(sd)["params"]))


def _port_step(v, batch, base, n_accum, remat=False, amp=False):
    model = _port_model(v, amp)
    step = ptrain.build_retrieval_train_step(
        model, _NoUpdate(),
        HardNegativeMiningInfoNCE(temperature=0.07, lambda_reg=0.05),
        _config(ptrain, n_accum, remat))
    loss = step(ptrain._batch_to(batch, torch.device("cpu")),
                torch.tensor(0.07), torch.tensor(0),
                None if base is None else tuple(map(torch.from_numpy, base)))
    return float(loss), _grads(model)


def _group(name, grad):
    if name.startswith("image_encoder/base_model/"):
        return "trunk"
    return "scalar" if grad.size == 1 else "tensor"


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(setup, jax_steps, case):
    v, batch, base = setup
    n_accum, distill = CASES[case]
    want = jax_steps[case]
    got = _port_step(v, batch, base if distill else None, n_accum)
    assert sorted(got[1]) == sorted(want[1])
    assert any(k.endswith("moe_w1") for k in got[1])
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0]), (got[0],
                                                               want[0])
    top = max(np.abs(g).max() for g in want[1].values())
    for k, w in want[1].items():
        if np.abs(w).max() <= ROUNDING * top:
            continue
        r = np.linalg.norm(got[1][k] - w) / np.linalg.norm(w)
        assert r <= LEAF_RTOL[_group(k, w)], (k, r)


@pytest.mark.parametrize("n_accum", [1, 2], ids=["plain", "gradcache"])
def test_grad_checkpointing_counts_the_aux_loss_once(setup, n_accum):
    v, batch, base = setup
    plain = _port_step(v, batch, base, n_accum)
    remat = _port_step(v, batch, base, n_accum, remat=True)
    assert remat[0] == pytest.approx(plain[0], rel=1e-6)
    for k, g in plain[1].items():
        np.testing.assert_allclose(remat[1][k], g, rtol=1e-5,
                                   atol=1e-6 * (1 + np.abs(g).max()),
                                   err_msg=k)


@contextlib.contextmanager
def _moe_calls(bf16=False):
    """Records each MoE call's input dtype; ``bf16`` plants a fault: the
    MoE computed in bfloat16."""
    dtypes = []
    moe_ffn = ttr.moe_ffn

    def recording(x, params, *a, **k):
        dtypes.append(x.dtype)
        if not bf16:
            return moe_ffn(x, params, *a, **k)
        y, aux = moe_ffn(x.bfloat16(), {n: t.bfloat16()
                                        for n, t in params.items()}, *a, **k)
        return y.float(), aux

    with mock.patch.object(ttr, "moe_ffn", recording):
        yield dtypes


def _jax_text(v, batch, amp):
    model = JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED,
                         hidden_dim=HIDDEN, use_residual=True,
                         max_seq_length=SEQ, dropout=0.0,
                         text_moe_experts=EXPERTS,
                         compute_dtype=jnp.bfloat16 if amp else None)
    return np.asarray(jax.jit(lambda var, *a: model.apply(
        var, *a, method=model.encode_text), compiler_options=LITERAL)(
        v, jnp.asarray(batch[1]), jnp.asarray(batch[2])))


def test_amp_moe_computes_in_float32(setup):
    """Eval-mode text embeddings under AMP, by the ratio of
    tests/test_torch_retrieval_amp.py,
    ``mean|port - jax_bf16| / mean|jax_bf16 - jax_f32|``, and its text
    limit 0.06 (reading 0.0055); the MoE computed in bfloat16 reads 3.6
    and must fail."""
    v, batch, _ = setup
    amp, f32 = _jax_text(v, batch, True), _jax_text(v, batch, False)
    model = _port_model(v, amp=True)
    ratios = {}
    for fault in (False, True):
        with _moe_calls(bf16=fault) as dtypes, torch.no_grad():
            got = model.encode_text(torch.from_numpy(batch[1]).long(),
                                    torch.from_numpy(batch[2]).long())
        assert dtypes == [torch.float32] * 4  # what norm2 gives, per layer
        ratios[fault] = (np.abs(got.numpy() - amp).mean()
                         / np.abs(amp - f32).mean())
    assert ratios[False] <= AMP_TEXT_LIMIT < ratios[True], ratios


def test_amp_step0_matches_jax(setup):
    """The trainer's ``--use_amp`` step 0: each MoE layer takes float32;
    the loss (its aux term included) within 3e-2 of JAX's (reading
    1.8e-3). Train-mode BatchNorm over 8 images leaves the gradients of
    two AMP implementations as far apart as AMP from float32
    (tests/test_torch_retrieval_amp.py), so they are held finite here and
    the MoE's arithmetic by the eval test above."""
    v, batch, _ = setup
    want = _jax_step(v, batch, None, 1, amp=True)
    with _moe_calls() as dtypes:
        got = _port_step(v, batch, None, 1, amp=True)
    assert dtypes == [torch.float32] * 4
    assert abs(got[0] - want[0]) <= AMP_LOSS_RTOL * abs(want[0])
    assert sorted(got[1]) == sorted(want[1])
    assert all(np.isfinite(g).all() for g in got[1].values())
