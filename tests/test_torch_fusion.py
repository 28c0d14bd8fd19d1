"""The port's cross-modal attention (nn/attention.py
``TernaryCrossAttention``), fusion (models/fusion.py, all three
``fusion_method``s) and the retrieval model's ``return_fused`` and
``train=True`` forward against atq_tpu's on the CPU.

Each JAX module is initialised once; its variables are carried into the
port through utils/jax_interop.py. Inputs are numpy draws. Outputs agree
within rtol/atol 1e-5 (the model's: 1e-4, through ResNet-18) and gradients
of ``sum(out * r)`` for a random ``r`` within rtol 1e-4 and an atol of 1e-5
times the largest gradient (the model's: 1e-3 and 1e-4; float32, different
summation orders, and leaves whose gradient is all rounding). Dropout is
off (deterministic, or rate 0 in training mode): the two packages' random
streams differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.models.fusion import MultimodalFusion as JaxFusion
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.nn.attention import TernaryCrossAttention as JaxCross
from atq_tpu_torch.models.fusion import MultimodalFusion
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.nn.attention import TernaryCrossAttention
from atq_tpu_torch.utils.jax_interop import (
    from_jax_variables,
    to_jax_variables,
)

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_jax_layout(module):
    """The port's parameter gradients in the JAX param layout."""
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in module.named_parameters()}
    return to_jax_variables(grads)["params"]


def _assert_tree_close(got, want, rtol, atol, scaled=False):
    """Leaf by leaf; with ``scaled`` the atol is relative to the largest
    |leaf| of ``want``."""
    if scaled:
        atol *= max(float(np.abs(x).max())
                    for x in jax.tree_util.tree_leaves(want))

    def walk(g, w, path):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}/{k}")
            else:
                np.testing.assert_allclose(np.asarray(g[k]),
                                           np.asarray(w[k]), rtol=rtol,
                                           atol=atol, err_msg=f"{path}/{k}")

    walk(got, want, "")


def _check(jax_apply, variables, port, port_call, inputs, out_shape, seed):
    """Output and the gradients of sum(out * r), w.r.t. the params."""
    r = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)

    def loss(params):
        out = jax_apply({**variables, "params": params}, *inputs)
        return jnp.sum(out * r), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    out = port_call(*(torch.from_numpy(np.asarray(x)) if isinstance(
        x, np.ndarray) else x for x in inputs))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    (out * torch.from_numpy(r)).sum().backward()
    _assert_tree_close(_grads_jax_layout(port), _np(jgrads), GRAD_RTOL,
                       GRAD_ATOL, scaled=True)


@pytest.mark.parametrize("query_len,key_len", [(None, None), (3, 5)],
                         ids=["vectors", "sequences"])
def test_cross_attention_matches_jax(query_len, key_len):
    rng = np.random.RandomState(0)
    b, d = 4, 32

    def draw(n):
        shape = (b, d) if n is None else (b, n, d)
        return rng.randn(*shape).astype(np.float32)

    q, kv = draw(query_len), draw(key_len)
    jm = JaxCross(hidden_dim=d, num_heads=4, use_rpb=True,
                  sparsity_target=0.05)
    v = _np(jm.init(jax.random.PRNGKey(1), q, kv, kv))
    port = TernaryCrossAttention(d, num_heads=4, use_rpb=True,
                                 sparsity_target=0.05, device="cpu")
    port.load_state_dict(from_jax_variables(v))
    _check(lambda var, a, b_: jm.apply(var, a, b_, b_), v, port,
           lambda a, b_: port(a, b_, b_), (q, kv), q.shape, 2)


@pytest.mark.parametrize("method", ["cross_attention", "concat", "gate"])
@pytest.mark.parametrize("use_rpb", [True, False], ids=["rpb", "ternary"])
def test_fusion_methods_match_jax(method, use_rpb):
    rng = np.random.RandomState(3)
    dims = {"image": 24, "text": 16}
    feats = {k: rng.randn(4, n).astype(np.float32) for k, n in dims.items()}
    jm = JaxFusion(input_dims=dims, output_dim=32, fusion_method=method,
                   use_rpb=use_rpb)
    v = _np(jm.init(jax.random.PRNGKey(4), {k: jnp.asarray(x)
                                            for k, x in feats.items()}))
    port = MultimodalFusion(dims, 32, fusion_method=method, use_rpb=use_rpb,
                            device="cpu")
    port.load_state_dict(from_jax_variables(v))
    assert to_jax_variables(port.state_dict()).keys() == v.keys()
    _check(lambda var, i, t: jm.apply(var, {"image": i, "text": t}), v, port,
           lambda i, t: port({"image": i, "text": t}),
           (feats["image"], feats["text"]), (4, 32), 5)
    with pytest.raises(ValueError, match="text"):
        port({"image": torch.from_numpy(feats["image"])})


def test_model_return_fused_and_train_forward_match_jax():
    """return_fused in eval mode, and a training-mode forward (BatchNorm
    batch statistics, dropout 0) of the fused embedding: output, every
    parameter's gradient (the fusion's included) and the moved running
    statistics."""
    rng = np.random.RandomState(6)
    img = rng.randn(4, 32, 32, 3).astype(np.float32)
    txt = rng.randint(4, 40, (4, 8)).astype(np.int32)
    lengths = np.asarray([8, 5, 3, 6], np.int32)
    kw = dict(vocab_size=40, embed_dim=32, hidden_dim=64, use_residual=True,
              max_seq_length=8, dropout=0.0)
    jm = JaxRetrieval(**kw)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.zeros(
        (1, 32, 32, 3)), jnp.zeros((1, 8), jnp.int32),
        jnp.asarray([5], jnp.int32)))
    port = ATQMultimodalRetrieval(**kw, device="cpu")
    port.load_jax_variables(v)
    targs = (torch.from_numpy(img), torch.from_numpy(txt).long(),
             torch.from_numpy(lengths).long())

    want = jax.jit(lambda var: jm.apply(var, img, txt, lengths,
                                        return_fused=True))(v)
    with torch.no_grad():
        got = port(*targs, return_fused=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    r = rng.randn(4, 32).astype(np.float32)

    def loss(params):
        out, mutated = jm.apply({**v, "params": params}, img, txt, lengths,
                                return_fused=True, train=True,
                                mutable=["batch_stats"])
        return jnp.sum(out * r), (out, mutated)

    (_, (want, mutated)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    out = port(*targs, return_fused=True, train=True)
    assert port.training
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    (out * torch.from_numpy(r)).sum().backward()
    _assert_tree_close(_grads_jax_layout(port), _np(jgrads), 1e-3, 1e-4,
                       scaled=True)
    _assert_tree_close(port.jax_variables()["batch_stats"],
                       _np(mutated["batch_stats"]), 1e-4, 1e-5)
    port(*targs, return_embeddings=True)
    assert not port.training  # train=False puts it back in eval mode
