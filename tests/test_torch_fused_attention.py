"""Port fused attention (atq_tpu_torch.ops.fused_attention) against the JAX
package's Pallas kernels (atq_tpu.ops.fused_attention, in interpret mode on
the CPU), through the port's plain versions on CPU tensors.

Same numpy inputs through both. Tolerances: float32 o within rtol/atol
1e-5 and gradients within rtol 1e-4 / atol 1e-5 (the JAX package's own
kernel-vs-einsum tolerances, tests/test_fused_attention.py); bfloat16 2e-2
(a bf16 rounding of p or dS may land on the other side of a tie when the
float32 sums before it differ in order). The CUDA kernels are held against
the same plain versions by tests/test_torch_cuda_kernels.py and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.ops import fused_attention as jfa
from atq_tpu_torch.ops import fused_attention as tfa

B, H, S, D = 2, 3, 16, 8
SCALE = 1.0 / np.sqrt(D)


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(4)]


def _mask(kind):
    """(jax mask, torch mask) for the padding variants."""
    lengths = np.asarray([5, S])
    if kind is None:
        return None, None
    if kind == "lengths":
        return jnp.asarray(lengths), torch.from_numpy(lengths)
    if kind == "empty_row":
        lengths = np.asarray([0, S])  # first batch row: everything padded
    pad = np.arange(S)[None, :] >= lengths[:, None]
    return jnp.asarray(pad), torch.from_numpy(pad)


def _run(dtype, kind, seed=0):
    """Outputs and q/k/v gradients of sum(o * g) from both packages."""
    q, k, v, g = _qkv(seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm, tm = _mask(kind)
    jbias = jfa.padding_bias(jm, S)
    tbias = tfa.padding_bias(tm, S)

    def jloss(q, k, v):
        o = jfa.fused_attention(q, k, v, SCALE, jbias)
        return jnp.sum(o.astype(jnp.float32) * g), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    to = tfa.fused_attention(*leaves, SCALE, tbias)
    (to.float() * torch.from_numpy(g)).sum().backward()
    want = [np.asarray(jo, np.float32)] + [np.asarray(x, np.float32)
                                           for x in jg]
    got = [to.detach().float().numpy()] + [t.grad.float().numpy()
                                           for t in leaves]
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", [None, "mask", "lengths", "empty_row"])
def test_forward_and_gradients_match_jax(dtype, kind):
    got, want = _run(dtype, kind)
    assert all(np.isfinite(x).all() for x in got)
    for i, (a, b) in enumerate(zip(got, want)):
        if dtype == "float32":
            tol = dict(rtol=1e-5, atol=1e-5) if i == 0 else \
                dict(rtol=1e-4, atol=1e-5)
        else:
            tol = dict(rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(a, b, err_msg=f"output {i}", **tol)


def test_plain_versions_repeat_the_jax_kernels_at_another_shape():
    rng = np.random.RandomState(4)
    q, k, v, do = (rng.randn(1, 2, 40, 16).astype(np.float32)
                   for _ in range(4))
    lengths = np.asarray([23])
    jb = jfa.padding_bias(jnp.asarray(lengths), 40)
    tb = tfa.padding_bias(torch.from_numpy(lengths), 40)
    o_j, res = jfa._fused_fwd(*(jnp.asarray(a) for a in (q, k, v)), 0.25, jb)
    grads_j = jfa._fused_bwd(0.25, res, jnp.asarray(do))[:3]
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o_t = tfa.fused_attention_forward(*t[:3], 0.25, tb)
    grads_t = tfa.fused_attention_backward(*t[:3], 0.25, tb, t[3])
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["mask", "lengths"])
def test_padding_bias_matches_jax(kind):
    jm, tm = _mask(kind)
    np.testing.assert_array_equal(tfa.padding_bias(tm, S).numpy(),
                                  np.asarray(jfa.padding_bias(jm, S)))
    assert tfa.padding_bias(None, S) is None


def test_bias_gets_no_gradient_and_counts_stay_on_cpu():
    q, k, v, _ = _qkv(1)
    bias = tfa.padding_bias(torch.tensor([3, S]), S).requires_grad_()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    before = (tfa.fused_attention_forward.launches,
              tfa.fused_attention_backward.launches)
    tfa.fused_attention(*leaves, SCALE, bias).sum().backward()
    assert bias.grad is None
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert (tfa.fused_attention_forward.launches,
            tfa.fused_attention_backward.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "seq", "head_dim", "shape",
                                 "bias_shape"])
def test_wrapper_rejects_inputs_the_kernel_cannot_take(bad):
    q = torch.randn(1, 2, 16, 8)
    k = v = q
    bias = None
    if bad == "dtype":
        q = k = v = q.double()
    elif bad == "seq":
        q = k = v = torch.randn(1, 1, 513, 8)
    elif bad == "head_dim":
        q = k = v = torch.randn(1, 1, 16, 129)
    elif bad == "shape":
        k = torch.randn(1, 2, 16, 4)
    elif bad == "bias_shape":
        bias = torch.zeros(1, 16)
    with pytest.raises(ValueError):
        tfa.fused_attention_forward(q, k, v, 1.0, bias)
