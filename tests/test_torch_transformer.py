"""Port attention, transformer layer and scanned stack (atq_tpu_torch.nn)
against atq_tpu.nn on the CPU.

Both sides start from one JAX init, carried into the port through
utils/jax_interop.py, and see the same numpy inputs; the fused branch runs
the JAX Pallas kernel in interpret mode and the port's plain version.

Tolerances. Within the port, hoisted against unhoisted and fused against
einsum are held to tests/test_hoist.py's (outputs rtol 1e-6, gradients
rtol 2e-5 / atol 2e-6). Across the two frameworks the float32 sums run in
another order (matmuls, softmax, and LayerNorm: flax takes the variance as
E[x²] − E[x]², torch in two passes), and the loss ``sum(tanh(y))`` runs
through three layers whose activations grow to |y| ≈ 45, so the
differences scale with the largest value: the loss within rtol 2e-5,
outputs within 5e-5 of the largest |y|, gradients within rtol 1e-3 and
5e-4 of the largest |gradient| (measured worst: 1.3e-5 and 1.5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.nn import attention as jatt
from atq_tpu.nn import transformer as jtr
from atq_tpu_torch.nn import attention as tatt
from atq_tpu_torch.nn import transformer as ttr
from atq_tpu_torch.utils.jax_interop import (
    from_jax_variables,
    to_jax_variables,
)

B, S, E, H, F = 2, 10, 16, 4, 32
LOSS_RTOL, OUT_ATOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 5e-5, 1e-3, 5e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(from_jax_variables(
        {"params": _np(variables["params"]),
         "quant": _np(variables.get("quant", {}))}))
    return module


def _x(seed=0, shape=(B, S, E)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_loss_and_grads(module, variables, call):
    def loss(p):
        y = call(module, {**variables, "params": p})
        return jnp.sum(jnp.tanh(y.astype(jnp.float32))), y

    (l, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return float(l), np.asarray(y, np.float32), from_jax_variables(
        {"params": _np(g)})


def _torch_loss_and_grads(module, call):
    y = call(module)
    loss = torch.tanh(y.float()).sum()
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in module.named_parameters()}
    return float(loss.detach()), y.detach().float().numpy(), grads


def _compare(got, want, out_atol=OUT_ATOL, grad_rtol=GRAD_RTOL,
             grad_atol=GRAD_ATOL, loss_rtol=LOSS_RTOL):
    """Loss relative; outputs and gradients with an atol scaled by the
    largest |value| (see the module docstring)."""
    np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=out_atol * np.abs(want[1]).max())
    assert set(got[2]) == set(want[2])
    top = max(float(g.abs().max()) for g in want[2].values())
    for name, g in want[2].items():
        np.testing.assert_allclose(got[2][name].numpy(), g.numpy(),
                                   rtol=grad_rtol, atol=grad_atol * top,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
@pytest.mark.parametrize("use_rpb", [True, False])
def test_attention_matches_jax(impl, use_rpb):
    x = _x()
    lengths = np.asarray([6, S])
    kw = dict(dropout=0.0, use_rpb=use_rpb, critical_attention=True,
              grad_mode="ste", attn_impl=impl)
    jm = jatt.TernaryMultiheadAttention(embed_dim=E, num_heads=H, **kw)
    v = jm.init(jax.random.PRNGKey(0), x, x, x)
    want = _jax_loss_and_grads(jm, v, lambda m, vv: m.apply(
        vv, x, x, x, key_padding_mask=jnp.asarray(lengths)))
    tm = _load(tatt.TernaryMultiheadAttention(E, H, device="cpu", **kw), v)
    xt = torch.from_numpy(x)
    got = _torch_loss_and_grads(tm, lambda m: m(
        xt, xt, xt, key_padding_mask=torch.from_numpy(lengths)))
    _compare(got, want)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
@pytest.mark.parametrize("grad_mode", ["parity", "ste", "ttq"])
def test_transformer_layer_matches_jax(impl, grad_mode):
    x = _x(1)
    pad = np.arange(S)[None, :] >= np.asarray([4, S])[:, None]
    kw = dict(dim_feedforward=F, dropout=0.0, grad_mode=grad_mode,
              attn_impl=impl)
    jl = jtr.TernaryTransformerLayer(embed_dim=E, num_heads=H, **kw)
    v = jl.init(jax.random.PRNGKey(1), x)
    want = _jax_loss_and_grads(jl, v, lambda m, vv: m.apply(
        vv, x, src_key_padding_mask=jnp.asarray(pad)))
    tl = _load(ttr.TernaryTransformerLayer(E, H, device="cpu", **kw), v)
    got = _torch_loss_and_grads(tl, lambda m: m(
        torch.from_numpy(x), src_key_padding_mask=torch.from_numpy(pad)))
    _compare(got, want)


def _stacks(hoist, grad_mode="ste", remat=True, policy="save_quantized",
            dtype=None, impl="einsum", seed=0):
    kw = dict(dim_feedforward=F, dropout=0.0, use_rpb=True,
              sparsity_target=0.3, grad_mode=grad_mode, remat=remat,
              remat_policy=policy, hoist_quant=hoist, attn_impl=impl)
    x = _x(seed)
    js = jtr.ScannedTernaryStack(num_layers=3, embed_dim=E, num_heads=H,
                                 dtype=None if dtype is None
                                 else jnp.bfloat16, **kw)
    v = js.init(jax.random.PRNGKey(seed), x)
    ts = _load(ttr.ScannedTernaryStack(
        3, E, H, dtype=dtype, device="cpu", **kw), v)
    return js, v, ts, x


@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("grad_mode", ["parity", "ste", "ttq"])
def test_scanned_stack_matches_jax(hoist, grad_mode):
    js, v, ts, x = _stacks(hoist, grad_mode)
    want = _jax_loss_and_grads(js, v, lambda m, vv: m.apply(vv, x))
    got = _torch_loss_and_grads(ts, lambda m: m(torch.from_numpy(x)))
    _compare(got, want)


@pytest.mark.parametrize("hoist,remat,policy", [
    (False, False, "save_quantized"), (True, False, "save_quantized"),
    (False, True, "full"), (True, True, "save_dots")])
def test_scanned_stack_remat_options_match_jax(hoist, remat, policy):
    js, v, ts, x = _stacks(hoist, "ste", remat, policy, impl="fused",
                           seed=2)
    want = _jax_loss_and_grads(js, v, lambda m, vv: m.apply(vv, x))
    got = _torch_loss_and_grads(ts, lambda m: m(torch.from_numpy(x)))
    _compare(got, want)


@pytest.mark.parametrize("hoist", [False, True])
def test_scanned_stack_amp_matches_jax(hoist):
    """AMP: bf16 matmuls and a bf16 carry. The two frameworks round a bf16
    product's f32 sum at the same points but may sum in another order, so
    an element can land one bf16 step (2^-8 relative) apart: the loss
    within rtol 1e-2, outputs within 2e-2 of the largest |y|, gradients
    within rtol 2e-2 and 2e-2 of the largest |gradient|."""
    js, v, ts, x = _stacks(hoist, dtype=torch.bfloat16)
    want = _jax_loss_and_grads(js, v, lambda m, vv: m.apply(vv, x))
    got = _torch_loss_and_grads(ts, lambda m: m(torch.from_numpy(x)))
    assert got[1].dtype == np.float32 and ts(torch.from_numpy(x)).dtype \
        == torch.bfloat16
    _compare(got, want, out_atol=2e-2, grad_rtol=2e-2, grad_atol=2e-2,
             loss_rtol=1e-2)


def test_hoisted_and_fused_against_unhoisted_einsum_in_the_port():
    """Hoisted against unhoisted (both einsum): tests/test_hoist.py's
    tolerances. Fused against einsum (both hoisted): the softmax is written
    out in the fused plain version, so its sums run in another order; the
    loss within rtol 1e-5 and gradients within rtol 1e-4 and 3e-6 of the
    largest |gradient|, as tests/test_fused_attention.py holds the JAX
    layer, and outputs within 1e-5 of the largest |y|."""
    outs = []
    for hoist, impl in ((False, "einsum"), (True, "einsum"), (True, "fused")):
        g = torch.Generator().manual_seed(0)
        st = ttr.ScannedTernaryStack(3, E, H, F, dropout=0.0,
                                     grad_mode="ste", hoist_quant=hoist,
                                     attn_impl=impl, device="cpu",
                                     generator=g)
        y = st(torch.from_numpy(_x()))
        loss = y.tanh().sum()
        loss.backward()
        outs.append((float(loss.detach()), y.detach(),
                     {n: p.grad.clone() for n, p in st.named_parameters()}))
    (l0, y0, g0), (l1, y1, g1), (l2, y2, g2) = outs
    assert l1 == pytest.approx(l0, rel=1e-6)
    torch.testing.assert_close(y1, y0, rtol=1e-6, atol=1e-7)
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, rtol=2e-5, atol=2e-6)
    assert l2 == pytest.approx(l1, rel=1e-5)
    torch.testing.assert_close(y2, y1, rtol=0,
                               atol=1e-5 * float(y1.abs().max()))
    top = max(float(g.abs().max()) for g in g1.values())
    for n, g in g1.items():
        torch.testing.assert_close(g2[n], g, rtol=1e-4, atol=3e-6 * top)


def test_stack_unstack_round_trip():
    g = torch.Generator().manual_seed(0)
    st = ttr.ScannedTernaryStack(3, E, H, F, device="cpu", generator=g)
    sd = {f"layers.{k}": v for k, v in st.state_dict().items()}
    sd["head.weight"] = torch.ones(2)
    unrolled = ttr.unstack_layer_params(sd, 3)
    assert "layers_2.self_attn.q_proj.precision_mask" in unrolled
    assert unrolled["layers_1.linear1.weight"].shape == (F, E)
    back = ttr.stack_layer_params(unrolled, 3)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # each unrolled layer loads into a TernaryTransformerLayer
    layer = ttr.TernaryTransformerLayer(E, H, F, device="cpu")
    layer.load_state_dict({k[len("layers_1."):]: v
                           for k, v in unrolled.items()
                           if k.startswith("layers_1.")})


def test_scanned_interop_round_trip():
    js, v, ts, _ = _stacks(True, "ttq")
    back = to_jax_variables(ts.state_dict())
    want = _np({"params": v["params"], "quant": v["quant"]})
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(map(str, flat_b)) == set(map(str, flat_w))
    for path, a in flat_w.items():
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)


def test_moe_and_bad_options_raise():
    with pytest.raises(NotImplementedError):
        ttr.TernaryTransformerLayer(E, H, F, moe_experts=2, device="cpu")
    with pytest.raises(ValueError):
        ttr.ScannedTernaryStack(2, E, H, F, remat_policy="dots",
                                device="cpu")


def test_fused_with_active_dropout_warns_once_and_runs_einsum():
    tatt._warned_fused_dropout = False
    m = tatt.TernaryMultiheadAttention(E, H, dropout=0.1, attn_impl="fused",
                                       device="cpu")
    x = torch.from_numpy(_x())
    with pytest.warns(UserWarning, match="falling back"):
        m(x, x, x, deterministic=False)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m(x, x, x, deterministic=False)
