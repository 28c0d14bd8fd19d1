"""The port's ternary-expert MoE FFN (parallel/moe.py), the MoE transformer
layer and the MoE retrieval model against atq_tpu on the CPU.

- Routing (``top1_dispatch``): the (T, E, C) dispatch tensor equal, so the
  expert, slot and keep of every token are integer-identical, with and
  without a token mask, at a capacity that overflows and one that does
  not; a gate tie goes to the first expert in both packages. The combine
  weights within 1e-6, the expert fractions equal, the aux loss within
  1e-6 relative.
- ``moe_ffn``, dense and with ternary experts: outputs within 1e-5; the
  experts' ternary patterns bit-identical to JAX's per-plane ones, below
  and above the order statistic's 16,384-weight cut.
- Gradients with respect to x, the gate and both planes, against
  ``jax.grad``: within 1e-5 of the largest |gradient| of each leaf.
- The transformer layer with MoE (lengths as the padding mask): the loss
  within 2e-5 relative, the output within 5e-5 of its largest |value|,
  gradients within tests/test_torch_transformer.py's tolerances; the aux
  loss within 1e-6 relative.
- The retrieval model with ``text_moe_experts``: eval embeddings within
  1e-5 and the four layers' aux losses within 1e-6 relative; ``scan_layers``
  with MoE raises JAX's ValueError; a JAX MoE checkpoint serves
  ``--packed`` (the expert planes stay dense, as JAX's export leaves them)
  within 1e-5 of JAX, and ``--aot`` exports with a symbolic batch and
  answers as the live model, bit for bit.

Training steps against JAX's are in tests/test_torch_moe_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.core.quantize import (
    adaptive_ternary_quantization as jax_quantize,
)
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.models.text_encoder import ATQTextEncoder as JaxTextEncoder
from atq_tpu.nn import transformer as jtr
from atq_tpu.parallel import moe as jmoe
from atq_tpu.serve.packed_model import (
    export_packed_collection as jax_export_packed,
    packed_collection_bytes as jax_packed_bytes,
)
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.models.text_encoder import ATQTextEncoder
from atq_tpu_torch.nn import transformer as ttr
from atq_tpu_torch.parallel import moe as tmoe
from atq_tpu_torch.serve.aot import export_serving
from atq_tpu_torch.serve.packed_model import (
    attach_packed_collection,
    export_packed_collection,
)
from atq_tpu_torch.utils.jax_interop import from_jax_variables

T, D, HID, E = 40, 16, 24, 4
B, S, EMBED, HEADS, FF = 2, 10, 16, 4, 32
VOCAB, RET_EMBED, RET_HIDDEN, SIZE, SEQ = 60, 32, 64, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(T, D).astype(np.float32)
    params = {"gate": rng.randn(D, E).astype(np.float32) * D ** -0.5,
              "w1": rng.randn(E, D, HID).astype(np.float32) * D ** -0.5,
              "w2": rng.randn(E, HID, D).astype(np.float32) * HID ** -0.5}
    mask = rng.rand(T) > 0.25
    return x, params, mask


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("capacity", [3, T], ids=["overflow", "ample"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_routing_matches_jax(capacity, masked):
    x, p, mask = _inputs()
    m = mask if masked else None
    jd, jc, ja = jmoe.top1_dispatch(jnp.asarray(x), jnp.asarray(p["gate"]),
                                    E, capacity,
                                    None if m is None else jnp.asarray(m))
    td, tc, ta = tmoe.top1_dispatch(torch.from_numpy(x),
                                    torch.from_numpy(p["gate"]), E, capacity,
                                    None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    routed = td.numpy().sum(axis=(1, 2))
    valid = mask if masked else np.ones(T, bool)
    assert (routed[valid] < 1).any() == (capacity < T)  # overflow drops
    assert not routed[~valid].any()  # padding is never routed
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ta["expert_fraction"].numpy(),
                                  np.asarray(ja["expert_fraction"]))
    np.testing.assert_allclose(float(ta["aux_loss"]), float(ja["aux_loss"]),
                               rtol=1e-6)


def test_gate_ties_go_to_the_first_expert():
    x, p, _ = _inputs(1)
    gate = np.repeat(p["gate"][:, :1], E, axis=1)  # every logit equal
    jd, _, _ = jmoe.top1_dispatch(jnp.asarray(x), jnp.asarray(gate), E, T)
    td, _, _ = tmoe.top1_dispatch(torch.from_numpy(x),
                                  torch.from_numpy(gate), E, T)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (td.numpy().sum(axis=2).argmax(axis=1) == 0).all()


def _jax_planes(w, s):
    """JAX's per-plane patterns and alphas (moe.py's vmapped quantizer)."""
    return jax.vmap(lambda plane: jax_quantize(plane, sparsity_target=s))(
        jnp.asarray(w))


@pytest.mark.parametrize("shape", [(E, D, HID), (2, 128, 160)],
                         ids=["sort", "order_statistic"])
def test_expert_patterns_are_bit_identical(shape):
    """Below 16,384 weights a plane sorts; above, the batched order
    statistic (its plain version here) gives the thresholds."""
    w = np.random.RandomState(2).randn(*shape).astype(np.float32)
    from atq_tpu_torch.core.quantize import (
        adaptive_ternary_quantization_batched,
    )

    jw_t, j_alpha = _jax_planes(w, 0.1)
    tw_t, t_alpha = adaptive_ternary_quantization_batched(
        torch.from_numpy(w), sparsity_target=0.1)
    np.testing.assert_array_equal(tw_t.numpy(), np.asarray(jw_t))
    np.testing.assert_allclose(t_alpha.numpy(), np.asarray(j_alpha),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tmoe._ternarize_expert_planes(torch.from_numpy(w), 0.1).numpy(),
        np.asarray(jmoe._ternarize_expert_planes(jnp.asarray(w), 0.1)),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("ternary", [False, True], ids=["dense", "ternary"])
def test_moe_ffn_matches_jax(ternary):
    x, p, mask = _inputs()
    for capacity in (3, 12):
        want, _ = jmoe.moe_ffn(jnp.asarray(x), _jnp(p), capacity,
                               ternary=ternary, sparsity_target=0.1,
                               token_mask=jnp.asarray(mask))
        got, _ = tmoe.moe_ffn(torch.from_numpy(x), _torch(p), capacity,
                              ternary=ternary, sparsity_target=0.1,
                              token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_moe_gradients_match_jax():
    """sum(tanh(y)) + aux with ternary experts, a mask and overflow: the
    gradients of x, the gate and both planes (the planes' through the
    optimal alphas only)."""
    x, p, mask = _inputs(3)

    def jloss(x_, gate, w1, w2):
        y, aux = jmoe.moe_ffn(x_, {"gate": gate, "w1": w1, "w2": w2}, 6,
                              ternary=True, sparsity_target=0.1,
                              token_mask=jnp.asarray(mask))
        return jnp.sum(jnp.tanh(y)) + aux["aux_loss"]

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in ("gate", "w1", "w2")))
    args = [torch.from_numpy(a).requires_grad_()
            for a in (x, p["gate"], p["w1"], p["w2"])]
    y, aux = tmoe.moe_ffn(args[0], dict(zip(("gate", "w1", "w2"), args[1:])),
                          6, ternary=True, sparsity_target=0.1,
                          token_mask=torch.from_numpy(mask))
    (torch.tanh(y).sum() + aux["aux_loss"]).backward()
    for name, a, w in zip(("x", "gate", "w1", "w2"), args, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_init_moe_params_shapes_and_scales():
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 64, 96, 8)
    want = jmoe.init_moe_params(jax.random.PRNGKey(0), 64, 96, 8)
    for k in ("gate", "w1", "w2"):
        assert tuple(p[k].shape) == want[k].shape
        assert float(p[k].std()) == pytest.approx(
            float(jnp.std(want[k])), rel=0.05)


def test_transformer_layer_moe_matches_jax():
    x = np.random.RandomState(4).randn(B, S, EMBED).astype(np.float32)
    lengths = np.asarray([S, 6], np.int32)
    jl = jtr.TernaryTransformerLayer(EMBED, HEADS, FF, dropout=0.0,
                                     moe_experts=E, sparsity_target=0.1)
    v = _np(jax.jit(jl.init)(jax.random.PRNGKey(0), jnp.asarray(x)))

    def jloss(params):
        y, st = jl.apply({**v, "params": params}, jnp.asarray(x),
                         src_key_padding_mask=jnp.asarray(lengths),
                         mutable=["intermediates"])
        (aux,) = jax.tree_util.tree_leaves(st["intermediates"])
        return jnp.sum(jnp.tanh(y)) + aux, (y, aux)

    (want_l, (want_y, want_aux)), g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(v["params"])
    want_g = from_jax_variables({"params": _np(g)})
    tl = ttr.TernaryTransformerLayer(EMBED, HEADS, FF, dropout=0.0,
                                     moe_experts=E, sparsity_target=0.1,
                                     device="cpu")
    assert not hasattr(tl, "linear1")
    tl.load_state_dict(from_jax_variables({"params": v["params"],
                                           "quant": v.get("quant", {})}))
    aux = []
    y = tl(torch.from_numpy(x), src_key_padding_mask=torch.from_numpy(lengths),
           moe_aux=aux)
    loss = torch.tanh(y).sum() + aux[0]
    loss.backward()
    assert len(aux) == 1
    np.testing.assert_allclose(aux[0].item(), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_l), rtol=2e-5)
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0,
                               atol=5e-5 * np.abs(want_y).max())
    top = max(float(t.abs().max()) for t in want_g.values())
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-3, atol=5e-4 * top, err_msg=name)


def test_scan_layers_with_moe_raises_like_jax():
    tokens = jnp.zeros((1, 4), jnp.int32)
    with pytest.raises(ValueError, match="scan_layers"):
        JaxTextEncoder(vocab_size=10, embed_dim=8, num_heads=2,
                       num_layers=1, dim_feedforward=16, scan_layers=True,
                       moe_experts=2).init(jax.random.PRNGKey(0), tokens)
    with pytest.raises(ValueError, match="scan_layers"):
        ATQTextEncoder(vocab_size=10, embed_dim=8, num_heads=2,
                       num_layers=1, dim_feedforward=16, scan_layers=True,
                       moe_experts=2, device="cpu")


@pytest.fixture(scope="module")
def retrieval():
    """A port-initialised MoE retrieval model (its JAX-layout variables
    carried to flax) and a batch."""
    port = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=RET_EMBED, hidden_dim=RET_HIDDEN,
        use_residual=True, max_seq_length=SEQ, text_moe_experts=E,
        device="cpu", generator=torch.Generator().manual_seed(0))
    v = port.jax_variables()
    jm = JaxRetrieval(vocab_size=VOCAB, embed_dim=RET_EMBED,
                      hidden_dim=RET_HIDDEN, use_residual=True,
                      max_seq_length=SEQ, text_moe_experts=E)
    rng = np.random.RandomState(5)
    batch = (rng.randn(6, SIZE, SIZE, 3).astype(np.float32),
             rng.randint(4, VOCAB, (6, SEQ)).astype(np.int32),
             np.asarray([SEQ, 2, 5, SEQ, 3, 1], np.int32))
    return port, jm, v, batch


def test_retrieval_embeddings_and_aux_match_jax(retrieval):
    port, jm, v, batch = retrieval
    assert set(v["params"]["text_encoder"]["layers_0"]) >= {
        "moe_gate", "moe_w1", "moe_w2"}
    (want_img, want_txt), st = jax.jit(lambda var, *a: jm.apply(
        var, *a, return_embeddings=True, mutable=["intermediates"]))(
        v, *map(jnp.asarray, batch))
    want_aux = sorted(float(a) for a in jax.tree_util.tree_leaves(
        st["intermediates"]))
    aux = []
    with torch.no_grad():
        img, txt = port(*(torch.from_numpy(a) for a in batch),
                        return_embeddings=True, moe_aux=aux)
    assert len(aux) == len(want_aux) == 4
    np.testing.assert_allclose(sorted(float(a) for a in aux), want_aux,
                               rtol=1e-6)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(txt.numpy(), np.asarray(want_txt), rtol=0,
                               atol=1e-5)


def test_packed_moe_serving_matches_jax(retrieval):
    """``--packed``: only the 2-D quantized layers pack, in both packages;
    the expert planes stay dense and are ternarized per batch."""
    _, jm, v, batch = retrieval
    params = {k: x for k, x in v["params"].items() if k != "fusion"}
    jpacked = jax_export_packed(params, v["quant"])
    assert "moe_w1" not in jpacked["text_encoder"]["layers_0"]
    want = np.asarray(jax.jit(lambda var, *a: jm.apply(
        var, *a, method=jm.encode_text))(
        {**v, "packed": jpacked}, jnp.asarray(batch[1]),
        jnp.asarray(batch[2])))
    port = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=RET_EMBED, hidden_dim=RET_HIDDEN,
        use_residual=True, max_seq_length=SEQ, text_moe_experts=E,
        device="cpu")
    port.load_jax_variables(v)
    packed = export_packed_collection(params, v["quant"], device="cpu")
    assert set(packed["text_encoder"]["layers_0"]) == set(
        jpacked["text_encoder"]["layers_0"])
    attach_packed_collection(port, packed)
    with torch.no_grad():
        got = port.encode_text(torch.from_numpy(batch[1]).long(),
                               torch.from_numpy(batch[2]).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert jax_packed_bytes(jpacked) > 0


def test_aot_moe_text_program_answers_as_the_live_model(retrieval):
    port = retrieval[0]
    example = (torch.zeros((2, SEQ), dtype=torch.int64),
               torch.full((2,), 5, dtype=torch.int64))
    aot = export_serving(port.encode_text, example)
    assert aot.batch_polymorphic  # the capacity follows the batch
    rng = np.random.RandomState(6)
    for n in (1, 3, 7):
        tokens = torch.from_numpy(rng.randint(4, VOCAB, (n, SEQ)))
        lengths = torch.from_numpy(rng.randint(1, SEQ + 1, n))
        with torch.inference_mode():
            want = port.encode_text(tokens, lengths)
        assert torch.equal(aot(tokens, lengths), want)
