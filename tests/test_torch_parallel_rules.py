"""The port's placement rules (parallel/mesh.py) against JAX's, leaf for
leaf, on the conftest's virtual CPU devices.

- ``tp_spec``, ``fsdp_spec``, ``state_specs_tp`` and ``state_specs_fsdp``
  give each leaf of a training state the ``PartitionSpec`` that JAX's
  ``tp_spec``, ``fsdp_spec``, ``shard_state_tp`` and ``shard_state_fsdp``
  place it with: the retrieval state (params, quant, BatchNorm statistics,
  constants, AdamW's moments, the EMA; the text stack unrolled and
  scanned) and the classifier's (both models, both optimizers,
  ``layer_names=("classifier_0", "classifier_3")``), at dp=2 with FSDP,
  tp=2, and dp=2 × tp=2 with FSDP.
- ``shard_state_fsdp``/``shard_state_tp``/``shard_tree_tp`` take the block
  of every leaf that JAX puts on the device with the same mesh
  coordinates.
- parallel/sharded_model.py ``module_specs``: every tensor of the port's
  module gets JAX's spec of its JAX-layout leaf, moved to the port's axes
  (conv kernels HWIO -> OIHW, Dense kernels transposed). The port keeps
  each parameter's Adam moments with the parameter's spec; JAX's
  shape-matched spec differs only where a replicated parameter has a
  tensor-parallel one's shape (its moment then shards over 'model').
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from atq_tpu.parallel import mesh as jmesh
from atq_tpu_torch.models.image_classifier import (
    ATQImageClassifier,
    BaselineCNNClassifier,
)
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.parallel import mesh as pmesh
from atq_tpu_torch.parallel.sharded_model import module_specs
from atq_tpu_torch.utils.jax_interop import jax_layout, to_jax_variables

LAYOUTS = {"dp2_fsdp": (2, 1, True), "tp2": (1, 2, False),
           "dp2_tp2_fsdp": (2, 2, True)}
CLS = ("classifier_0", "classifier_3")


def _retrieval(scanned):
    model = ATQMultimodalRetrieval(
        vocab_size=60, embed_dim=32, hidden_dim=64, use_residual=True,
        max_seq_length=8, text_scan_layers=scanned, device="cpu",
        generator=torch.Generator().manual_seed(0))
    v = model.jax_variables()
    state = {**v, "opt_state": optax.adamw(1e-3).init(v["params"]),
             "ema_params": v["params"]}
    return model, state, {}


def _classifier():
    atq = ATQImageClassifier(use_rpb=True, hidden_size=32, image_size=16,
                             device="cpu")
    base = BaselineCNNClassifier(hidden_size=32, image_size=16, device="cpu")
    a, b = (to_jax_variables(m.state_dict()) for m in (atq, base))
    tx = optax.adam(1e-3)
    state = {"atq_params": a["params"], "quant": a["quant"],
             "atq_batch_stats": a["batch_stats"],
             "atq_opt_state": tx.init(a["params"]),
             "base_params": b["params"], "base_batch_stats": b["batch_stats"],
             "base_opt_state": tx.init(b["params"])}
    return atq, state, {"layer_names": CLS,
                        "param_keys": ("atq_params", "quant", "base_params")}


STATES = {"retrieval": lambda: _retrieval(False),
          "retrieval_scanned": lambda: _retrieval(True),
          "classifier": _classifier}


def _jax_specs(state, layout, kw):
    dp, tp, fsdp = layout
    mesh = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    if fsdp:
        placed = jmesh.shard_state_fsdp(state, mesh, tp=tp, **kw)
    else:
        placed = jmesh.shard_state_tp(state, mesh, tp, **kw)
    return mesh, placed, jax.tree_util.tree_map(
        lambda a: tuple(a.sharding.spec), placed)


def _port_specs(state, layout, kw):
    dp, tp, fsdp = layout
    if fsdp:
        return pmesh.state_specs_fsdp(state, dp, tp, **kw)
    return pmesh.state_specs_tp(state, tp, **kw)


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, tuple)
                and all(a in ("data", "model", None) for a in x))}


def _flat_arrays(tree):
    return [(jax.tree_util.keystr(k), v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture(scope="module", params=list(STATES))
def state(request):
    return request.param, STATES[request.param]()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_state_specs_equal_jax_leaf_for_leaf(state, layout):
    name, (model, st, kw) = state
    _, placed, want = _jax_specs(st, LAYOUTS[layout], kw)
    got = _port_specs(st, LAYOUTS[layout], kw)
    want, got = _flat(want), _flat(got)
    assert sorted(want) == sorted(got)
    for k, spec in want.items():
        assert got[k] == spec, (name, layout, k)
    sharded = [k for k, s in got.items() if s]
    assert sharded, (name, layout)
    if LAYOUTS[layout][1] > 1:
        assert any("model" in s for s in got.values())


def test_rules_one_leaf_at_a_time():
    """tests/test_parallel.py's rule cases."""
    leaf = np.zeros((64, 512), np.float32)
    assert pmesh.fsdp_spec(leaf, 4) == tuple(jmesh.fsdp_spec(leaf, 4))
    small = np.zeros((8, 8), np.float32)
    assert pmesh.fsdp_spec(small, 4) == tuple(jmesh.fsdp_spec(small, 4)) \
        == ()
    odd = np.zeros((3, 16385), np.float32)
    assert pmesh.fsdp_spec(odd, 2) == tuple(jmesh.fsdp_spec(odd, 2))
    tp = ("model", None)
    assert pmesh.fsdp_spec(leaf, 2, existing=tp) == tuple(
        jmesh.fsdp_spec(leaf, 2, existing=P(*tp))) == ("model", "data")
    for keys, shape in ((["a", "linear1", "weight"], (64, 32)),
                        (["a", "linear1", "bias"], (64,)),
                        (["a", "other", "weight"], (64, 32)),
                        (["scan", "layer", "linear2", "weight"], (4, 64, 32)),
                        (["a", "q_proj", "weight"], (63, 32))):
        leaf = np.zeros(shape, np.float32)
        assert pmesh.tp_spec(keys, leaf, 2) == tuple(
            jmesh.tp_spec(keys, leaf, 2)), keys
    assert pmesh.data_sharding(None, 3) == tuple(P("data", None, None))


def test_placement_takes_each_devices_block(state):
    """A rank at mesh coordinates (d, m) holds the block JAX puts on the
    device at (d, m): checked for every device of a dp=2 x tp=2 mesh."""
    name, (model, st, kw) = state
    mesh, placed, specs = _jax_specs(st, LAYOUTS["dp2_tp2_fsdp"], kw)
    leaves = dict(_flat(specs))
    arrays = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_leaves_with_path(placed)}
    host = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(st)}
    checked = 0
    for key, spec in leaves.items():
        if not spec:
            continue
        for shard in arrays[key].addressable_shards:
            d, m = np.argwhere(mesh.devices == shard.device)[0]
            fake = pmesh.Mesh(2, 2)
            fake.index = {"data": int(d), "model": int(m)}.get
            got = pmesh.local_part(torch.from_numpy(host[key]), spec, fake)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shard.data))
            checked += 1
        if checked > 40:
            break
    assert checked > 8


def test_shard_functions_keep_the_structure(state):
    name, (model, st, kw) = state
    mesh = pmesh.Mesh(2, 2)
    torch_state = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a)), st)
    out = pmesh.shard_state_fsdp(torch_state, mesh, tp=2, **kw)
    specs = _flat(pmesh.state_specs_fsdp(st, 2, 2, **kw))
    flat_out = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_leaves_with_path(out)}
    flat_in = {jax.tree_util.keystr(k): v for k, v in
               jax.tree_util.tree_leaves_with_path(torch_state)}
    for key, value in flat_in.items():
        spec, shape = specs[key], list(value.shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                shape[dim] //= 2
        assert list(flat_out[key].shape) == shape, key
    params = "atq_params" if name == "classifier" else "params"
    tree, shapes = pmesh.shard_tree_tp(torch_state[params], mesh, 2,
                                       kw.get("layer_names",
                                              pmesh.DEFAULT_TP_LAYERS))
    _, want_shapes = jmesh.shard_tree_tp(
        st[params], jmesh.make_mesh(dp=1, tp=2, devices=jax.devices()[:2]),
        2, kw.get("layer_names", jmesh.DEFAULT_TP_LAYERS))
    assert shapes == want_shapes and shapes


@pytest.mark.parametrize("layout", ["dp2_fsdp", "dp2_tp2_fsdp"])
def test_module_specs_are_jax_specs_on_the_port_axes(state, layout):
    name, (model, st, kw) = state
    dp, tp, fsdp = LAYOUTS[layout]
    layer_names = kw.get("layer_names", pmesh.DEFAULT_TP_LAYERS)
    got = module_specs(model, dp, tp, fsdp, layer_names)
    params_key = "atq_params" if name == "classifier" else "params"
    coll_key = {"params": params_key, "quant": "quant",
                "batch_stats": "atq_batch_stats" if name == "classifier"
                else "batch_stats", "constants": "constants"}
    _, _, want = _jax_specs(st, LAYOUTS[layout], kw)
    sd = model.state_dict()
    for key, (coll, path, perm) in jax_layout(sd).items():
        spec = want[coll_key[coll]]
        for p in path:
            spec = spec[p]
        ndim = sd[key].dim()
        spec = tuple(spec) + (None,) * (ndim - len(spec))
        port = [None] * ndim
        for j, axis in enumerate(spec):
            port[perm[j] if perm else j] = axis
        assert got[key] == (tuple(port) if any(port) else ()), key
    # The port keeps each Adam moment with its parameter's spec. JAX places
    # the moments by shape: the same spec, except that a replicated
    # parameter whose shape equals a tensor-parallel one's gets a moment
    # sharded over 'model' (the fusion's 32x32 projections at this size).
    opt_key = "atq_opt_state" if name == "classifier" else "opt_state"
    adam = [x for x in jax.tree_util.tree_leaves(
        want[opt_key], is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(x, "mu")][0]
    flat_params = _flat(want[params_key])
    shapes = {k: np.shape(v) for k, v in _flat_arrays(st[params_key])}
    tp_shapes = {shapes[k] for k, v in flat_params.items() if "model" in v}
    for moment in (adam.mu, adam.nu):
        for k, spec in _flat(moment).items():
            if spec != flat_params[k]:
                assert "model" not in flat_params[k] and "model" in spec
                assert shapes[k] in tp_shapes and tp > 1, k
