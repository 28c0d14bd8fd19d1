"""``--scan_layers`` under ``--tp 2`` and ``--fsdp`` (train/retrieval.py,
nn/transformer.py ``run_layer``, parallel/sharded_model.py) in a gloo world
of 2 on the CPU, against the one-process scanned step on the same batch
(tests/test_torch_scan_retrieval.py holds that one against JAX's
``text_scan_layers=True`` step), within tests/_dp_reference.py's limits:
the stacked (L, out, in) projections shard their out-features (their
second axis, JAX's ``tp_spec`` for a scanned stack) and each layer
quantizes its gathered weight inside its checkpoint; under ``--fsdp`` the
stacked leaves shard over 'data'. JAX's ``dryrun_multichip`` runs this
stack on its dp x tp mesh.
"""

import numpy as np

import _dp_reference as ref
import _torch_dist as td


def test_scanned_stack_under_tp_and_fsdp():
    _, v = ref.jax_init(text_scan_layers=True)
    b = ref.batch()
    scan = dict(model={"text_scan_layers": True}, cfg={"scan_layers": True})
    one = td.launch(1, td.retrieval_steps, [
        ref.spec(v, b, **scan), ref.spec(v, ref.perturbed(b), **scan)])[0]
    ranks = td.launch(2, td.retrieval_steps, [
        ref.spec(v, b, dp=1, tp=2, **scan),
        ref.spec(v, b, dp=2, fsdp=True, **scan)])
    for got, what in zip(ranks[0], ("tp2", "dp2 fsdp")):
        ref.assert_step_like(got, one[0], f"scanned {what}", one)
    assert ranks[1][0]["loss"] == ranks[0][0]["loss"]
    assert ranks[0][1]["state_bytes"] < 0.55 * one[0]["state_bytes"]
    assert np.isfinite(ranks[0][0]["loss"])
