"""Multi-process runs of the port on the CPU for the scale-out tests: a
launcher that starts a gloo world of N processes (one torch thread each,
the environment torchrun would give them) and calls one of the workers
below in every rank, and the workers themselves. This module imports
neither JAX nor atq_tpu, so the spawned ranks start quickly; the tests hold
what rank 0 returns against JAX in the parent process. A worker called with
``launch(1, ...)`` runs in the calling process with no process group: the
one-device port.
"""

from __future__ import annotations

import os
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, name, args, queue):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    torch.set_num_threads(1)
    try:
        from atq_tpu_torch.parallel.mesh import init_distributed

        init_distributed("cpu")
        out = globals()[name](*args)
        queue.put((rank, "ok", out))
    except BaseException:  # the parent raises it
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def launch(world: int, worker, *args):
    """``[rank 0's result, rank 1's, ...]`` of ``worker(*args)`` in a gloo
    world of ``world`` processes (in-process for 1)."""
    if world == 1:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return [worker(*args)]
        finally:
            torch.set_num_threads(threads)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port,
                                              worker.__name__, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = [None] * world, []
    try:
        for _ in range(world):
            rank, status, out = queue.get(timeout=TIMEOUT)
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if errors else TIMEOUT)
            if p.is_alive():
                p.kill()
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


# ------------------------------------------------------------ retrieval


def retrieval_steps(specs):
    """One retrieval train step of the port per spec, each over its own
    mesh of the world (``dp``, ``tp``, ``fsdp``) from JAX-layout variables
    on a global batch; see :func:`retrieval_step`."""
    return [retrieval_step(spec) for spec in specs]


def retrieval_step(spec):
    """One retrieval train step of the port over a mesh of the world
    (``spec["dp"]``, ``["tp"]``, ``["fsdp"]``) from JAX-layout variables on
    a global batch. Returns the loss, the step's gradient (Adam's first
    moment after one step over 0.1, whole, in the JAX layout), the
    BatchNorm statistics, this rank's state bytes at rest (module, moments)
    and the generator's state after the step. ``spec["planted"]`` routes
    the MoE tokens of each rank on their own (a planted fault: per-rank
    capacity and slots)."""
    from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
    from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
    from atq_tpu_torch.nn import transformer
    from atq_tpu_torch.parallel import moe
    from atq_tpu_torch.parallel.mesh import make_mesh
    from atq_tpu_torch.parallel.sharded_model import ShardedModel
    from atq_tpu_torch.train import retrieval as ptrain

    cpu = torch.device("cpu")
    mesh = make_mesh(spec.get("dp"), spec.get("tp", 1))
    model = ATQMultimodalRetrieval(device="cpu", **spec["model"])
    model.load_jax_variables(spec["variables"])
    sharded = ShardedModel(model, mesh, fsdp=spec.get("fsdp", False))
    cfg = ptrain.RetrievalConfig(**spec["cfg"])
    opt = ptrain.make_retrieval_optimizer(cfg, sharded.optim_params,
                                          spec.get("steps_per_epoch", 6))
    if mesh.size > 1:
        opt.global_norm_sq = sharded.global_norm_sq
    gen = torch.Generator().manual_seed(spec.get("seed", 0))
    step = ptrain.build_retrieval_train_step(
        model, opt, HardNegativeMiningInfoNCE(temperature=0.07,
                                              lambda_reg=0.05),
        cfg, gen, None, mesh, sharded)
    batch = ptrain._batch_to(spec["batch"], cpu)
    saved = (transformer.active_data_shard, moe.active_data_shard)
    if spec.get("planted"):
        transformer.active_data_shard = moe.active_data_shard = (
            lambda: None)
    try:
        loss = step(batch, torch.tensor(spec.get("temperature", 0.14)),
                    torch.tensor(spec.get("kind", 0)))
    finally:
        transformer.active_data_shard, moe.active_data_shard = saved
    mu = sharded.to_full(opt.mu)
    whole = sharded.full_state_dict()
    grads = ptrain._variables(model, [m / 0.1 for m in mu], state=whole)
    moments = sum(t.numel() * t.element_size() for t in opt.mu + opt.nu)
    return _numpy({
        "loss": loss, "grads": grads["params"],
        "batch_stats": ptrain._variables(model, state=whole)["batch_stats"],
        "state_bytes": sharded.state_bytes(), "moment_bytes": moments,
        "generator": gen.get_state()})


# ----------------------------------------------------------- classifier


class _NoUpdate:
    global_norm_sq = None

    def step(self):
        pass


def classifier_steps(state, batch, cfg, specs):
    """One co-trained classifier step per spec (``dp``, ``tp``, ``fsdp``,
    ``grad_accum_steps``) from the JAX trainer's state (numpy leaves) on a
    global batch, with optimizers that keep the gradients. Returns per
    spec the metrics, both models' gradients (whole, JAX layout), their
    BatchNorm statistics and the student's state bytes at rest."""
    from atq_tpu_torch.models.image_classifier import (
        ATQImageClassifier,
        BaselineCNNClassifier,
    )
    from atq_tpu_torch.parallel.mesh import make_mesh
    from atq_tpu_torch.parallel.sharded_model import ShardedModel
    from atq_tpu_torch.train import classifier as ptrain
    from atq_tpu_torch.utils.jax_interop import (
        from_jax_train_state,
        to_jax_variables,
    )

    out = []
    for spec in specs:
        mesh = make_mesh(spec.get("dp"), spec.get("tp", 1))
        atq_sd, base_sd = from_jax_train_state(state)
        size, hidden = batch[0].shape[1], spec["hidden"]
        atq = ATQImageClassifier(use_rpb=True, hidden_size=hidden,
                                 dropout_rate=spec.get("dropout", 0.0),
                                 image_size=size, device="cpu")
        base = BaselineCNNClassifier(hidden_size=hidden,
                                     dropout_rate=spec.get("dropout", 0.0),
                                     image_size=size, device="cpu")
        atq.load_state_dict(atq_sd)
        base.load_state_dict(base_sd)
        atq.train()
        base.train()
        shards = [ShardedModel(m, mesh, fsdp=spec.get("fsdp", False),
                               layer_names=ptrain.TP_LAYERS)
                  for m in (atq, base)]
        c = ptrain.ClassifierConfig(
            **{**cfg, "grad_accum_steps": spec.get("grad_accum_steps", 1)})
        gen = torch.Generator().manual_seed(spec.get("seed", 0))
        step = ptrain.build_train_step(atq, base, _NoUpdate(), _NoUpdate(),
                                       c, gen, mesh, shards)
        metrics = step(torch.from_numpy(batch[0]),
                       torch.from_numpy(batch[1]).long(),
                       spec.get("l1", 2e-5))
        result = {"metrics": {k: v.item() for k, v in metrics.items()},
                  "state_bytes": shards[0].state_bytes()}
        for name, model, sh in (("atq", atq, shards[0]),
                                ("base", base, shards[1])):
            tensors = [t for _, t in sh.optim_params]
            grads = sh.to_full([t.grad if t.grad is not None
                                else torch.zeros_like(t) for t in tensors])
            whole = sh.full_state_dict()
            names = [n for n, _ in model.named_parameters()]
            variables = to_jax_variables({**whole, **dict(zip(names,
                                                             grads))})
            result[name] = variables["params"]
            result[name + "_stats"] = to_jax_variables(
                whole)["batch_stats"]
        out.append(_numpy(result))
    return out


# ------------------------------------------------------------ library


def library_checks(data):
    """The parallel library over a 'data' group of the world's ranks, on
    the inputs of ``data`` (numpy, the same on every rank). Returns this
    rank's results: collectives, per-process input, the expert-parallel
    MoE FFN (outputs, aux, gradients), the row-sharded index search (f32
    and int8), ring and sequence-parallel attention and the pipeline (each
    with gradients)."""
    import torch.distributed as dist

    from atq_tpu_torch.parallel import collectives as C
    from atq_tpu_torch.parallel import mesh as M
    from atq_tpu_torch.parallel.moe import moe_ffn_sharded
    from atq_tpu_torch.parallel.multihost import (
        global_batch_from_local,
        process_batch_slice,
    )
    from atq_tpu_torch.parallel.pipeline import pipeline_apply
    from atq_tpu_torch.parallel.ring_attention import (
        ring_attention,
        sequence_parallel_attention,
    )
    from atq_tpu_torch.serve.index import EmbeddingIndex

    mesh = M.make_mesh()
    group, n, me = mesh.group("data"), mesh.shape["data"], mesh.index("data")
    t = {k: torch.from_numpy(v) for k, v in data.items()
         if isinstance(v, np.ndarray)}
    out = {}

    # Collectives (tests/test_parallel.py's cases).
    emb = mesh.rows(t["emb"]).clone().requires_grad_()
    gathered = C.all_gather_embeddings(emb, group)
    (gathered * t["emb_g"]).sum().backward()
    out["gathered"], out["gathered_grad"] = gathered, emb.grad
    grads = {"a": torch.full((3,), float(me + 1)), "b": torch.ones(2) * me}
    out["psum"] = C.psum_grads(grads, group)
    out["pmean"] = C.pmean_metrics({"loss": torch.tensor(float(me))}, group)
    out["similarity"] = C.global_contrastive_similarity(
        mesh.rows(t["emb"]), mesh.rows(t["emb2"]), 0.07, group)
    out["slice"] = process_batch_slice(8)
    with_mesh = process_batch_slice(8, mesh)
    try:
        process_batch_slice(7)
        out["uneven_raises"] = False
    except ValueError:
        out["uneven_raises"] = True
    out["global_batch"] = global_batch_from_local(
        (t["emb"][with_mesh[0]:with_mesh[1]],), mesh)[0]
    out["shard_batch"] = M.shard_batch({"x": t["emb"]}, mesh)["x"]
    rep = {"w": torch.full((2,), float(me))}
    out["replicate"] = M.replicate(rep, mesh)["w"]

    # Expert parallelism.
    e_local = data["moe_w1"].shape[0] // n
    x = mesh.rows(t["moe_x"]).clone().requires_grad_()
    params = {"gate": t["moe_gate"].clone().requires_grad_(),
              "w1": t["moe_w1"][me * e_local:(me + 1) * e_local]
              .clone().requires_grad_(),
              "w2": t["moe_w2"][me * e_local:(me + 1) * e_local]
              .clone().requires_grad_()}
    y, aux = moe_ffn_sharded(x, params, group, data["moe_capacity"],
                             ternary=data["moe_ternary"],
                             token_mask=mesh.rows(t["moe_mask"]))
    ((y * mesh.rows(t["moe_g"])).sum() + aux["aux_loss"]).backward()
    out["moe"] = {"y": y, "aux": aux, "dx": x.grad,
                  "dgate": params["gate"].grad, "dw1": params["w1"].grad,
                  "dw2": params["w2"].grad}

    # The row-sharded search.
    for quantize in ("none", "int8"):
        index = EmbeddingIndex(dim=data["corpus"].shape[1],
                               capacity=data["capacity"], quantize=quantize,
                               device="cpu")
        index.add([f"c{i}" for i in range(len(data["corpus"]))],
                  data["corpus"])
        ids, scores = index.search(data["queries"], k=data["topk"], mesh=mesh)
        out["search_" + quantize] = (ids, scores)

    # Ring attention: this rank's sequence block.
    def block(x, dim):
        return C.shard_rows(x.transpose(0, dim), me, n).transpose(0, dim)

    q, k, v = (block(t[name], 2).clone().requires_grad_()
               for name in ("q", "k", "v"))
    o = ring_attention(q, k, v, group, block(t["pad"], 1))
    (o * block(t["attn_g"], 2)).sum().backward()
    out["ring"] = {"o": o, "dq": q.grad, "dk": k.grad, "dv": v.grad}
    out["seq_parallel"] = sequence_parallel_attention(
        t["q"], t["k"], t["v"], group, t["pad"])

    # The pipeline: rank s runs stage s.
    stage = {name: t[name].clone().requires_grad_() for name in ("pw", "pb")}
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["pw"] + p["pb"]),
                       stage, t["px"], group=group, n_micro=data["n_micro"])
    (y * t["pg"]).sum().backward()
    out["pipeline"] = {"y": y, "dw": stage["pw"].grad[me],
                       "db": stage["pb"].grad[me]}
    out["world"] = dist.get_world_size()
    return _numpy(out)


def trainer_main(module, argv):
    """A trainer on this rank from its CLI flags (``module``: 'retrieval',
    its ``main``; or 'classifier', ``train_classifier`` on 128 synthetic
    training images). Returns the step losses of its epochs."""
    if module == "retrieval":
        from atq_tpu_torch.train.retrieval import main

        state, _, _ = main(argv)
        return state["stats"]["step_losses"]
    from atq_tpu_torch.data.mnist import FASHION_STATS, ArrayLoader
    from atq_tpu_torch.data.mnist import _synthetic
    from atq_tpu_torch.train.__main__ import build_parser, config_from_args
    from atq_tpu_torch.train.classifier import train_classifier

    imgs, labels, timgs, tlabels = _synthetic("fashion_mnist", 192, 64)
    loaders = (ArrayLoader(imgs[:128], labels[:128], 32, FASHION_STATS,
                           shuffle=True, drop_remainder=True, raw=True),
               ArrayLoader(imgs[128:], labels[128:], 32, FASHION_STATS),
               ArrayLoader(timgs, tlabels, 32, FASHION_STATS))
    cfg = config_from_args(build_parser().parse_args(argv))
    _, results = train_classifier(cfg, loaders=loaders, verbose=False)
    return results["step_losses"]


# ------------------------------------------------------- hoisted stack


def hoisted_stacks(specs):
    """A ScannedTernaryStack(hoist_quant=True) forward and backward per
    spec, from a port state dict (``state``) on ``x`` with the padding
    mask ``pad``, over a mesh of the world at ``tp`` (dp 1; one process at
    tp 1); the loss is ``sum(y · cot)``, fixed cotangents. Returns the
    loss, the output, every parameter's gradient whole (port names), each
    call of the batched threshold in the forward (the stacked weight it
    was given and the thresholds it returned) and the count of per-layer
    threshold calls in the forward and backward (none when every layer
    runs pre-quantized)."""
    from unittest import mock

    from atq_tpu_torch.core import quantize
    from atq_tpu_torch.nn.transformer import ScannedTernaryStack
    from atq_tpu_torch.parallel.mesh import make_mesh
    from atq_tpu_torch.parallel.sharded_model import ShardedModel

    out = []
    for spec in specs:
        stack = ScannedTernaryStack(**spec["config"], hoist_quant=True,
                                    device="cpu")
        stack.load_state_dict({k: torch.from_numpy(v)
                               for k, v in spec["state"].items()})
        sharded = ShardedModel(stack, make_mesh(1, spec["tp"]))
        calls, single = [], []
        batched = quantize.ternary_threshold_batched
        threshold = quantize.ternary_threshold

        def recorded(weights, *args, **kwargs):
            thr = batched(weights, *args, **kwargs)
            calls.append((weights.detach().clone(), thr.clone()))
            return thr

        def counted(*args, **kwargs):
            single.append(1)
            return threshold(*args, **kwargs)

        with mock.patch.object(quantize, "ternary_threshold_batched",
                               recorded), \
                mock.patch.object(quantize, "ternary_threshold", counted):
            y = stack(torch.from_numpy(spec["x"]),
                      src_key_padding_mask=torch.from_numpy(spec["pad"]))
            loss = (y * torch.from_numpy(spec["cot"])).sum()
            loss.backward()
        sharded.reduce_grads()
        tensors = [t for _, t in sharded.optim_params]
        grads = sharded.to_full([t.grad if t.grad is not None
                                 else torch.zeros_like(t) for t in tensors])
        names = [n for n, _ in stack.named_parameters()]
        out.append(_numpy({"loss": float(loss.detach()), "y": y,
                           "grads": dict(zip(names, grads)),
                           "thresholds": calls,
                           "single_thresholds": len(single)}))
    return out
