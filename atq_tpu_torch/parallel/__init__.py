"""Parallel building blocks (port of atq_tpu/parallel) over
``torch.distributed``: the ('data', 'model') mesh and the JAX placement
rules (``mesh``), collectives (``collectives``), per-process input
(``multihost``), the MoE FFN and its expert-parallel form (``moe``), ring
attention (``ring_attention``) and the GPipe schedule (``pipeline``). The
trainers place their modules through ``sharded_model``."""

from atq_tpu_torch.parallel.collectives import (
    all_gather_embeddings,
    psum_grads,
)
from atq_tpu_torch.parallel.mesh import (
    data_sharding,
    fsdp_spec,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    shard_state_fsdp,
    shard_state_tp,
    shard_tree_tp,
)
from atq_tpu_torch.parallel.moe import (
    init_moe_params,
    moe_ffn,
    moe_ffn_sharded,
    top1_dispatch,
)
from atq_tpu_torch.parallel.multihost import (
    global_batch_from_local,
    process_batch_slice,
)
from atq_tpu_torch.parallel.pipeline import (
    merge_microbatches,
    pipeline_apply,
    split_microbatches,
    stack_stage_params,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_sharding",
    "fsdp_spec",
    "shard_state_fsdp",
    "shard_state_tp",
    "shard_tree_tp",
    "init_distributed",
    "global_batch_from_local",
    "process_batch_slice",
    "all_gather_embeddings",
    "psum_grads",
    "pipeline_apply",
    "split_microbatches",
    "merge_microbatches",
    "stack_stage_params",
    "init_moe_params",
    "moe_ffn",
    "moe_ffn_sharded",
    "top1_dispatch",
]
