"""Data, tensor and pipeline parallelism over ``torch.distributed`` (port
of ``numpy_quant_tpu/parallel``): one process per rank, each given the
same global input and returning the global output."""
from .mesh import (Mesh, Ranks, all_gather, all_reduce, batch_sharded,
                   broadcast, make_dp_tp_mesh, make_mesh, recv, replicated,
                   send, spawn)
from .pipeline import (pipeline_forward, pipeline_forward_stagewise,
                       split_stages)
from .sharding import (gpt_tp_rules, llama_tp_rules, param_shardings,
                       shard_model, vit_tp_rules)

__all__ = [
    "Mesh", "Ranks", "spawn", "make_mesh", "make_dp_tp_mesh", "replicated",
    "batch_sharded", "all_reduce", "all_gather", "broadcast", "send",
    "recv", "param_shardings", "shard_model", "vit_tp_rules",
    "gpt_tp_rules", "llama_tp_rules", "split_stages", "pipeline_forward",
    "pipeline_forward_stagewise",
]
