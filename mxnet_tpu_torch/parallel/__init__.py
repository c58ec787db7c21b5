"""The parallel training path (counterpart of ``mxnet_tpu/parallel``):
meshes over ``torch.distributed`` (one process per rank,
``parallel/_dist.py``), ``SPMDTrainer`` with dp / tp / sp and ZeRO 1–3,
ring and Ulysses sequence parallelism, Switch MoE with expert
parallelism, the pipeline schedules (GPipe, interleaved, 1F1B) over a
``pp`` axis, and ``Mesh4DTrainer`` over pp × dp × tp × ep."""
from .mesh import (make_mesh, default_mesh, data_parallel_spec, replicated,
                   Mesh, PartitionSpec, NamedSharding)
from .mesh4d import MeshPlan, Mesh4DTrainer, mesh_plan_from_env
from .trainer import SPMDTrainer
from .ring_attention import (ring_attention, ring_self_attention,
                             ring_flash_attention,
                             ring_flash_self_attention)
from .ulysses import ulysses_attention, ulysses_self_attention
from .moe import switch_moe, moe_expert_sharding
from .pipeline import (gpipe_apply, pipeline_forward, interleaved_apply,
                       pipeline_forward_interleaved, pipeline_forward_1f1b,
                       interleave_params, interleaved_ticks, gpipe_ticks,
                       one_f_one_b_apply, pipeline_value_and_grad_1f1b,
                       one_f_one_b_ticks)

__all__ = ["make_mesh", "default_mesh", "data_parallel_spec", "replicated",
           "MeshPlan", "Mesh4DTrainer", "mesh_plan_from_env",
           "SPMDTrainer", "ring_attention", "ring_self_attention",
           "ring_flash_attention", "ring_flash_self_attention",
           "ulysses_attention", "ulysses_self_attention",
           "gpipe_apply", "pipeline_forward", "switch_moe",
           "interleaved_apply", "pipeline_forward_1f1b",
           "pipeline_forward_interleaved", "pipeline_value_and_grad_1f1b",
           "one_f_one_b_apply", "one_f_one_b_ticks",
           "interleave_params", "interleaved_ticks", "gpipe_ticks",
           "moe_expert_sharding"]

