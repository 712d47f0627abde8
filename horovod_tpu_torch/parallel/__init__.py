"""Parallel training steps of the port."""

from .adasum import adasum_allreduce, adasum_hierarchical
from .expert import (init_moe_params, local_experts, make_moe_fn,
                     moe_dense_reference, moe_params_from_jax)
from .sequence import (make_ring_attn_fn, make_ulysses_attn_fn,
                       ring_attention, sequence_loss_fn, ulysses_attention)

__all__ = ["adasum_allreduce", "adasum_hierarchical", "init_moe_params",
           "local_experts", "make_moe_fn", "moe_dense_reference",
           "moe_params_from_jax", "make_ring_attn_fn", "make_ulysses_attn_fn",
           "ring_attention", "sequence_loss_fn", "ulysses_attention"]
