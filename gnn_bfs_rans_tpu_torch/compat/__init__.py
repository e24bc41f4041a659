"""Compatibility: weights carried from the JAX package (``from_jax``) and
the reference's own ``.pt`` checkpoints (``torch_port``, with the
reference model ``torch_ref.RefFlowGNN`` as their oracle)."""

from .torch_port import convert_state_dict, load_torch_checkpoint

__all__ = ["convert_state_dict", "load_torch_checkpoint"]
