from .convert import params_from_jax, params_to_jax
from .pagg import PaggSpec, PathNet, draw_dropout_masks

__all__ = ["PaggSpec", "PathNet", "draw_dropout_masks", "params_from_jax",
           "params_to_jax"]
