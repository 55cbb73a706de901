from .mlp import MLP, make_mlp
from .transformer import CausalLM, TransformerConfig, ce_loss

__all__ = ["MLP", "make_mlp", "CausalLM", "TransformerConfig", "ce_loss"]
