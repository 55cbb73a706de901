from .mlp import MLP, make_mlp
from .phi import PhiCausalLM, PhiConfig
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101
from .transformer import CausalLM, TransformerConfig, ce_loss

__all__ = ["MLP", "make_mlp", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "CausalLM", "TransformerConfig", "ce_loss", "PhiCausalLM", "PhiConfig"]
