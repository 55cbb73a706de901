from .convnext import ConvNeXt, convnext_small, convnext_tiny, convnextv2_tiny
from .efficientformer import EfficientFormerV2, efficientformerv2_s0, efficientformerv2_s1
from .mlp import MLP, make_mlp
from .phi import PhiCausalLM, PhiConfig
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101
from .swin import SwinV2, swin_tiny, swinv2_small, swinv2_tiny
from .transformer import CausalLM, PrunedSublayer, TransformerConfig, ce_loss, prune_blocks

__all__ = ["MLP", "make_mlp", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "ConvNeXt", "convnext_tiny", "convnext_small", "convnextv2_tiny",
           "SwinV2", "swinv2_tiny", "swinv2_small", "swin_tiny",
           "EfficientFormerV2", "efficientformerv2_s0", "efficientformerv2_s1",
           "CausalLM", "TransformerConfig", "ce_loss", "PhiCausalLM", "PhiConfig",
           "PrunedSublayer", "prune_blocks"]
