"""Built-in model zoo (float graphs)."""

from .transformer import bert, bert_base, gpt2, gpt2_small, vit, vit_b16, vit_l16
from .vision import mobilenet_v2, resnet, vgg

__all__ = ["bert", "bert_base", "gpt2", "gpt2_small", "mobilenet_v2", "resnet", "vgg",
           "vit", "vit_b16", "vit_l16"]
