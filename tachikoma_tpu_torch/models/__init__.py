"""Built-in model zoo (float graphs)."""

from . import transformer, vision
from .transformer import bert, bert_base, gpt2, gpt2_small, vit, vit_b16, vit_l16
from .vision import (dcgan_generator, densenet, digits_cnn, dqn, inception_v3_stem, lenet5, lstm,
                     mlp, mobilenet_v2, resnet, resnet_3d, squeezenet, ssd_lite, vgg)

__all__ = ["bert", "bert_base", "dcgan_generator", "densenet", "digits_cnn", "dqn", "gpt2",
           "gpt2_small", "inception_v3_stem", "lenet5", "lstm", "mlp", "mobilenet_v2", "resnet",
           "resnet_3d", "squeezenet", "ssd_lite", "vgg", "vit", "vit_b16", "vit_l16"]
