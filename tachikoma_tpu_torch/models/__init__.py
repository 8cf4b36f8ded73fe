"""Built-in model zoo (float graphs)."""

from .vision import mobilenet_v2, resnet

__all__ = ["mobilenet_v2", "resnet"]
