"""Models of the PyTorch port; parameters are views into one flat vector.

The registry of the JAX package's ``models/__init__.py``: every CV model
name resolves through ``get_model`` to a constructor that takes
``num_classes``, the NHWC ``input_shape``, a ``generator`` and a
``device`` (``"meta"``: the layout alone) besides the model's own
arguments; ``MODEL_NAMES`` lists the same 15 names.
"""

from commefficient_torch.models.fixup_resnet import FixupResNet50
from commefficient_torch.models.resnet9 import FixupResNet9, ResNet9
from commefficient_torch.models.resnet18 import FixupResNet18, ResNet18
from commefficient_torch.models.resnets import (ResNet101LN, resnet18,
                                                resnet34, resnet50,
                                                resnet101, resnet152,
                                                resnext50_32x4d,
                                                resnext101_32x8d,
                                                wide_resnet50_2,
                                                wide_resnet101_2)

_REGISTRY = {
    "ResNet9": ResNet9,
    "FixupResNet9": FixupResNet9,
    "ResNet18": ResNet18,
    "FixupResNet18": FixupResNet18,
    "FixupResNet50": FixupResNet50,
    "ResNet101LN": ResNet101LN,
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "resnext50_32x4d": resnext50_32x4d,
    "resnext101_32x8d": resnext101_32x8d,
    "wide_resnet50_2": wide_resnet50_2,
    "wide_resnet101_2": wide_resnet101_2,
}

MODEL_NAMES = sorted(_REGISTRY)


def get_model(name: str):
    """The constructor of a registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choices: {MODEL_NAMES}") from None
