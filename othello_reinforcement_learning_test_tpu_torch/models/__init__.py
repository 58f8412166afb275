from .resnet import (
    OthelloResNet,
    ResBlock,
    create_model,
    init_variables,
    param_count,
    predict,
)

__all__ = [
    "OthelloResNet",
    "ResBlock",
    "create_model",
    "init_variables",
    "param_count",
    "predict",
]
