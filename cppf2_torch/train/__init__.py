from cppf2_torch.train.loop import (
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    tuple_loss,
)
from cppf2_torch.train.visual import (
    VisualModel,
    create_visual_train_state,
    make_visual_train_step,
)

__all__ = [
    "TrainState",
    "VisualModel",
    "create_train_state",
    "create_visual_train_state",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "make_visual_train_step",
    "tuple_loss",
]
