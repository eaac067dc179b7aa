"""Training of the port: state, step, optimizer groups, schedules, EMA, early stop
(and ``evolve``, hyperparameter evolution, imported as its module)."""
from .ema import EMAState, ema_init, ema_update, ema_weights
from .optimizer import (
    NOMINAL_BATCH,
    RuntimeOptimizer,
    accumulation_steps,
    parameter_groups,
)
from .schedules import host_schedule, linear_schedule, make_lr_schedule, one_cycle_cosine
from .trainer import (
    EarlyStopping,
    TrainState,
    create_train_state,
    fitness,
    make_train_step,
    set_dropout_generator,
    step_generator,
)

__all__ = [
    "EMAState", "ema_init", "ema_update", "ema_weights",
    "NOMINAL_BATCH", "RuntimeOptimizer", "accumulation_steps", "parameter_groups",
    "host_schedule", "linear_schedule", "make_lr_schedule", "one_cycle_cosine",
    "EarlyStopping", "TrainState", "create_train_state", "fitness", "make_train_step",
    "set_dropout_generator", "step_generator",
]
