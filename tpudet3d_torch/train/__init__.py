from .optim import (AVAILABLE_OPTIMS, AVAILABLE_SCHEDS, build_optimizer,
                    build_scheduler, current_learning_rate, set_learning_rate)
from .state import TrainState, create_train_state, eval_params, param_count
from .steps import make_eval_step, make_train_step
from .trainer import Trainer

__all__ = ['build_optimizer', 'build_scheduler', 'set_learning_rate',
           'current_learning_rate', 'AVAILABLE_OPTIMS', 'AVAILABLE_SCHEDS',
           'TrainState', 'create_train_state', 'param_count', 'eval_params',
           'make_train_step', 'make_eval_step', 'Trainer']
