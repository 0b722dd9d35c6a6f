"""Learning-rate schedules, D-Adaptation Adam and the EMA of weights."""
from .dadam import DAdaptAdam
from .ema import EMAState, ema_init, ema_params, ema_update
from .lr_schedulers import get_lr_scheduler
