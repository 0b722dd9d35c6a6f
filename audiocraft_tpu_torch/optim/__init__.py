"""Learning-rate schedules."""
from .lr_schedulers import get_lr_scheduler
