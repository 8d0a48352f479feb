from .logger import Logger, MovingAverage
from .seed import set_random_seed

__all__ = ["Logger", "MovingAverage", "set_random_seed"]
