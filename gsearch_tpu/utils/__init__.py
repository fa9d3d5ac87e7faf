from .cache import enable_compilation_cache
from .device import device_profile
from .log import get_logger
from .timer import StageTimer
