from .config import DEFAULTS, load_config
from .metrics import MetricsWriter

__all__ = ["DEFAULTS", "load_config", "MetricsWriter"]
