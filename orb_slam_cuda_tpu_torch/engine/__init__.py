from .system import System, SystemConfig, Sensor  # noqa: F401
