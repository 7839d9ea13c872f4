from .state import MapState, MapConfig  # noqa: F401
from . import ops, keyframe_db  # noqa: F401
