from .config import load_settings, SettingsError  # noqa: F401
from .datasets import (  # noqa: F401
    KittiOdometryDataset,
    TumRgbdDataset,
    EurocDataset,
)
from .trajectory import save_trajectory_tum, save_trajectory_kitti  # noqa: F401
from .checkpoint import save_map, load_map  # noqa: F401
