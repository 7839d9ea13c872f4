"""Settings loading: the reference's per-dataset settings files, OpenCV
FileStorage YAML (torch port of orb_slam_cuda_tpu/io/config.py, with a
parser of its own in place of PyYAML).

Keys: Camera.fx/fy/cx/cy/k1..k3/p1/p2/bf/fps/width/height,
ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,minThFAST}, ThDepth,
DepthMapFactor, and `SLAM.<field>` for any scalar SystemConfig field.
"""

from __future__ import annotations

from dataclasses import fields as _fields

from ..engine.system import Sensor, SystemConfig
from ..geometry.camera import Camera


class SettingsError(ValueError):
    pass


def _scalar(text: str):
    """A flat YAML scalar: quoted string, bool, null, int, float, else the
    bare string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("", "~", "null"):
        return None
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def parse_opencv_yaml(text: str) -> dict:
    """Flat OpenCV FileStorage YAML -> dict: a `%YAML:1.0` header and `---`
    separators are skipped, `#` starts a comment (outside quotes), every
    other non-blank line is `key: value` with dotted keys kept whole."""
    out = {}
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.startswith("%YAML") or raw.startswith("---"):
            continue
        line, quote = [], None
        for ch in raw:
            if quote:
                quote = None if ch == quote else quote
            elif ch in "\"'":
                quote = ch
            elif ch == "#":
                break
            line.append(ch)
        line = "".join(line).strip()
        if not line:
            continue
        key, sep, value = line.partition(":")
        if not sep or not key.strip():
            raise SettingsError(f"line {n}: expected `key: value`, got {raw!r}")
        out[key.strip()] = _scalar(value.strip())
    return out


def load_settings(path: str, sensor: Sensor = Sensor.MONOCULAR, **overrides) -> SystemConfig:
    """Settings YAML -> SystemConfig (the Tracking constructor's parse)."""
    with open(path) as f:
        d = parse_opencv_yaml(f.read())

    def get(key, default=None, required=False):
        if key in d:
            return d[key]
        if required:
            raise SettingsError(f"missing required setting {key!r} in {path}")
        return default

    cam = Camera.create(
        fx=get("Camera.fx", required=True), fy=get("Camera.fy", required=True),
        cx=get("Camera.cx", required=True), cy=get("Camera.cy", required=True),
        k1=get("Camera.k1", 0.0), k2=get("Camera.k2", 0.0),
        p1=get("Camera.p1", 0.0), p2=get("Camera.p2", 0.0), k3=get("Camera.k3", 0.0),
        bf=get("Camera.bf", 0.0),
        width=int(get("Camera.width", required=True)),
        height=int(get("Camera.height", required=True)),
    )
    fps = get("Camera.fps", 30.0) or 30.0
    depth_map_factor = float(get("DepthMapFactor", 1.0))
    cfg = SystemConfig(
        camera=cam,
        sensor=sensor,
        n_features=int(get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(get("ORBextractor.nLevels", 8)),
        ini_th_fast=float(get("ORBextractor.iniThFAST", 20)),
        min_th_fast=float(get("ORBextractor.minThFAST", 7)),
        max_frames_between_kf=int(fps),
        th_depth_factor=float(get("ThDepth", 35.0)),
        depth_map_factor=1.0 / depth_map_factor if depth_map_factor != 0 else 1.0,
    )
    # `SLAM.<field>` sets the SystemConfig field of that name, coerced by
    # the field's DECLARED type (a None default must not decide it); fields
    # that a settings file cannot express (camera, sensor, mesh) raise.
    for f in _fields(SystemConfig):
        key = "SLAM." + f.name
        if key not in d:
            continue
        v = d[key]
        ftype = str(f.type).replace("typing.", "")
        if ftype in ("bool", "Optional[bool]"):
            v = bool(int(v))
        elif ftype in ("int", "Optional[int]"):
            v = int(v)
        elif ftype in ("float", "Optional[float]"):
            v = float(v)
        else:
            raise ValueError(
                f"{key}: SystemConfig field of type {ftype!r} cannot be "
                "set from a YAML settings file"
            )
        setattr(cfg, f.name, v)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
