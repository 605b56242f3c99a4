"""Configuration system: YAML tree -> attribute dict, change classification.

A copy of ``lsd_tpu/runtime/config.py`` for the port, with ``yaml``
imported only where a file is read or written (the card's machine has no
``yaml``; ``import lsd_tpu_torch.runtime.config`` needs none).

Re-derivation of module/config_manager.py semantics:
- single YAML tree (cfg/board_cfg_all.yaml shape) loaded into an
  attribute-accessible dict,
- ``check_config`` diffs a proposed config against the active one and
  classifies the change as Success (hot-applicable), Reset (pipeline
  restart) or Reboot (process restart) (config_manager.py:35-53),
- atomic dump with fsync (:108-118),
- offline mode overlays the recording's cfg.yaml (:61-95).
"""
from __future__ import annotations

import copy
import enum
import os
import tempfile
from typing import Any, Dict, Optional


class AttrDict(dict):
    """dict with attribute access, recursively (EasyDict equivalent)."""

    def __init__(self, d: Optional[Dict] = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def to_dict(self) -> Dict:
        def unwrap(v):
            if isinstance(v, AttrDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v
        return unwrap(self)


class CheckResult(enum.Enum):
    SUCCESS = "Success"    # applies without restart
    RESET = "Reset"        # pipeline modules must be rebuilt
    REBOOT = "Reboot"      # process restart required


# keys whose change forces a full reboot (ref check_config: board, system-level)
REBOOT_KEYS = ("board", "system")
# keys whose change rebuilds the pipeline (sensors/pipeline topology)
RESET_KEYS = ("pipeline", "lidar", "camera", "radar", "ins", "detection", "slam", "input")


DEFAULT_CONFIG: Dict[str, Any] = dict(
    board=dict(name="tpu-dev", network=[]),
    input=dict(mode="offline", data_path=""),
    pipeline=[["Source", "SLAM", "Sink"]],
    lidar=[], camera=[], radar=[],
    ins=dict(use=False, extrinsic_parameters=[0, 0, 0, 0, 0, 0],
             imu_extrinsic_parameters=[0, 0, 0, 0, 0, 0]),
    # capacity "reference" = the ±64 m / 0.2 m-pillar / 640² class the
    # reference deploys (cfgs/detection_object.yaml) — it is the default
    # because trained weights ship for it (weights/detector_refcap.msgpack);
    # enable=true therefore works out of the box with a trained model.
    detection=dict(enable=False, score_threshold=[0.3, 0.35, 0.35],
                   accum_frames=2, weights="", capacity="reference",
                   # camera mono3D beside the lidar engine, late-fused
                   # (ref docs/detect.md:70 mono3D RTM3D on DLA)
                   mono3d=dict(enable=False, weights="", camera=None,
                               score_threshold=0.3)),
    trafficlight=dict(enable=False, weights="", lights=[], camera=None),
    slam=dict(mode="mapping", method="FastLIO",
              map_path="", resolution=0.5,
              key_frames_interval=[2.0, 0.2618],
              mapping=dict(key_frames_range=300.0)),
    output=dict(protocol=dict(UDP=dict(use=False, dest="127.0.0.1", port=19000),
                              CAN=dict(use=False)),
                point_cloud=dict(use=False),
                freespace=dict(use=False)),
    roi=[],
    system=dict(record=dict(use=False, path="/tmp/lsd_tpu_records",
                            frames_per_log=18000, max_logs=None)),
)


class ConfigManager:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path and os.path.exists(path):
            import yaml
            with open(path) as f:
                raw = yaml.safe_load(f) or {}
            merged = copy.deepcopy(DEFAULT_CONFIG)
            _deep_update(merged, raw)
            self.config = AttrDict(merged)
        else:
            self.config = AttrDict(copy.deepcopy(DEFAULT_CONFIG))

    # ------------------------------------------------------------------
    def check_config(self, new: Dict) -> CheckResult:
        cur = self.config.to_dict()
        new = AttrDict(new).to_dict()
        for k in REBOOT_KEYS:
            if cur.get(k) != new.get(k):
                return CheckResult.REBOOT
        for k in RESET_KEYS:
            if cur.get(k) != new.get(k):
                return CheckResult.RESET
        return CheckResult.SUCCESS

    def set_config(self, new: Dict) -> CheckResult:
        result = self.check_config(new)
        merged = copy.deepcopy(DEFAULT_CONFIG)
        _deep_update(merged, AttrDict(new).to_dict())
        self.config = AttrDict(merged)
        return result

    def overlay_recording_config(self, record_dir: str) -> None:
        """Offline mode: overlay sensor sections from the recording's
        cfg.yaml (ref set_extra_config :61-95)."""
        path = os.path.join(record_dir, "cfg.yaml")
        if not os.path.exists(path):
            return
        import yaml
        with open(path) as f:
            rec = yaml.safe_load(f) or {}
        cur = self.config.to_dict()
        for k in ("lidar", "camera", "radar", "ins"):
            if k in rec:
                cur[k] = rec[k]
        self.config = AttrDict(cur)

    def dump(self, path: Optional[str] = None) -> str:
        """Atomic write + fsync (ref dump_config :108-118)."""
        path = path or self.path
        assert path, "no config path"
        import yaml
        data = yaml.safe_dump(self.config.to_dict(), sort_keys=False)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".yaml")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path


def _deep_update(base: Dict, new: Dict) -> None:
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
