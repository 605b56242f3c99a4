from .post import PostProcessConfig, postprocess
from .tracker import Tracker3D, TrackerConfig
from .object_filter import ObjectFilter
