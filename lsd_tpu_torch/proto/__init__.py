from .wire import encode_message, decode_message
from .detection import serialize_detection, parse_detection
from .internal import (serialize_pointcloud_map, serialize_keyframe,
                       parse_pointcloud_map)
