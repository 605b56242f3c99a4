from .radar import Ars408Parser, RadarObject
from .can_sink import encode_can_frames, decode_can_obstacle_a
from .ins import InsMotionTracker
