from .bus import MessageBus, Publisher, Subscriber
from .messages import (HEADER, IMU, NAVSATFIX, ODOMETRY, PATH, POINTCLOUD,
                       encode_typed, decode_typed, odometry_msg)
