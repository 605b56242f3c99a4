from .bus import MessageBus, Publisher, Subscriber
from .messages import (HEADER, IMU, NAVSATFIX, ODOMETRY, PATH, POINTCLOUD,
                       encode_typed, decode_typed, odometry_msg, sniff_type)
from .message_server import MessageServer
from .zcm_udpm import ZcmUdpmTransport, bridge_bus_to_udpm
