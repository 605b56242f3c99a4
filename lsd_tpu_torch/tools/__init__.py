from .kitti import convert_kitti_odometry, convert_kitti_raw_oxts
