from .lidar import ransac_ground_plane, lidar_ground_calibration, heading_calibration
from .trajectory import align_trajectories, hand_eye_calibration
from .camera import calibrate_camera_intrinsics, solve_pnp, homography_dlt
