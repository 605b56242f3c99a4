"""Post-processing CLIs (counterpart of ``lsd_tpu/tools/postprocessing.py``:
the reference's tools/postprocessing/accumulate_cloud.py and
convert_map_pose.py on this framework's map and replay formats).

  accumulate-cloud   replay a recording along a saved trajectory and
                     accumulate the transformed clouds into one PCD
  convert-map-pose   dump a saved map's keyframe poses as a TUM-format
                     trajectory txt (timestamp x y z qx qy qz qw)

Usage:
  python -m lsd_tpu_torch.tools.postprocessing accumulate-cloud \
      -i <recording_dir> -p <map_dir> -o out.pcd [-r 0.1] [-d 200]
      [-zl -0.5] [-zh 100] [--device cpu]
  python -m lsd_tpu_torch.tools.postprocessing convert-map-pose \
      -i <map_dir> -o traj_tum.txt

The voxel downsample of ``accumulate-cloud -r`` runs on the card unless
``--device`` names another; everything else is host numpy.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.device import DeviceLike, resolve_device


def accumulate_cloud(data_path: str, pose_path: str, output: str,
                     resolution: float = 0.0, distance: float = 200.0,
                     z_min: float = -0.5, z_max: float = 100.0,
                     device: DeviceLike = None) -> str:
    """Accumulate a recording's scans along the saved map trajectory
    (ref accumulate_cloud.py: frame pickles + pose path -> one cloud).

    Frames are matched to keyframe poses by timestamp; between keyframes
    the pose is interpolated (nlerp on rotation).  A ``resolution`` above 0
    downsamples the cloud on ``device`` (the card unless the caller asks
    for the CPU)."""
    from ..geometry import np_so3
    from ..io.pcd import write_pcd
    from ..io.player import FramePlayer
    from ..io.frame import frame_from_dict
    from ..slam.map_io import load_map

    dev = resolve_device(device)
    md = load_map(pose_path)
    stamps = np.asarray(md["stamps"], np.int64)
    poses = np.asarray(md["poses"], float)
    order = np.argsort(stamps)
    stamps, poses = stamps[order], poses[order]

    player = FramePlayer(data_path)
    out = []
    for k in range(len(player)):
        d = player.read_dict(k)
        fr = frame_from_dict(d)
        if fr.scan is None:
            continue
        ts = fr.scan.timestamp
        i = int(np.searchsorted(stamps, ts))
        if i == 0 or i >= len(stamps):
            continue                      # outside the mapped span
        a = (ts - stamps[i - 1]) / max(stamps[i] - stamps[i - 1], 1)
        q0 = np_so3.matrix_to_quat(poses[i - 1][:3, :3])
        q1 = np_so3.matrix_to_quat(poses[i][:3, :3])
        if np.dot(q0, q1) < 0:
            q1 = -q1
        q = q0 * (1 - a) + q1 * a
        q = q / max(np.linalg.norm(q), 1e-9)
        T = np.eye(4)
        T[:3, :3] = np_so3.quat_to_matrix(q)
        T[:3, 3] = poses[i - 1][:3, 3] * (1 - a) + poses[i][:3, 3] * a
        pts = fr.scan.points[fr.scan.mask]
        r = np.linalg.norm(pts[:, :2], axis=1)
        keep = (r < distance) & (pts[:, 2] > z_min) & (pts[:, 2] < z_max)
        pts = pts[keep]
        pw = pts[:, :3] @ T[:3, :3].T + T[:3, 3]
        inten = pts[:, 3] if pts.shape[1] > 3 else np.zeros(len(pts))
        out.append(np.concatenate([pw, inten[:, None]], axis=1))
    cloud = np.concatenate(out, axis=0) if out else np.zeros((0, 4))
    if resolution > 0 and len(cloud):
        from ..ops.voxelize import voxel_downsample
        from ..utils.device import fetch, to_device
        cap = 1 << int(np.ceil(np.log2(max(len(cloud), 2))))
        buf = np.zeros((cap, 4), np.float32)
        buf[:len(cloud)] = cloud
        m = np.zeros(cap, bool)
        m[:len(cloud)] = True
        ds, dm = voxel_downsample(to_device(buf, dev), to_device(m, dev),
                                  resolution, cap)
        ds, dm = fetch(ds, dm)
        cloud = ds[dm]
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    write_pcd(output, cloud.astype(np.float32))
    return output


def convert_map_pose(map_dir: str, output: str) -> str:
    """Saved map graph -> TUM trajectory (ref convert_map_pose.py:
    'convert keyframe pose in graph to tum txt')."""
    from ..geometry import np_so3
    from ..slam.map_io import load_map

    md = load_map(map_dir)
    rows = []
    for s, T in sorted(zip(md["stamps"], md["poses"]), key=lambda x: x[0]):
        T = np.asarray(T, float)
        q = np_so3.matrix_to_quat(T[:3, :3])    # wxyz
        rows.append("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f"
                    % (int(s) / 1e6, T[0, 3], T[1, 3], T[2, 3],
                       q[1], q[2], q[3], q[0]))
    os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
    with open(output, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return output


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("accumulate-cloud")
    a.add_argument("-i", "--data_path", required=True)
    a.add_argument("-p", "--pose_path", required=True)
    a.add_argument("-o", "--output", required=True)
    a.add_argument("-r", "--resolution", type=float, default=0.0)
    a.add_argument("-d", "--distance", type=float, default=200.0)
    a.add_argument("-zl", "--z_min", type=float, default=-0.5)
    a.add_argument("-zh", "--z_max", type=float, default=100.0)
    a.add_argument("--device", default=None,
                   help="torch device of the downsample (default: the card)")
    c = sub.add_parser("convert-map-pose")
    c.add_argument("-i", "--input", required=True)
    c.add_argument("-o", "--output", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "accumulate-cloud":
        out = accumulate_cloud(args.data_path, args.pose_path, args.output,
                               args.resolution, args.distance,
                               args.z_min, args.z_max, device=args.device)
    else:
        out = convert_map_pose(args.input, args.output)
    print(out)


if __name__ == "__main__":
    main()
