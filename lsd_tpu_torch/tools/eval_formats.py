"""End-to-end real-format evaluation: reference-faithful sensor logs ->
format converters -> FULL runtime pipeline -> ATE (counterpart of
``lsd_tpu/tools/eval_formats.py``; the pipeline runs on the card unless
``--device`` names another).

The reference validates on real recordings (demo pickles README.md:87-92,
NCLT/ULHK rosbags docs/slam.md:217-233).  With no network egress in this
environment, this harness exercises the identical chain on
reference-faithful *files*: a genuine rosbag v2.0 with
sensor_msgs/PointCloud2 + Imu + NavSatFix messages, and an NCLT-format
``velodyne_hits.bin`` packet stream — written byte-for-byte in the public
formats, converted by the same tools a user would run
(``tools/rosbag.py rosbag_to_pkl``, ``tools/nclt.py convert_nclt``), then
replayed through the full Perception pipeline (Source -> SLAM -> Sink)
and scored against the generator's ground truth.

    python -m lsd_tpu_torch.tools.eval_formats [--scans 150] [--points 32768]
        [--device cpu]

Prints one markdown table + one JSON line:
    format | frames | ATE RMSE (m) | keyframes | wall s
"""
from __future__ import annotations

import argparse
import json
import os
import struct
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np

from ..geometry.utm import latlon_to_utm, utm_to_latlon
from ..sim import CircleSim, SimConfig
from ..utils.device import DeviceLike, resolve_device

# a replay ends when the SLAM engine's odometry has not grown for this long:
# the player re-emits its last frame at the end of a recording, so the
# pipeline never runs dry by itself
STALL_S = 20.0


# --------------------------------------------------------------------------
# export: write the sim as reference-faithful sensor logs


def export_rosbag(sim: CircleSim, data, path: str,
                  lat0: float = 42.0, lon0: float = -83.0) -> str:
    """Write a genuine rosbag v2.0: PointCloud2 per scan (xyzi, absolute
    stamps), 100 Hz sensor_msgs/Imu (rad/s + m/s^2), 10 Hz NavSatFix."""
    from .rosbag import (BagWriter, serialize_imu, serialize_navsatfix,
                         serialize_pointcloud2)
    cfg = sim.cfg
    period = 1.0 / cfg.scan_hz
    e0, n0, zone = latlon_to_utm(lat0, lon0)
    t_base_ns = 1_700_000_000 * 1_000_000_000
    with BagWriter(path) as bag:
        for k, (P, S, M, I, IM, T_gt) in enumerate(data):
            t0 = k * period
            stamp_ns = t_base_ns + int(t0 * 1e9)
            n = int(M.sum())
            pts = np.concatenate(
                [P[:n], np.zeros((n, 1), np.float32)], axis=1)
            bag.write("/velodyne_points", "sensor_msgs/PointCloud2",
                      stamp_ns,
                      serialize_pointcloud2(stamp_ns, pts, t_rel=S[:n]))
            for row in I[: int(IM.sum())]:
                i_ns = stamp_ns + int(float(row[0]) * 1e9)
                bag.write("/imu_raw", "sensor_msgs/Imu", i_ns,
                          serialize_imu(i_ns, [float(v) for v in row[1:4]],
                                        [float(v) * 9.81 for v in row[4:7]]))
            # NavSatFix from the GT position AT THE FIX STAMP (scan
            # start); T_gt is the scan-END pose — using it here would
            # bake a period-long time offset into every prior
            _R0, p0 = sim.pose(t0)
            x, y = float(p0[0]), float(p0[1])
            lat, lon = utm_to_latlon(float(e0) + x, float(n0) + y, zone)
            bag.write("/gps", "sensor_msgs/NavSatFix", stamp_ns,
                      serialize_navsatfix(stamp_ns,
                                          float(np.ravel(lat)[0]),
                                          float(np.ravel(lon)[0]), 0.0,
                                          status=2))
    return path


NCLT_MAGIC = 0xAD9CAD9C


def export_nclt(sim: CircleSim, data, out_dir: str) -> Tuple[str, str]:
    """Write NCLT-format velodyne_hits.bin (magic-framed packets of
    5 mm-quantized u16 xyz + intensity, tools/nclt.py iter_velodyne_hits)
    plus an ms25 IMU csv (utime, mag3, accel3 m/s^2, gyro3 rad/s)."""
    os.makedirs(out_dir, exist_ok=True)
    hits_path = os.path.join(out_dir, "velodyne_hits.bin")
    ms25_path = os.path.join(out_dir, "ms25.csv")
    cfg = sim.cfg
    period = 1.0 / cfg.scan_hz
    t_base_us = 1_700_000_000 * 1_000_000
    with open(hits_path, "wb") as f:
        for k, (P, S, M, I, IM, T_gt) in enumerate(data):
            n = int(M.sum())
            # several packets per revolution like the real logger
            for c in np.array_split(np.arange(n), 8):
                if not len(c):
                    continue
                utime = t_base_us + int((k * period + float(S[c[0]])) * 1e6)
                pts = P[c]
                q = np.clip((pts + 100.0) / 0.005, 0, 65535).astype("<u2")
                inten = np.full((len(c), 1), 128, np.uint8)
                rows = np.concatenate(
                    [q.view(np.uint8).reshape(len(c), 6), inten,
                     np.zeros((len(c), 1), np.uint8)], axis=1)
                f.write(struct.pack("<IIQI", NCLT_MAGIC, len(c), utime, 0))
                f.write(rows.tobytes())
    rows = []
    for k, (_P, _S, _M, I, IM, _T) in enumerate(data):
        for row in I[: int(IM.sum())]:
            utime = t_base_us + int((k * period + float(row[0])) * 1e6)
            rows.append([utime, 0, 0, 0,
                         float(row[4]) * 9.81, float(row[5]) * 9.81,
                         float(row[6]) * 9.81,
                         float(row[1]), float(row[2]), float(row[3])])
    np.savetxt(ms25_path, np.asarray(rows), delimiter=",")
    return hits_path, ms25_path


# --------------------------------------------------------------------------
# replay: full pipeline over a converted recording


def replay_and_score(rec_dir: str, sim: CircleSim, gts: List[np.ndarray],
                     warmup: int = 20, timeout_s: float = 600.0,
                     gt_ts_us: Optional[List[int]] = None,
                     device: DeviceLike = None) -> dict:
    """Run Source -> SLAM -> Sink over the recording on ``device`` (the
    card unless the caller asks for the CPU) and ATE the SLAM odometry
    against ground truth (aligned at the post-warmup pose, like
    tools/evaluate).  With ``gt_ts_us``, estimates pair with ground truth
    by TIMESTAMP (nearest within half a scan period) — required when the
    converter's frame boundaries drop/merge frames (e.g. NCLT packet
    framing), where index pairing would skew meters of apparent error.

    The replay ends when the engine has taken every frame of the recording
    (at most ``len(gts)``), or after STALL_S without a new one.  (The
    reference waits for ``len(gts)`` poses, which a converter that drops
    frames never delivers, so it always ends on the stall there.)  Besides
    the reference's keys, ``integrated`` counts the scans the SLAM engine
    took and ``busy_s`` is the time from the start to its last one."""
    from ..io.player import FramePlayer
    from ..runtime import clear_interfaces
    from ..runtime.perception import Perception

    clear_interfaces()
    p = Perception(device=resolve_device(device))
    cfg = p.get_config()
    cfg["pipeline"] = [["Source", "SLAM", "Sink"]]
    cfg["input"]["mode"] = "offline"
    cfg["input"]["data_path"] = rec_dir
    cfg["slam"]["mode"] = "mapping"
    cfg["slam"]["resolution"] = 0.4
    cfg["slam"]["key_frames_interval"] = [1.5, 0.3]
    # the sink's recorder makes its root even with recording off
    cfg["system"]["record"]["path"] = os.path.join(tempfile.gettempdir(), "lsd_tpu_records")
    p.config_manager.set_config(cfg)
    p.setup()
    eng = p.module_manager.modules["SLAM"].engine
    t0 = time.time()
    p.start()
    n_target = min(len(gts), len(FramePlayer(rec_dir)))
    last, stall_t = -1, time.time()
    while time.time() - t0 < timeout_s and len(eng.odometry) < n_target:
        time.sleep(0.5)
        if len(eng.odometry) != last:
            last, stall_t = len(eng.odometry), time.time()
        elif time.time() - stall_t > STALL_S:
            break       # player at end-of-data re-emits the last frame
    wall, busy = time.time() - t0, stall_t - t0
    odom = list(eng.odometry)
    kf = len(eng.store)
    p.pause()
    p.release()
    clear_interfaces()
    if gt_ts_us is not None:
        # pair each estimate with the gt scan whose START stamp is
        # nearest the frame's stamp (both are scan-END poses of that scan)
        period_us = int(1e6 / sim.cfg.scan_hz)
        gt_arr = np.asarray(gt_ts_us, np.int64)
        pairs = []
        seen = set()
        for ts, T in odom:
            k = int(np.argmin(np.abs(gt_arr - int(ts))))
            if k in seen or abs(int(gt_arr[k]) - int(ts)) > period_us // 2:
                continue
            seen.add(k)
            pairs.append((k, T))
        pairs.sort()
        est = [T for (_k, T) in pairs]
        gts = [gts[k] for (k, _T) in pairs]
        n = len(est)
    else:
        est = [T for (_ts, T) in odom]
        n = min(len(est), len(gts))
    if n <= warmup + 5:
        return dict(ate=float("nan"), frames=n, keyframes=kf, wall=wall,
                    integrated=len(odom), busy_s=busy)
    est = est[:n]
    E = np.stack(est[warmup:n])
    G = np.stack(gts[warmup:n])
    # align at the first post-warmup pose (cold start drifts the origin)
    A = G[0] @ np.linalg.inv(E[0])
    E = np.einsum("ij,njk->nik", A, E)
    err = np.linalg.norm(E[:, :3, 3] - G[:, :3, 3], axis=1)
    return dict(ate=float(np.sqrt(np.mean(err ** 2))), frames=n,
                keyframes=kf, wall=wall, integrated=len(odom), busy_s=busy)


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scans", type=int, default=150)
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the pipeline (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    work = args.workdir or tempfile.mkdtemp(prefix="lsd_fmt_")
    # cold-start protocol matching tools/evaluate: rest (IMU-at-rest
    # init), ramp to cruise — a cold filter cannot lock onto an
    # instant-motion trajectory, real recordings start at rest too
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=args.scans,
                              points_per_scan=args.points, seed=33,
                              point_noise=0.01,
                              rest_time=1.5, ramp_time=1.0))
    cap = 1 << int(np.ceil(np.log2(args.points)))
    data = sim.generate(capacity=cap, imu_capacity=16)
    gts = [d[5] for d in data]

    rows = []

    # ---- rosbag chain -------------------------------------------------
    from .rosbag import rosbag_to_pkl
    bag = export_rosbag(sim, data, os.path.join(work, "seq.bag"))
    print(f"# rosbag: {bag} ({os.path.getsize(bag) / 1e6:.1f} MB)")
    rec = rosbag_to_pkl(bag, os.path.join(work, "rec_bag"))
    period_us = int(1e6 / sim.cfg.scan_hz)
    gt_ts = [1_700_000_000 * 1_000_000 + k * period_us
             for k in range(len(gts))]
    r = replay_and_score(rec, sim, gts, gt_ts_us=gt_ts, device=device)
    rows.append(("rosbag(PointCloud2+Imu+NavSatFix)", r))
    print(f"# rosbag replay: {r}")

    # ---- NCLT chain ----------------------------------------------------
    from .nclt import convert_nclt
    hits, ms25 = export_nclt(sim, data, os.path.join(work, "nclt"))
    print(f"# nclt: {hits} ({os.path.getsize(hits) / 1e6:.1f} MB)")
    rec2 = convert_nclt(hits, os.path.join(work, "rec_nclt"),
                        ms25_csv=ms25)
    r2 = replay_and_score(rec2, sim, gts, gt_ts_us=gt_ts, device=device)
    rows.append(("nclt(velodyne_hits.bin+ms25)", r2))
    print(f"# nclt replay: {r2}")

    print("| format | frames | ATE RMSE (m) | keyframes | wall s |")
    print("|---|---|---|---|---|")
    for name, rr in rows:
        print(f"| {name} | {rr['frames']} | {rr['ate']:.4f} | "
              f"{rr['keyframes']} | {rr['wall']:.1f} |")
    print(json.dumps({"metric": "format_chain_ate_rmse_m",
                      "rosbag": round(rows[0][1]["ate"], 4),
                      "nclt": round(rows[1][1]["ate"], 4)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
