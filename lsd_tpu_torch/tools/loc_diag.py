"""Per-frame instrumented localization replay — LIO-fusion debugging
(counterpart of ``lsd_tpu/tools/loc_diag.py``; the localizer runs on the
card unless ``--device`` names another).

Drives the Localizer directly (no pipeline threads) over an existing
loc_eval recording + saved map, mirroring SlamModule's localization-mode
input prep (runtime/modules.py localization branch), and logs per-frame:

  - published pose error vs ground truth (x / y / heading)
  - side-LIO increment error vs the ground-truth body-frame increment
    (the decisive signal: is the LIO odometry itself drifting, or is the
    filter mis-weighting good increments?)
  - whether the increment passed the warm-up/consistency gates
  - NDT matched fraction / tracking status

Usage:
  python -m lsd_tpu_torch.tools.loc_diag --map <map_dir> --rec <loc_eval rec dir> \
      --lio-fusion [--frames N] [--out loc_diag.jsonl] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import time

import numpy as np

from ..utils.device import DeviceLike, resolve_device


def _prep_inputs(d, frame, eng):
    """Replicate runtime/modules.py localization-mode input prep
    (``SlamModule._process_localization``)."""
    from ..runtime.modules import _relative_imu
    gyro = acc = gps = None
    if frame.imu is not None and frame.imu.mask.any():
        last = np.asarray(frame.imu.data)[int(frame.imu.mask.sum()) - 1]
        gyro, acc = last[1:4], last[4:7]
    ins = d.get("ins_data") or {}
    gps_var = 4.0
    ins_yaw = None
    if d.get("ins_valid") and ins.get("latitude") \
            and int(ins.get("Status", 0)) != 0:
        gps = eng.project_fix(float(ins["latitude"]),
                              float(ins["longitude"]),
                              float(ins.get("altitude", 0.0)))
        if ins.get("heading") is not None:
            ins_yaw = float(np.deg2rad(90.0 - float(ins.get("heading") or 0.0)))
        gps_var = {42: 0.25, 52: 1.0}.get(int(ins.get("Status", 0)), 4.0)
    imu_rel = imu_mask_l = None
    if frame.imu is not None:
        imu_rel = _relative_imu(frame.imu.data, frame.scan.timestamp).astype(np.float32)
        imu_mask_l = frame.imu.mask
    return dict(imu_gyro=gyro, imu_acc=acc, gps_xyz=gps, gps_var=gps_var,
                ins_yaw=ins_yaw, stamps=frame.scan.stamps, imu=imu_rel,
                imu_mask=imu_mask_l)


def run(map_dir, rec_root, lio_fusion=True, max_frames=None, out=None,
        progress=print, device: DeviceLike = None):
    """Drive a ``Localizer`` on ``device`` (the card unless the caller asks
    for the CPU) over the first ``max_frames`` frames of the recording;
    returns (per-frame rows, summary)."""
    from ..io.frame import frame_from_dict
    from ..slam.localization import Localizer, LocalizerConfig

    z = np.load(os.path.join(rec_root, "gt.npz"))
    log_dir = str(z["log_dir"])
    gt = {int(t): T for t, T in zip(z["ts_us"], z["gt"])}
    paths = sorted(glob.glob(os.path.join(log_dir, "*.pkl")))
    if max_frames:
        paths = paths[:max_frames]

    loc = Localizer(map_dir, LocalizerConfig(use_lio_odometry=lio_fusion),
                    device=resolve_device(device))

    # capture side-LIO increments + gate decisions
    diag = {}
    orig_inc = loc._lio_increment

    def tapped_inc(points, stamps, mask, imu, imu_mask):
        prev = (np.asarray(loc._lio_prev, float).copy()
                if getattr(loc, "_lio_state", None) is not None else None)
        inc = orig_inc(points, stamps, mask, imu, imu_mask)
        cur = (np.asarray(loc._lio_prev, float).copy()
               if getattr(loc, "_lio_state", None) is not None else None)
        diag["lio_prev"] = prev
        diag["lio_cur"] = cur
        diag["inc"] = inc
        return inc
    loc._lio_increment = tapped_inc

    rows = []
    t0 = time.time()
    gt_prev = None
    for k, path in enumerate(paths):
        with open(path, "rb") as fh:
            d = pickle.load(fh)
        frame = frame_from_dict(d)
        if frame.scan is None:
            continue
        diag.clear()
        kw = _prep_inputs(d, frame, loc)
        out_d = loc.process_scan(frame.scan.points[:, :3], frame.scan.mask,
                                 stamp_us=frame.scan.timestamp, **kw)
        ts = int(frame.scan.timestamp)
        g = gt.get(ts)
        row = dict(k=k, t=round((ts - 1_000_000) / 1e6, 2),
                   status=out_d.get("status"),
                   matched=round(float(out_d.get("matched_frac", -1)), 3),
                   inc_used=diag.get("inc") is not None,
                   gps=kw["gps_xyz"] is not None)
        sd = getattr(loc, "last_step_diag", None)
        if sd is not None and out_d.get("status") == "tracking":
            row.update({k2: (round(v, 3) if isinstance(v, float) else v)
                        for k2, v in sd.items()})
        if g is not None and out_d.get("pose") is not None:
            T = np.asarray(out_d["pose"], float)
            dxy = T[:3, 3] - g[:3, 3]
            yaw_e = np.degrees(np.arctan2(T[1, 0], T[0, 0])
                               - np.arctan2(g[1, 0], g[0, 0]))
            yaw_e = (yaw_e + 180.0) % 360.0 - 180.0
            row.update(ex=round(float(dxy[0]), 3), ey=round(float(dxy[1]), 3),
                       eh=round(float(yaw_e), 2))
        # side-LIO increment vs GT body-frame increment
        if g is not None and gt_prev is not None \
                and diag.get("lio_prev") is not None \
                and diag.get("lio_cur") is not None:
            dT_lio = np.linalg.inv(diag["lio_prev"]) @ diag["lio_cur"]
            dT_gt = np.linalg.inv(gt_prev) @ g
            dd = np.linalg.inv(dT_gt) @ dT_lio
            ang = np.degrees(np.arccos(np.clip(
                (np.trace(dd[:3, :3]) - 1) / 2, -1, 1)))
            row.update(
                inc_et=round(float(np.linalg.norm(dd[:3, 3])), 4),
                inc_er=round(float(ang), 3),
                lio_step=round(float(np.linalg.norm(dT_lio[:3, 3])), 3),
                gt_step=round(float(np.linalg.norm(dT_gt[:3, 3])), 3))
        gt_prev = g if g is not None else gt_prev
        rows.append(row)
        if k % 100 == 0:
            progress(f"loc_diag: {k}/{len(paths)} "
                     f"({time.time() - t0:.0f}s) {row}")

    if out:
        with open(out, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")

    # summary
    scored = [r for r in rows if "ex" in r]
    tracked = [r for r in scored if r["status"] == "tracking"]
    inc_rows = [r for r in rows if "inc_et" in r]
    used = [r for r in rows if r.get("inc_used")]
    summ = dict(
        frames=len(rows), scored=len(scored), tracked=len(tracked),
        inc_used=len(used), wall_s=round(time.time() - t0, 1),
        rmse_x=round(float(np.sqrt(np.mean(
            [r["ex"] ** 2 for r in scored]))), 3) if scored else None,
        rmse_y=round(float(np.sqrt(np.mean(
            [r["ey"] ** 2 for r in scored]))), 3) if scored else None,
        rmse_h=round(float(np.sqrt(np.mean(
            [r["eh"] ** 2 for r in scored]))), 3) if scored else None,
        inc_et_mean=round(float(np.mean(
            [r["inc_et"] for r in inc_rows])), 4) if inc_rows else None,
        inc_et_p95=round(float(np.percentile(
            [r["inc_et"] for r in inc_rows], 95)), 4) if inc_rows else None,
        inc_er_mean=round(float(np.mean(
            [r["inc_er"] for r in inc_rows])), 3) if inc_rows else None,
    )
    progress(f"loc_diag summary: {json.dumps(summ)}")
    return rows, summ


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", required=True)
    ap.add_argument("--rec", required=True)
    ap.add_argument("--lio-fusion", action="store_true")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the localizer (default: the card)")
    args = ap.parse_args(argv)
    _, summ = run(args.map, args.rec, args.lio_fusion, args.frames, args.out,
                  device=args.device)
    print(json.dumps(summ, indent=2))


if __name__ == "__main__":
    main()
