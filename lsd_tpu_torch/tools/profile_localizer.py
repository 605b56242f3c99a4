"""Where the time of the localization path goes on the card.

    python -m lsd_tpu_torch.tools.profile_localizer [--scans 40] [--out profile_localizer_out]

Maps ``profile_lio.mapping_run``'s 95 scans with ``Mapper`` (untraced),
saves the map, and gives ``Localizer`` on that directory, with
``LocalizerConfig()`` defaults, the drive of ``profile_lio.localization_drive``
(32,768-point scans from rest, the side LIO running): a pose hint, 24 scans
untraced (initialisation and the side LIO's warm-up), then ``--scans``
scans, of which all but the last six run under ``torch.profiler`` (host and
device) and the last six have their host syncs counted.  It prints, and
writes as JSON:

- wall ms per ``process_scan`` (host clock, ending in a synchronize), the
  device's busy ms and its idle share, kernel launches per scan;
- each ``localizer/*`` and ``lio_step/*`` span's calls per scan, host ms and
  kernel launches, per scan and per call: ``localizer/lio_increment``,
  ``localizer/track_step`` (with ``.../ukf_predict``, ``.../ndt_align``,
  ``.../icp_refine``, ``.../ukf_correct`` inside it), ``localizer/fetch``,
  ``localizer/build_local_map``, ``localizer/relocalize``;
- the kernels and the host-side operators that take the most time;
- the host syncs of the last six scans by source line, split into scans
  that recentred the local map and the others;
- statuses, recentres and the position RMSE against the simulator's truth.

It needs a card; it has no CPU path.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..slam.localization import Localizer, LocalizerConfig
from ..slam.mapper import Mapper
from ..utils.device import resolve_device
from .profile_lio import (_card, drive_localizer, localization_drive, mapping_run, sync_sites,
                          trace_report)

SPANS = ("lio_step/", "localizer/")
WARM = 24


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--out", default="profile_localizer_out")
    args = ap.parse_args(argv)
    if args.scans <= 6:
        ap.error("--scans must be at least 7")
    dev = resolve_device(None)

    sim, data, nav0, mcfg = mapping_run(dev)
    cap = data[0][0].shape[0]
    mapper = Mapper(mcfg, nav0)
    for k, d in enumerate(data):
        mapper.process_scan(*d[:5], stamp_us=int(k * 1e5))
    n_all = WARM + args.scans
    drive, scans, hint = localization_drive(sim, n_all, cap)
    truth = np.stack([s[5][:3, 3] for s in scans])
    with tempfile.TemporaryDirectory() as tmp:
        mapper.save(tmp)
        loc = Localizer(tmp, LocalizerConfig(), device=dev)
    loc.set_init_pose(hint)
    recentres = []
    build = loc._build_local_map
    loc._build_local_map = lambda c: (recentres.append(len(outs)), build(c))[1]

    outs = []
    for _, out in drive_localizer(loc, drive, scans[:WARM]):
        outs.append(out)
    torch.cuda.synchronize()
    n = args.scans - 6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, out in drive_localizer(loc, drive, scans[:WARM + n], first=WARM):
            outs.append(out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    syncs = {"recentre": [], "other": []}
    sites_all = {}
    feed = drive_localizer(loc, drive, scans, first=WARM + n)
    for k in range(WARM + n, n_all):
        before = len(recentres)
        (_, out), sites = sync_sites(lambda: next(feed))
        outs.append(out)
        syncs["recentre" if len(recentres) > before else "other"].append(sum(sites.values()))
        for site, c in sites.items():
            sites_all[site] = sites_all.get(site, 0) + c
    err = np.asarray([np.linalg.norm(o["pose"][:3, 3] - truth[k]) if o["pose"] is not None
                      else np.nan for k, o in enumerate(outs)])
    report = dict(card=_card(), warm_scans=WARM, scans=n, points_per_scan=cap,
                  **trace_report(prof, n, wall, SPANS),
                  host_syncs_per_scan={k: (float(np.mean(v)) if v else None)
                                       for k, v in syncs.items()},
                  host_sync_sites_over_6_scans=sites_all,
                  statuses={s: [o["status"] for o in outs].count(s)
                            for s in {o["status"] for o in outs}},
                  recentres_at_scans=recentres, keyframes=len(loc.store),
                  rmse_m=float(np.sqrt(np.nanmean(err[3:] ** 2))))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile_localizer.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
