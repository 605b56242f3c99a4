"""CLI: headless replay of a recording through the port's pipeline.

    python -m lsd_tpu_torch replay --data <recording_dir> [--slam]
        [--duration S] [--config cfg.yaml] [--device cpu]

The counterpart of ``python -m lsd_tpu replay``.  The SLAM stage runs on
the card unless ``--device`` names another; without a card and without
``--device`` it raises.  The reference's ``run`` (the pipeline behind the
web API) needs the web server, which the port does not have yet (ROADMAP
A12c).
"""
from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np


def cmd_replay(args) -> int:
    """Headless offline replay through the pipeline (no web server)."""
    from .runtime.config import ConfigManager
    from .runtime.interface import call_interface, has_interface
    from .runtime.modules import PlayerSource, SinkModule, SlamModule
    from .runtime.pipeline import ModuleManager
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cm = ConfigManager(args.config)
    cm.config.input.data_path = args.data
    chain = ["Source", "SLAM", "Sink"] if args.slam else ["Source", "Sink"]
    cm.config.pipeline = [chain]
    mm = ModuleManager({"Source": PlayerSource,
                        "SLAM": functools.partial(SlamModule, device=device),
                        "Sink": SinkModule})
    mm.build(cm.config.pipeline, cm.config)
    mm.start()
    try:
        t0 = time.time()
        while time.time() - t0 < args.duration:
            time.sleep(2.0)
            st = mm.get_status()
            src = st["modules"]["Source"]
            line = f"frames={src['frames']}"
            if "SLAM" in st["modules"]:
                line += f" slam_frames={st['modules']['SLAM']['frames']}"
                engine = mm.modules["SLAM"].engine
                if hasattr(engine, "odometry"):
                    # scans integrated (the player re-emits its last frame
                    # at the end of the recording; those are not)
                    line += f" integrated={len(engine.odometry)}"
                if has_interface("slam.get_pose"):
                    p = np.asarray(call_interface("slam.get_pose"))[:3, 3]
                    line += " pose=[%.2f %.2f %.2f]" % (p[0], p[1], p[2])
            print(line, flush=True)
    finally:
        mm.stop()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="lsd_tpu_torch",
        epilog="'run' (the pipeline behind the web API) is not ported yet: "
               "ROADMAP A12c")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("replay", help="replay a recording through the pipeline")
    rep.add_argument("--config", default=None)
    rep.add_argument("--data", required=True)
    rep.add_argument("--slam", action="store_true")
    rep.add_argument("--duration", type=float, default=10.0)
    rep.add_argument("--device", default=None,
                     help="torch device of the SLAM stage (default: the card)")
    rep.set_defaults(fn=cmd_replay)

    args = ap.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
