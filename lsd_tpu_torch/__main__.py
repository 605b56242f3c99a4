"""CLI: boot the perception pipeline + web API, or replay a recording
headless (the counterpart of ``python -m lsd_tpu``).

    python -m lsd_tpu_torch run [--config cfg.yaml] [--data <recording_dir>]
        [--host H] [--port P] [--device cpu]
    python -m lsd_tpu_torch replay --data <recording_dir> [--slam]
        [--duration S] [--config cfg.yaml] [--device cpu]

``run`` builds ``Perception`` from the YAML config (``input.mode: online``
captures the configured LiDARs, INS and radar live), serves the web API on
``--host``/``--port`` (0 picks a free port) and the upgrade service on the
web port + 500, prints one line with the port and serves until
interrupted.  The device stages run on the card unless ``--device`` names
another; without a card and without ``--device`` both commands raise.
"""
from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Optional

import numpy as np


def start_system(config: Optional[str] = None, data: Optional[str] = None,
                 host: str = "0.0.0.0", port: int = 1234, device=None):
    """What ``run`` starts, in this process: ``Perception`` on ``device``
    (set up and started), the web API on ``host``:``port`` and the upgrade
    service on the web port + 500 (None where that port cannot be bound, as
    in the reference).  Returns (perception, server, upgrade, web port)."""
    from .runtime.perception import Perception
    from .web import PerceptionServer, UpgradeServer

    p = Perception(config, device=device)
    if data:
        cfg = p.get_config()
        cfg["input"]["data_path"] = data
        p.config_manager.set_config(cfg)
    p.setup()
    p.start()
    srv = PerceptionServer(p)
    port = srv.start(host=host, port=port)
    # upgrade daemon on web-port+500 (ref web_ui rpc/http-upgrade.ts PORT)
    upgrade = UpgradeServer()
    try:
        upgrade.start(host=host, port=port + 500)
    except (OSError, OverflowError):    # taken, or past 65535 (a web port above 65035)
        upgrade = None
    return p, srv, upgrade, port


def stop_system(p, srv, upgrade) -> None:
    """Stop what ``start_system`` started."""
    srv.stop()
    if upgrade:
        upgrade.stop()
    p.release()


def cmd_run(args) -> int:
    p, srv, upgrade, port = start_system(args.config, args.data, args.host, args.port,
                                         args.device)
    print(f"lsd_tpu_torch serving on {args.host}:{port}", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        stop_system(p, srv, upgrade)
    return 0


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
    ap = argparse.ArgumentParser(prog="lsd_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="the pipeline behind the web API")
    run.add_argument("--config", default=None)
    run.add_argument("--data", default=None)
    run.add_argument("--host", default="0.0.0.0")
    run.add_argument("--port", type=int, default=1234)
    run.add_argument("--device", default=None,
                     help="torch device of the SLAM and detection stages "
                          "(default: the card)")
    run.set_defaults(fn=cmd_run)

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
