"""UDP output receivers (reference tools/recv_sample parity)
(a copy of ``lsd_tpu/tools/recv.py`` for the port).

The reference ships C++ samples that receive the runtime's UDP outputs
(tools/recv_sample/recv_detection_udp.cpp, recv_localization_udp.cpp).
These are the same consumers in Python: decode protobuf Detection frames
from UdpSink, and GPCHC localization sentences from the localization
output path.

Usage:
    python -m lsd_tpu_torch.tools.recv detection --port 9000
    python -m lsd_tpu_torch.tools.recv localization --port 9001
"""
from __future__ import annotations

import argparse
import socket
import sys
from typing import Optional


def recv_detection(port: int, host: str = "0.0.0.0",
                   max_frames: Optional[int] = None) -> int:
    from ..proto.detection import parse_detection
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    n = 0
    while max_frames is None or n < max_frames:
        data, addr = sock.recvfrom(1 << 20)
        try:
            msg = parse_detection(data)
        except Exception as e:
            print(f"[{addr[0]}] undecodable frame ({len(data)} B): {e}",
                  file=sys.stderr)
            continue
        objs = msg.get("object", [])
        hdr = msg.get("header", {})
        print(f"ts={hdr.get('timestamp', 0)} objects={len(objs)} "
              + " ".join(f"#{o.get('id')}:{o.get('type')}"
                         f"@({o.get('box', {}).get('center', {}).get('x', 0):.1f},"
                         f"{o.get('box', {}).get('center', {}).get('y', 0):.1f})"
                         for o in objs[:8]))
        n += 1
    return n


def recv_localization(port: int, host: str = "0.0.0.0",
                      max_frames: Optional[int] = None) -> int:
    from ..io.gpchc import parse_gpchc
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    n = 0
    while max_frames is None or n < max_frames:
        data, addr = sock.recvfrom(4096)
        for line in data.decode(errors="replace").splitlines():
            fix = parse_gpchc(line)
            if fix is None:
                continue
            print(f"lat={fix['latitude']:.7f} lon={fix['longitude']:.7f} "
                  f"alt={fix['altitude']:.2f} hdg={fix['heading']:.2f} "
                  f"status={fix['Status']}")
            n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("kind", choices=["detection", "localization"])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)
    fn = recv_detection if args.kind == "detection" else recv_localization
    fn(args.port, args.host, args.max_frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
