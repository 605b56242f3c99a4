"""Port parity for the comms layer: the LCM/ZCM wire format of
``comms/zcm_udpm.py`` in both directions (the port's encoder into the
reference's decoder and reassembler, and the reference's into the port's),
for short and fragmented messages; the UDP and ``ipc://`` transports
between the two packages; the typed messages (``imu_msg``,
``pointcloud_msg``, ``sniff_type``); and ``MessageServer``'s queries over
the same bus traffic.

Datagrams and payloads must be equal byte for byte; the message server's
answers equal as Python values.  Sockets bind port 0; the bus and the
``ipc://`` cores get names of their own per process.
"""
import os
import threading
import time

import numpy as np

from lsd_tpu.comms import bus as jbus
from lsd_tpu.comms import message_server as jms
from lsd_tpu.comms import messages as jmsg
from lsd_tpu.comms import zcm_ipc as jipc
from lsd_tpu.comms import zcm_udpm as judpm
from lsd_tpu_torch import comms as tcomms
from lsd_tpu_torch.comms import bus as tbus
from lsd_tpu_torch.comms import message_server as tms
from lsd_tpu_torch.comms import messages as tmsg
from lsd_tpu_torch.comms import zcm_ipc as tipc
from lsd_tpu_torch.comms import zcm_udpm as tudpm

PAYLOADS = [b"", b"\x01\x02\x03", bytes(range(256)) * 5,
            np.random.default_rng(0).integers(0, 256, 20_000, dtype=np.uint8).tobytes()]


def _reassemble(mod, grams, order=None):
    r = mod._Reassembler()
    out = None
    for k in (order or range(len(grams))):
        res = r.feed(("127.0.0.1", 7), mod.decode_datagram(grams[k]))
        if res is not None:
            out = res
    return out


def test_wire_format_both_ways():
    for enc, dec in ((tudpm, judpm), (judpm, tudpm)):
        for k, payload in enumerate(PAYLOADS):
            short = enc.encode_short(k, "slam.odometry", payload)
            assert short == dec.encode_short(k, "slam.odometry", payload)
            assert dec.decode_datagram(short) == ("short", k, "slam.odometry", payload)
            for mtu in (256, 1400):
                frags = enc.encode_fragments(2 ** 32 + k, "points", payload, mtu=mtu)
                assert frags == dec.encode_fragments(2 ** 32 + k, "points", payload, mtu=mtu)
                assert [dec.decode_datagram(f) for f in frags] == \
                    [enc.decode_datagram(f) for f in frags]
                assert _reassemble(dec, frags) == ("points", payload)
                assert _reassemble(dec, frags, list(reversed(range(len(frags))))) == \
                    ("points", payload)
    for junk in (b"", b"junk", b"\x00" * 30, b"LC03" + b"\x00" * 10):
        assert tudpm.decode_datagram(junk) == judpm.decode_datagram(junk)
    assert (tudpm.MAGIC_SHORT, tudpm.MAGIC_FRAG, tudpm.DEFAULT_GROUP, tudpm.DEFAULT_PORT) == \
        (judpm.MAGIC_SHORT, judpm.MAGIC_FRAG, judpm.DEFAULT_GROUP, judpm.DEFAULT_PORT)


def _receive(transport, n):
    got, done = [], threading.Event()

    def on(ch, payload):
        got.append((ch, payload))
        if len(got) >= n:
            done.set()
    return got, done, transport.start_receiver(on)


def test_udp_transport_between_packages():
    """Each package's transport publishes to the other's receiver (bound to
    port 0): a short message, a fragmented one and a bus bridged out."""
    for tx_mod, rx_mod, bus_mod in ((tudpm, judpm, tbus), (judpm, tudpm, jbus)):
        rx = rx_mod.ZcmUdpmTransport("udp:127.0.0.1:0")
        got, done, port = _receive(rx, 3)
        tx = tx_mod.ZcmUdpmTransport(f"udp:127.0.0.1:{port}")
        bus = bus_mod.MessageBus(bus=f"zcm_bridge_{os.getpid()}_{tx_mod.__name__[:10]}")
        sub = tx_mod.bridge_bus_to_udpm(bus, tx)
        try:
            tx.publish("imu_raw", b"hello")
            tx.publish("cloud", PAYLOADS[3])
            time.sleep(0.1)
            bus.publish("slam.nav", b"\x05\x06")
            assert done.wait(5.0), got
        finally:
            sub.close()
            tx.close()
            rx.close()
        assert sorted(got) == sorted([("imu_raw", b"hello"), ("cloud", PAYLOADS[3]),
                                      ("slam.nav", b"\x05\x06")])


def test_ipc_transport_between_packages():
    """``ipc://`` cores shared by the two packages: a subscriber of each
    receives what either publishes, fragmented messages too; the factory
    picks the transport by address."""
    core = f"ipc://torch_test_core_{os.getpid()}"
    subs = [tipc.ZcmIpcTransport(core), jipc.ZcmIpcTransport(core)]
    inbox = [_receive(s, 2)[:2] for s in subs]
    pubs = [tipc.ZcmIpcTransport(core), jipc.ZcmIpcTransport(core)]
    big = np.arange(150_000, dtype=np.uint32).tobytes()
    try:
        time.sleep(0.1)
        pubs[0].publish("slam.odometry", b"\x01hello")
        pubs[1].publish("points", big)
        for got, done in inbox:
            assert done.wait(5.0), got
            assert sorted(got) == [("points", big), ("slam.odometry", b"\x01hello")]
    finally:
        for t in pubs + subs:
            t.close()
    for mod in (tipc, jipc):
        t = mod.make_transport(core)
        assert type(t).__name__ == "ZcmIpcTransport"
        t.close()
        u = mod.make_transport("udp:127.0.0.1:0")
        assert type(u).__name__ == "ZcmUdpmTransport"
        u.close()


def test_typed_messages_match():
    rng = np.random.default_rng(1)
    T = np.eye(4)
    T[:3, 3] = rng.normal(size=3)
    pts = rng.normal(size=(300, 4)).astype(np.float32)
    for mod_a, mod_b in ((tmsg, jmsg),):
        for a, b in ((mod_a.imu_msg(5, [0.1, 0.2, 0.3], [0, 0, 1]),
                      mod_b.imu_msg(5, [0.1, 0.2, 0.3], [0, 0, 1])),
                     (mod_a.pointcloud_msg(6, pts), mod_b.pointcloud_msg(6, pts)),
                     (mod_a.pointcloud_msg(7, pts[:, :3], "top"),
                      mod_b.pointcloud_msg(7, pts[:, :3], "top")),
                     (mod_a.odometry_msg(8, T, vel=[1, 2, 3]),
                      mod_b.odometry_msg(8, T, [1, 2, 3]))):
            assert a == b
            assert mod_a.sniff_type(a) == mod_b.sniff_type(a) is not None
            assert mod_a.decode_typed(a) == mod_b.decode_typed(a)
    for junk in (b"", b"\x09abc", b"\x01\xff\xff\xff"):
        assert tmsg.sniff_type(junk) == jmsg.sniff_type(junk)
    assert tcomms.sniff_type is tmsg.sniff_type and tcomms.MessageServer is tms.MessageServer


def test_message_server_queries_match():
    """Both packages' ``MessageServer`` on one bus each, fed the same
    messages: meta, latest (formatted) and series answers equal; disabled
    servers buffer nothing."""
    answers = {}
    for name, bus_mod, ms_mod, msg_mod in (("jax", jbus, jms, jmsg), ("torch", tbus, tms, tmsg)):
        bus = bus_mod.MessageBus(bus=f"ms_{name}_{os.getpid()}")
        srv = ms_mod.MessageServer(bus, depth=5)
        time.sleep(0.1)
        T = np.eye(4)
        for k in range(8):
            T[0, 3] = float(k)
            bus.publish("slam.odometry", msg_mod.odometry_msg(k * 1000, T, vel=[k * 1.0, 0, 0]))
            bus.publish("lidar.points", msg_mod.pointcloud_msg(k, np.full((3, 4), k, np.float32)))
            bus.publish("junk", b"\xff\xff")
            time.sleep(0.01)
        deadline = time.time() + 3
        while time.time() < deadline and len(srv.get_series("slam.odometry", "twist.linear.x")) < 5:
            time.sleep(0.02)
        srv.set_enabled(False)
        bus.publish("imu", msg_mod.imu_msg(1, [0, 0, 1], [0, 0, 1]))
        time.sleep(0.1)
        answers[name] = (srv.get_meta(), srv.get_latest("slam.odometry"),
                         srv.get_latest("lidar.points"), srv.get_latest("nothing"),
                         srv.get_series("slam.odometry", "twist.linear.x"),
                         srv.get_series("slam.odometry", "pose.position.nope"))
        srv.close()
    assert answers["torch"] == answers["jax"]
    meta, odom, cloud, _, series, _ = answers["jax"]
    assert meta == {"slam.odometry": "Odometry", "lidar.points": "PointCloud"}
    assert series == [3.0, 4.0, 5.0, 6.0, 7.0] and cloud["points"][0] == [7.0, 7.0, 7.0]
