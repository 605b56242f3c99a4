"""Board network configuration: validation + nmcli plan
(a copy of ``lsd_tpu/utils/network.py`` for the port).

Re-derivation of util/setup_network.py — validate the ``board.network``
interface list and the output destinations before a config is accepted
(network_validation, called from the config path like the reference's
config_manager.py:11), and build the nmcli command sequence that realizes
the interface config (setup_network:77-96).  Command EXECUTION is gated
behind ``apply_network(..., run=...)`` so tests and non-root deployments
plan without touching the host.
"""
from __future__ import annotations

import socket
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def is_valid_ipv4_address(address) -> bool:
    try:
        socket.inet_pton(socket.AF_INET, str(address))
    except (OSError, TypeError):
        return False
    return str(address).count(".") == 3


def is_valid_ipv4_mask(netmask) -> bool:
    """A netmask must be a valid dotted quad whose bits are contiguous."""
    if not is_valid_ipv4_address(netmask):
        return False
    a, b, c, d = (int(o) for o in str(netmask).split("."))
    mask = a << 24 | b << 16 | c << 8 | d
    if mask == 0:
        return True
    m = mask & -mask
    right0 = -1
    while m:
        m >>= 1
        right0 += 1
    return mask | ((1 << right0) - 1) == 0xFFFFFFFF


def prefix_len(netmask: str) -> int:
    a, b, c, d = (int(o) for o in str(netmask).split("."))
    return bin(a << 24 | b << 16 | c << 8 | d).count("1")


def network_validation(config: Dict) -> Tuple[bool, str]:
    """Validate board.network + UDP/point-cloud outputs of a config dict
    (ref setup_network.network_validation:50-73). Returns (ok, message)."""
    board = config.get("board") or {}
    for net in board.get("network") or []:
        if net.get("DHCP"):
            continue
        if not is_valid_ipv4_address(net.get("IP")):
            return False, "Invalid Board Network IP address"
        if not is_valid_ipv4_mask(net.get("mask")):
            return False, "Invalid Board Network netmask"
        if not is_valid_ipv4_address(net.get("gateway")):
            return False, "Invalid Board Network gateway"
    out = (config.get("output") or {}).get("protocol") or {}
    udp = out.get("UDP") or {}
    if udp.get("use"):
        dest = udp.get("dest", udp.get("destination"))
        if not is_valid_ipv4_address(dest):
            return False, "Invalid UDP destination address"
        try:
            port = int(udp.get("port", 0))
        except (TypeError, ValueError):
            return False, "Invalid UDP destination port"
        if port < 1024 or port > 49151:
            return False, "Invalid UDP destination port"
    pc = (config.get("output") or {}).get("point_cloud") or {}
    if pc.get("use") and pc.get("destination") is not None \
            and not is_valid_ipv4_address(pc.get("destination")):
        return False, "Invalid Point cloud transfer address"
    return True, ""


def nmcli_plan(networks: Sequence[Dict],
               ifaces: Optional[Sequence[str]] = None) -> List[str]:
    """The nmcli command sequence realizing the interface list (ref
    setup_network:77-96): delete stale cons, add eth<i>, set static or
    DHCP ipv4, bring up."""
    cmds = [f'nmcli connection delete "Wired connection {i}"'
            for i in range(len(networks))]
    for i, net in enumerate(networks):
        if ifaces is not None and str(i) not in [str(x) for x in ifaces]:
            continue
        cmds.append(f"nmcli connection delete eth{i}")
        cmds.append(f"nmcli connection add type ethernet con-name eth{i} "
                    f"ifname eth{i}")
        if net.get("DHCP"):
            cmds.append(f"nmcli con mod eth{i} ipv4.method auto "
                        f'ipv4.gateway "" ipv4.addresses ""')
        else:
            plen = prefix_len(net["mask"])
            cmds.append(f"nmcli con mod eth{i} ipv4.method manual "
                        f"ipv4.addresses {net['IP']}/{plen} "
                        f"ipv4.gateway {net['gateway']}")
        cmds.append(f"nmcli con up eth{i}")
    return cmds


def apply_network(networks: Sequence[Dict],
                  run: Callable[[str], object],
                  ifaces: Optional[Sequence[str]] = None) -> int:
    """Execute the nmcli plan through ``run`` (caller supplies the command
    runner — root-only; nothing executes unless invoked explicitly)."""
    cmds = nmcli_plan(networks, ifaces)
    for c in cmds:
        run(c)
    return len(cmds)
