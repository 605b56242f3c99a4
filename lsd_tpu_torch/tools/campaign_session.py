"""One campaign session in a process of its own (counterpart of
``lsd_tpu/tools/campaign_session.py``).

The reference's campaign runs each session replay here, as a subprocess
with a hard timeout.  Only that campaign invokes it, and the campaign's
merge waits for the distributed Schur solver (ROADMAP A13), so ``main``
raises ``NotImplementedError`` before doing any work.  A single session runs
in process through ``tools/campaign.py``'s ``make_recording`` and
``run_session``.
"""
from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "campaign sessions run under the campaign, whose merge needs the "
        "distributed Schur solver the port does not have yet (ROADMAP A13); "
        "call tools.campaign.run_session for one session")


if __name__ == "__main__":
    main()
