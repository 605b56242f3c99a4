"""The campaign's distributed merge on a group of ranks (counterpart of
``lsd_tpu/tools/campaign_merge.py``).

``tools/campaign.py`` runs the merge here, in a subprocess on 8 gloo ranks
of the CPU, when its host has fewer than two cards (the reference runs it
on 8 virtual CPU devices).  Usage:

  python -m lsd_tpu_torch.tools.campaign_merge MAP_A MAP_B OUT_DIR OUT_JSON \
      [--ranks 8]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Optional


def merge_rank(mesh, map_a: str, map_b: str, out_dir: Optional[str]) -> Dict:
    """``campaign.merge_distributed`` as a rank function: its report without
    the builder and the solver's info."""
    from .campaign import merge_distributed
    m = merge_distributed(mesh, map_a, map_b, out_dir)
    return {k: v for k, v in m.items() if k not in ("builder", "info")}


def merge_ranks(map_a: str, map_b: str, out_dir: Optional[str], ranks: int = 8,
                backend: str = "gloo", timeout_s: float = 3600.0) -> Dict:
    """``campaign.merge_distributed`` on ``ranks`` new processes (NCCL: one
    card each; gloo: the CPU); rank 0 saves the merged map.  Returns rank
    0's report."""
    from ..parallel import run_ranks
    return run_ranks(merge_rank, ranks, args=(map_a, map_b, out_dir), backend=backend,
                     timeout_s=timeout_s)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("map_a")
    ap.add_argument("map_b")
    ap.add_argument("out_dir")
    ap.add_argument("out_json")
    ap.add_argument("--ranks", type=int, default=8)
    args = ap.parse_args(argv)
    res = merge_ranks(args.map_a, args.map_b, args.out_dir, args.ranks)
    with open(args.out_json, "w") as fh:
        json.dump(res, fh)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
