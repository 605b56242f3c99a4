"""Detection training CLI (counterpart of ``lsd_tpu/tools/train.py``).

    python -m lsd_tpu_torch.tools.train --steps 500 --batch 2 \
        [--data /path/to/labeled_recording] [--out weights.msgpack] \
        [--ref-capacity --realistic] [--init weights/detector_refcap.msgpack] \
        [--device cpu]

Without --data, trains on the synthetic scene generator; with --data, on
annotated .pkl recordings (frames carrying gt_boxes/gt_labels).  The
weights file is the reference's flax-msgpack format: the runtime's
``build_detector_predict_fn(weights=...)`` of either package serves it.
It runs on the card unless ``--device`` names another device.
``--mesh-dp N`` trains data-parallel on N ranks (``parallel.run_ranks``):
N cards over NCCL, one rank each, or with ``--device cpu`` N gloo ranks of
the CPU; each batch of ``--batch`` frames is split over the ranks.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", default=None,
                    help="labeled recording dir (synthetic scenes if unset)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "lsd_tpu_detector.msgpack"))
    ap.add_argument("--mesh-dp", type=int, default=0,
                    help="shard batches over N ranks, one card each (0 = single device)")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--eval-batches", type=int, default=4,
                    help="held-out batches for the AP eval")
    ap.add_argument("--realistic", action="store_true",
                    help="lidar-realistic synthetic scenes (1/r density, "
                         "face visibility, shadows, wall/pole clutter)")
    ap.add_argument("--ref-capacity", action="store_true",
                    help="train the reference-capacity model (+-64 m, "
                         "0.2 m pillars, 640^2 grid)")
    ap.add_argument("--true-ref-capacity", action="store_true",
                    help="train at the reference's DEPLOYED pitch "
                         "(0.1 m pillars, 1280^2 fine grid, "
                         "space-to-depth 640^2 dense BEV)")
    ap.add_argument("--init", default=None,
                    help="warm-start from an existing checkpoint")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    if not args.mesh_dp:
        return train(args)
    if args.batch % args.mesh_dp:
        raise ValueError(f"--batch {args.batch} does not split over --mesh-dp {args.mesh_dp}")
    from ..parallel import run_ranks
    # NCCL ranks need a card each (run_ranks raises, naming both counts)
    backend = "gloo" if args.device == "cpu" else "nccl"
    return run_ranks(_train_rank, args.mesh_dp, args=(vars(args),), backend=backend,
                     timeout_s=7 * 24 * 3600.0)[0]


def _train_rank(mesh, args: dict) -> int:
    """One rank of ``--mesh-dp``: rank 0 evaluates, saves and prints."""
    args = argparse.Namespace(**args)
    if mesh.rank != 0:
        args.eval_every = 0
    return train(args, mesh)


def train(args, mesh=None) -> int:
    """Train, evaluate and save as the arguments say; with a mesh, this
    rank's share of data-parallel training (rank 0 saves)."""
    from ..models.detector import DetectorConfig
    from ..training import (LabeledFrameDataset, SyntheticDetectionDataset,
                            SyntheticSceneConfig, Trainer, TrainerConfig)

    det_cfg = (DetectorConfig.true_reference_capacity() if args.true_ref_capacity
               else DetectorConfig.reference_capacity() if args.ref_capacity
               else DetectorConfig())
    trainer = Trainer(det_cfg=det_cfg, cfg=TrainerConfig(lr=args.lr, total_steps=args.steps),
                      device=None if mesh is not None else args.device, mesh=mesh)
    if args.init:
        trainer.load(args.init)
    if args.data:
        ds = LabeledFrameDataset(args.data, batch_size=args.batch)
        batches = ds.batches(epochs=max(1, args.steps // max(len(ds), 1)))
        eval_batches = list(ds.batches(epochs=1))
    else:
        scfg = SyntheticSceneConfig(realistic=args.realistic)
        if args.ref_capacity or args.true_ref_capacity:
            scfg.xy_range = 60.0
        ds = SyntheticDetectionDataset(scfg, batch_size=args.batch)
        batches = ds.batches(args.steps)
        eval_batches = list(SyntheticDetectionDataset(
            scfg, batch_size=args.batch, seed=999).batches(args.eval_batches))

    out = trainer.fit(batches, eval_batches=eval_batches, eval_every=args.eval_every,
                      ckpt_path=args.out if args.eval_every else None)
    if mesh is not None and mesh.rank != 0:
        return 0
    metrics = trainer.evaluate(eval_batches)
    path = trainer.save(args.out)
    print(f"trained {out['steps']} steps, final loss {out['final_loss']:.4f}, "
          f"mean AP {metrics['mean_ap']:.3f}, weights -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
