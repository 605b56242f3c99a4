"""Monocular 3D detector training CLI (counterpart of
``lsd_tpu/tools/train_mono3d.py``).

    python -m lsd_tpu_torch.tools.train_mono3d --steps 3000 --batch 4 \
        --out mono3d.msgpack [--small] [--device cpu]

Trains the port's ``Mono3D`` (float32, TF32 off) on procedural
shaded-cuboid scenes (``training/camera_data.py``) and prints one JSON
line: steps, final loss, the weights' path and the centre-distance AP and
mean depth error through the deployment decode.  ``--small`` is the
smoke-test size: 96 x 160 images, ``base_ch=8``.  It runs on the card
unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "lsd_tpu_mono3d.msgpack"))
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="tiny model + 96x160 images (smoke testing)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from ..models.mono3d import Mono3DConfig
    from ..training.camera_data import Mono3DSceneConfig, SyntheticMono3DDataset
    from ..training.mono3d import Mono3DTrainer

    hw = (96, 160) if args.small else (384, 640)
    mcfg = Mono3DConfig(image_hw=hw, base_ch=8 if args.small else 32)
    scfg = Mono3DSceneConfig(hw=hw)
    trainer = Mono3DTrainer(mcfg, lr=args.lr, total_steps=args.steps, device=args.device)
    ds = SyntheticMono3DDataset(scfg, batch_size=args.batch)
    out = trainer.fit(ds.batches(args.steps))
    eval_ds = SyntheticMono3DDataset(scfg, batch_size=args.batch, seed=999)
    metrics = trainer.evaluate(list(eval_ds.batches(args.eval_batches)))
    path = trainer.save(args.out)
    print(json.dumps(dict(steps=out["steps"], final_loss=round(out["final_loss"], 4),
                          weights=path, **metrics)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
