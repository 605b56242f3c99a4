"""Traffic-light 2D detector training CLI (counterpart of
``lsd_tpu/tools/train_yolo.py``).

    python -m lsd_tpu_torch.tools.train_yolo --steps 2000 --batch 8 \
        --out yolo2d_tl.msgpack [--device cpu]

Trains the port's 4-class ``Yolo2D`` (bf16, float32 heads) at 256 x 320 on
procedural traffic-light scenes (``training/camera_data.py``) and reports
2D AP through the decode + NMS deployment path; the weights feed
``runtime.trafficlight_module.build_yolo_predict_fn`` with
``Yolo2DConfig(num_classes=4)``.  It runs on the card unless ``--device``
names another device.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "lsd_tpu_yolo2d.msgpack"))
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from ..models.yolo2d import Yolo2DConfig
    from ..training.camera_data import SyntheticTrafficLightDataset, TrafficLightSceneConfig
    from ..training.yolo import YoloTrainer

    scfg = TrafficLightSceneConfig()
    trainer = YoloTrainer(Yolo2DConfig(num_classes=4), hw=scfg.hw, lr=args.lr,
                          total_steps=args.steps, device=args.device)
    ds = SyntheticTrafficLightDataset(scfg, batch_size=args.batch)
    out = trainer.fit(ds.batches(args.steps))
    eval_ds = SyntheticTrafficLightDataset(scfg, batch_size=args.batch, seed=999)
    metrics = trainer.evaluate(list(eval_ds.batches(args.eval_batches)))
    path = trainer.save(args.out)
    print(f"trained {out['steps']} steps, final loss {out['final_loss']:.4f}, "
          f"2D mAP {metrics['mean_ap']:.3f} {metrics['per_class']}, weights -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
