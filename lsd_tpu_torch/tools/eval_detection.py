"""Detection AP evaluation at WOD-convention IoUs on the port (counterpart
of ``lsd_tpu/tools/eval_detection.py``).

Scores the shipped reference-capacity checkpoint (and its int8-PTQ
variant) through the DEPLOYMENT decode+NMS path (``Trainer.evaluate``, on
the card) on held-out lidar-realistic synthetic scenes:

  Vehicle    IoU 0.7     (WOD convention)
  Pedestrian IoU 0.5
  Cyclist    IoU 0.5

plus the legacy IoU-0.5 mean AP and the seg IoU.  The int8 column answers
"what does PTQ cost in AP".  The network runs in bf16, as it is served; the
report's ``fp32`` key names the checkpoint's dtype, as the reference's does.

Usage: python -m lsd_tpu_torch.tools.eval_detection [--weights W] [--batches N] [--cpu]
"""
from __future__ import annotations

import argparse
import json

from ..utils.device import DeviceLike, resolve_device

WOD_IOUS = {0: 0.7, 1: 0.5, 2: 0.5}
CLASS_NAMES = {0: "Vehicle", 1: "Pedestrian", 2: "Cyclist"}


def evaluate_weights(weights_path: str, n_batches: int = 8,
                     batch: int = 2, int8: bool = False,
                     true_ref: bool = False,
                     distant: bool = False, device: DeviceLike = None) -> dict:
    from ..convert import detector_params_from_flax, detector_params_to_flax
    from ..models import DetectorConfig
    from ..models.quantize import dequantize_params, quantize_params
    from ..training import (SyntheticDetectionDataset, SyntheticSceneConfig,
                            Trainer, TrainerConfig)

    det_cfg = (DetectorConfig.true_reference_capacity() if true_ref
               else DetectorConfig.reference_capacity())
    trainer = Trainer(det_cfg=det_cfg, cfg=TrainerConfig(), device=device)
    trainer.load(weights_path)
    if int8:
        trainer.model.load_state_dict(detector_params_from_flax(
            dequantize_params(quantize_params(detector_params_to_flax(trainer.model)))))

    scfg = SyntheticSceneConfig(realistic=True)
    scfg.xy_range = 60.0
    if distant:
        # distant-small-object slice: every object at 30-60 m, where a
        # pedestrian subtends a handful of 0.1 m cells — the regime the
        # fine-pitch capacity exists for
        scfg.min_obj_range = 30.0
    eval_batches = list(SyntheticDetectionDataset(
        scfg, batch_size=batch, seed=999).batches(n_batches))

    m_wod = trainer.evaluate(eval_batches, iou_thresh=WOD_IOUS)
    m_05 = trainer.evaluate(eval_batches, iou_thresh=0.5)
    return dict(
        per_class_wod={CLASS_NAMES.get(k, k): round(v, 4)
                       for k, v in m_wod["per_class"].items()},
        mean_ap_wod=round(m_wod["mean_ap"], 4),
        mean_ap_iou05=round(m_05["mean_ap"], 4),
        per_class_iou05={CLASS_NAMES.get(k, k): round(v, 4)
                         for k, v in m_05["per_class"].items()},
        seg_iou=m_wod["seg_iou"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", default=None,
                    help="checkpoint (default: shipped refcap weights)")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--skip-int8", action="store_true")
    ap.add_argument("--distant", action="store_true",
                    help="add a distant-objects (30-60 m) eval slice")
    ap.add_argument("--true-ref-capacity", action="store_true",
                    help="score the 0.1 m-pitch (true deployed capacity) "
                         "checkpoint instead of the 0.2 m one")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    weights = args.weights
    if not weights:
        from ..models import DetectorConfig
        from ..runtime.modules import shipped_detector_weights
        cfg_cls = (DetectorConfig.true_reference_capacity()
                   if args.true_ref_capacity
                   else DetectorConfig.reference_capacity())
        weights = shipped_detector_weights(cfg_cls)
        if not weights:
            raise FileNotFoundError("no shipped weights found for this capacity")

    tr = bool(args.true_ref_capacity)
    report = dict(weights=weights,
                  fp32=evaluate_weights(weights, args.batches, args.batch,
                                        true_ref=tr, device=device))
    if args.distant:
        report["fp32_distant_30_60m"] = evaluate_weights(
            weights, args.batches, args.batch, true_ref=tr, distant=True,
            device=device)
    if not args.skip_int8:
        report["int8_ptq"] = evaluate_weights(weights, args.batches,
                                              args.batch, int8=True,
                                              true_ref=tr, device=device)
        report["int8_mean_ap_delta_wod"] = round(
            report["int8_ptq"]["mean_ap_wod"]
            - report["fp32"]["mean_ap_wod"], 4)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=2)
    return report


if __name__ == "__main__":
    main()
