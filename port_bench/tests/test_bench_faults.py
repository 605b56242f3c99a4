"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (``harness.run_cell``) on the CPU at a
small size, past the harness's look for a card, with one fault planted in
the program: a step that returns its state unchanged, half of the input
left out, an answer altered where it is produced."""
import io
import json

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.drivers import detect_drive, lio_replay

SEED = 2 ** 31 + 77
CPU = torch.device("cpu")


def lio_cell():
    cell = harness.Cell("lio-replay")
    cell.config = dict(cell.config, points_per_scan=4096,
                       lio=dict(cell.config["lio"], ds_capacity=1024, map_capacity=2 ** 14))
    cell.traffic = dict(cell.traffic, scans_per_lap=40, warm_scans=3, check_scans=[8, 10])
    return cell


SMALL_DET = dict(pc_range=[-12.8, -12.8, -2.0, 12.8, 12.8, 4.0], max_voxels=8192)


@pytest.fixture
def det_cell(monkeypatch):
    from lsd_tpu_torch.models.detector import DetectorConfig
    full = DetectorConfig.true_reference_capacity()
    monkeypatch.setattr(DetectorConfig, "true_reference_capacity", classmethod(
        lambda cls: full._replace(pc_range=tuple(SMALL_DET["pc_range"]),
                                  max_voxels=SMALL_DET["max_voxels"])))
    cell = harness.Cell("detect-drive")
    cell.config = dict(cell.config, **SMALL_DET, roi_half_width_m=12.0)
    cell.traffic = dict(cell.traffic, frames=6, points_per_frame=4096, range_m=12.0,
                        objects_in_range=8, warm_frames=2)
    return cell


def result(cell, driver):
    out = io.StringIO()
    assert harness.run_cell(cell, driver, SEED, 0.5, False, CPU, out=out) == 0
    return json.loads(out.getvalue().splitlines()[-1])


def test_sound_lio_run_is_correct():
    assert result(lio_cell(), lio_replay)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_points", "pose_altered"])
def test_lio_fault_is_caught(monkeypatch, fault):
    import lsd_tpu_torch.slam.lio as lio
    real = lio.lio_step
    calls = []

    def broken(cfg, st, points, stamps, mask, *rest):
        calls.append(1)
        if fault == "half_the_points":
            mask = mask.clone()
            mask[mask.shape[0] // 2:] = False
        new, info = real(cfg, st, points, stamps, mask, *rest)
        if fault == "state_unchanged":
            return st, info
        if fault == "pose_altered" and len(calls) == 6:
            info = dict(info, pose=info["pose"] + torch.tensor([[0, 0, 0, 0.05]] + [[0] * 4] * 3))
        return new, info
    monkeypatch.setattr(lio, "lio_step", broken)
    r = result(lio_cell(), lio_replay)
    assert not r["correct"], r["checks"]


def test_sound_detect_run_is_correct(det_cell):
    assert result(det_cell, detect_drive)["correct"]


@pytest.mark.parametrize("fault", ["tracker_unchanged", "half_the_points", "boxes_altered",
                                   "candidates_altered"])
def test_detect_fault_is_caught(monkeypatch, det_cell, fault):
    import lsd_tpu_torch.detection.tracker as tracker
    import lsd_tpu_torch.models.detector as detector
    import lsd_tpu_torch.runtime.modules as modules
    if fault == "tracker_unchanged":
        monkeypatch.setattr(tracker.Tracker3D, "update", lambda self, *a, **k: self.output())
    elif fault == "candidates_altered":
        # candidates under every class's threshold move: only the
        # comparison before NMS can see it
        real_decode = detector.CenterPointDetector.decode

        def decode(self, preds):
            boxes, scores, labels, mask = real_decode(self, preds)
            low = (scores >= 0.1) & (scores < 0.25)
            return boxes, torch.where(low, scores + 0.05, scores), labels, mask
        monkeypatch.setattr(detector.CenterPointDetector, "decode", decode)
    else:
        real = modules.build_detector_predict_fn

        def build(*a, **k):
            fn = real(*a, **k)

            def predict(points, mask):
                if fault == "half_the_points":
                    mask = np.asarray(mask).copy()
                    mask[len(mask) // 2:] = False
                out = fn(points, mask)
                if fault == "boxes_altered":
                    out = (out[0] + torch.tensor([0.5, 0, 0, 0, 0, 0, 0]),) + tuple(out[1:])
                return out
            predict.model = fn.model
            return predict
        monkeypatch.setattr(modules, "build_detector_predict_fn", build)
    r = result(det_cell, detect_drive)
    assert not r["correct"], r["checks"]
