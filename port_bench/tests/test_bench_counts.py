"""The counts equal values worked out by hand."""
from port_bench.counts import detector, lio_step, p2p


def test_b1_at_16384_points():
    # per point 3 + 3 + 1 + 1 floats in; R, Re, te, pos once; HtH, Htr, stats out
    assert p2p.b1_bytes(16384) == 16384 * 32 + 24 * 4 + 603 * 4 == 526_796
    assert p2p.b1_flops(16384) == 16384 * 138


def test_lio_step_bytes_at_bench_shapes():
    undistort = 32768 * 7 * 4
    downsample = 32768 * 16 + 16384 * 16
    match = 16384 * 7 * 2 * 4 + 16384 * 7 * 40
    iterate = 4 * 526_796
    insert = 16384 * 40 * 3
    assert lio_step.step_bytes(16384, 4, 32768) == (
        undistort + downsample + match + iterate + insert) == 11_282_224


def test_detector_flops_of_a_small_config():
    cfg = dict(pc_range=[-3.2, -3.2, -2.0, 3.2, 3.2, 4.0], voxel_size=[0.1, 0.1, 6.0],
               pillar_filters=64, s2d_factor=2, bev_stride=2, max_voxels=1000,
               max_points_per_voxel=5, num_classes=3)
    # 64 x 64 pillars, space-to-depth 2: a 32 x 32 x 256 image; stages at 16^2, 8^2, 4^2
    stage1 = 75_497_472 + 18_874_368 + 8_388_608 + 37_748_736
    stage2 = 9_437_184 + 18_874_368 + 1_048_576 + 37_748_736 + 8_388_608
    stage3 = 9_437_184 + 18_874_368 + 1_048_576 + 37_748_736 + 16_777_216
    head = 113_246_208 + 113_246_208 + 393_216
    vfe = 2 * 9 * 64 * 1000 * 5
    assert detector.network_flops(cfg) == stage1 + stage2 + stage3 + head + vfe == 532_538_368
