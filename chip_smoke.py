#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build every CUDA kernel (the LIO scan step's and DSVT's) from ``lsd_tpu_torch/csrc``
   (``nvcc`` for sm_90a) and print the build seconds.
2. Drive the LIO step (``lsd_tpu_torch.slam.lio.lio_step``, surfel map) at
   the size ``bench.py`` uses: 32,768-point ``CircleSim`` scans, 16 IMU
   samples, ``ds_capacity=16384``, ``map_capacity=2**18``, 0.4 m voxels,
   ``max_iters=4``.  After the warm-up scans, hold each kernel against its
   plain PyTorch version on the card, on the main path's own inputs (the
   p2p kernel's first iteration; the IMU propagation at the scan's 16
   slots and with them laid into the pipeline's 64); check that a call is
   one launch, that two launches and a CUDA-graph replay agree bitwise;
   time kernel and plain version beside the bound and the launch floor
   (the device time of a one-element PyTorch op).  The degeneracy gate
   (``csrc/lio_gate.cu``) likewise, on the main path's first ``HtH`` and on
   random pose blocks with 0 to 3 eigenvalues under ``degen_thresh``.
3. Set the launch counts to 0, time the main path over the timed scans,
   read the counts (each kernel counts its launches where it runs,
   ``csrc/launch_count.cuh``, so a replayed graph's count), and check the trajectory (finite state, ATE < 0.1 m,
   ``bench.py``'s own sanity bound) and that the p2p kernel and the gate
   ran ``max_iters`` times and the IMU kernel once per scan.  The main path
   replays the step as CUDA graphs (``slam/lio_graph.py``); the same scans
   from the same state through the eager body are timed beside it, and the
   graph runner's counters printed.
2b. The DSVT set-attention kernel (``csrc/dsvt_set_attn.cu``) at the
   published widths on a bench-size frame: the pillars of one 169,600-point
   sweep of ``port_bench/traffic/urban-drive-waymo-top.json`` and seeded
   bf16 Q, K and V, each of the frame's four partitions held against
   ``set_attention_plain`` (DSVT_ATTN_TOL of the largest output); one launch
   a call; two launches and a CUDA-graph replay bitwise equal; kernel and
   plain version timed beside the bound and the launch floor.
4. The mapping path at full width: ``lsd_tpu_torch.slam.mapper.Mapper`` on
   the card over 95 scans of 32,768 points 1.2 times round an 8 m circle
   (the world of the reference's own mapping test), the LIO configured as
   above, a keyframe every 1.5 m, PGO every 8 keyframes, graph work
   synchronous; then ``save()`` and ``load_map``.  Checks, the reference
   test's own bars: more than 15 keyframes, at least one accepted loop,
   trajectory RMSE against ground truth < 0.3 m, every PGO's cost finite
   and its last round's not above its first's (``save()``'s solve starts
   from an optimized graph, where the float32 costs only wander: the cost
   before and after it is compared in float64; a drive's first solve, of a
   chain with no loop yet, starts at zero cost and must stay under the
   rounding floor), the loaded map whole, and
   the p2p kernel launched ``max_iters`` times per scan.  Then the same 95 scans
   with the background graph worker and the pipelined fetch, ending in a
   clean ``flush()`` and ``close()``: the worker raised nothing, dropped no
   job, added a descriptor for every keyframe, and every ScanContext query,
   ICP verification and PGO solve ran on its thread, with at least one loop
   accepted and the same trajectory bar.
5. The raw-point LIO path: 30 of phase 2's scans with
   ``map_type="points"`` (finite state, ATE < 0.1 m, the p2p kernel
   launched ``max_iters`` times per scan).
6. The localization path at full width, on the map directory phase 4 saved:
   ``lsd_tpu_torch.slam.localization.Localizer`` with ``LocalizerConfig()``
   defaults (the side LIO on: 8,192 residual points, 3 iterations; tracking
   scan downsampled to 8,192 at 0.4 m; NDT map of 2**16 slots at 1 m, surfel
   map of 2**17 at 0.5 m), a pose hint ~1 m off, then 70 scans of 32,768
   points that the mapping run did not see, from rest up to the mapping
   run's speed, each with its stamps, its 16 IMU samples and the newest
   sample, as the runtime feeds them.  Checks: initialised from the hint,
   every later scan ``tracking``, position RMSE against the simulator's
   truth after the first 3 poses < 1.0 m and the last four errors within
   0.1 m of each other (the reference test's bars), the side LIO's
   increments in use after its 10 warm-up scans, at least one recentre of
   the local map, and the p2p kernel launched 3 times per scan; the kernel
   is then held against its plain version at this path's shape too (8,192
   points, on the side LIO's own state).  Then the drive's first 25 scans
   without stamps and IMU batch (IMU-driven prediction, 15 NDT searches),
   same bars, no p2p launch.  Reported and not judged: both modes on the
   reference test's own drive, begun at the mapping run's speed (a filter
   that starts cold at 6.4 m/s is a weak spot of the reference, which the
   port reproduces), and global relocalization without a hint through
   ``Localizer.process_scan`` on a fresh localizer, for the drive's last
   scan, for the sweep a keyframe was made from and for that keyframe's
   stored cloud (the ring world is ambiguous to ScanContext).  Last,
   ``localize_track_step`` alone, N_TRACK_CALLS calls with a fetch each and
   as many with one fetch at the end, which must make no host sync.
7. RTK mapping: ``RtkMapper`` over phase 4's scans with fixes made from the
   simulator's poses through ``geometry/utm.py`` (at least 20 keyframes,
   every scan's pose equal to its interpolated fix); and ``IcpOdometry``
   with its default config on 25 scans of 32,768 points of the reference
   test's slow 10 m circle (relative-motion ATE after the first two scans
   < 0.35 m).

8. Detection at full width, both shipped checkpoints (0.2 m pillars over
   +-64 m, a 640^2 grid; 0.1 m pillars, a 1280^2 fine grid in space-to-depth):
   read with the port's own msgpack reader.  The float32 twin of each on the
   card (TF32 off) against the same on the host's CPU, on one realistic
   scene of 2 accumulated frames (65,536 points): voxelization equal, head
   maps within DET_MAP_RTOL of each map's largest magnitude, kept boxes
   matched one to one.  The served path (``build_detector_predict_fn``,
   bf16) on the 16 scenes of the reference's detection evaluation: mean AP
   at the WOD IoUs within DET_AP_MARGIN of the JAX package's figure on the
   same scenes (JAX_MEAN_AP).  Then the sequence of the reference's
   ``DetectModule.process`` over 20 frames of one scene seen from a vehicle
   at 10 m/s (``tools/profile_detector.py:ego_drive``/``detect_module``):
   predict makes no host sync; the tracker follows at least
   DRIVE_MIN_OBJECTS of the scene's objects with one ID each over at least
   DRIVE_MIN_FRAMES frames, at speeds under DRIVE_MAX_SPEED m/s; the p2p
   kernel is not launched.  Reported: ms per frame (predict by CUDA events,
   the whole frame on the host clock), launches, host syncs, the device's
   idle share and the time by span, at both capacities; unjudged, the same
   drive with the history aged by the INS's convention of the motion.
9. The camera models, from their shipped checkpoints, read with the port's
   reader.  The float32 ``Mono3D`` (TF32 off) on the card against the host's
   CPU on one 384 x 640 scene: maps within CAM_MAP_RTOL of each map's largest
   magnitude, the same decoded valid boxes; a control run with cuDNN's TF32
   on must exceed that bar.  Mean AP on the card over the
   16 scenes of each model's evaluation (``training/camera_data.py``): Mono3D
   (float32) within MONO3D_AP_BAR of the JAX package's JAX_MONO3D_AP, Yolo2D
   (bf16, 4 classes) within YOLO_AP_BAR of JAX_YOLO_AP; ``nms_2d`` and
   Mono3D's model and decode make no host sync.  ``Mono3DInfer.detect`` on a
   1920 x 1080 uint8 frame (resized on the card).  ``DetectModule.process``
   with the 0.2 m LiDAR checkpoint over CAM_DRIVE frames of phase 8's drive,
   each with the camera cam0's view of the drive's own objects, with the
   mono3d fusion on and off: finite objects, a tracked object in each of the
   last CAM_MIN_TRACKED_FRAMES frames; with fusion, LiDAR objects in each of
   those frames, every one of them back out of the fusion, and both
   matched and camera-only objects in the fused lists.
   ``TrafficlightModule.process`` on N_TL_FRAMES 1920 x 1080 frames with the
   4-class function injected (the 8-class default must refuse the
   checkpoint): the model reached on every frame, proto-ready ``lights``,
   the map light matched in at least TL_MIN_FOUND.  ``quantized_matmul``'s
   ``torch._int_mm`` accumulators equal the CPU's; the Mono3D checkpoint
   through ``save_quantized`` and back, served on the card (mean AP
   reported).  Reported: ms per call (CUDA events), launches, host syncs,
   the device's idle share, and spans ``camera/*`` of the module's frame.
10. The runtime's default pipeline, through ``Perception`` on the card
   (``runtime/perception.py``), each sub-phase from a recording written with
   the port's ``FrameRecorder`` and every output frame recorded by the sink:
   (a) mapping: the first N_PIPE_MAP of phase 4's scans, each frame with an
   RTK-fixed INS fix
   from the truth (status 42, velocity, heading) and absolute IMU stamps,
   ``slam.mode mapping`` at 0.4 m with a keyframe every 1.5 m / 0.3 rad,
   ``async_graph`` and ``async_fetch`` at their defaults (on), the LIO
   seeded at the simulator's start; saved through ``slam.save_mapping``.
   Checks: every scan integrated, no module restart, the status never
   Error, the graph worker raised nothing, more than 15 keyframes, at
   least 1 loop, trajectory RMSE < 0.3 m, GPS priors and ``origin_lla``,
   ``graph.g2o`` written and the map loading, the p2p kernel launched
   ``max_iters`` times per scan, a ``slam.odometry`` message received on the
   bus.  (b) localization on that map: N_PIPE_LOC scans of phase 6's drive from
   rest, with fixes, the hint through ``slam.set_init_pose``; on the
   recorded poses, phase 6's bars (RMSE < 1.0 m after the first 3, the last
   four errors within 0.1 m), no restart, 3 launches per side-LIO scan.
   (c) detection: 20 frames of phase 8's drive through [Source, Detect,
   Sink] with the 0.2 m checkpoint and the UDP sink sending to a receiver
   here: every datagram parses back to the objects the sink recorded for
   its frame, the 20 frames out in order, no launch.  Reported for each:
   ms per frame over the first PIPE_TIMED frames, beside phases 4, 6 and
   8's direct calls in the same run; the stage's ms per frame; launches;
   and the host ms of reading a frame (pickle and normalization) and of
   ``frame_from_dict``, wall and thread CPU.  Nothing is traced in this
   phase (a card run crashed after a trace here, ROADMAP queue C).
11. Training at full width (``training_setups``): the CenterPoint trainer
   at the 0.2 m capacity (640^2 grid, 65,536 pillars of 8 points, bf16,
   batch 2 of the realistic scenes ``tools/train.py --ref-capacity
   --realistic`` trains on), Mono3D at 384 x 640 (float32, batch 4) and
   Yolo2D at 256 x 320 (bf16, 4 classes, batch 8).  For each: (1) from the
   shipped checkpoint, one batch's gradients on the card against the CPU:
   float32 ones (the detector's float32 twin, Mono3D; TF32 off) must be as
   close to their float64 twin's (on the card) as the CPU's are, per leaf
   within TRAIN_GRAD_RTOL or twice the CPU's distance; Yolo2D's, bf16 in
   both places, at cosine >= YOLO_GRAD_COS and relative norm gap <=
   YOLO_GRAD_GAP per leaf (the conv biases that a GroupNorm follows are
   reported); the optimizer's update from the same gradient within
   TRAIN_GRAD_RTOL.  (2) From a seeded initialisation, TRAIN_LEARN_STEPS
   steps: every loss finite, the mean of the last 10 below (1 -
   TRAIN_LOSS_DROP) times the first 10's.  (3) Warm-started from the shipped
   checkpoint, TRAIN_WARM_STEPS steps, ``save``: the file has the shipped
   file's keys and shapes and serves through the served path
   (``build_detector_predict_fn``, ``Mono3DInfer``, ``build_yolo_predict_fn``)
   within the model's AP bar of phases 8 and 9.  (4) Reported: ms per step
   (CUDA events; host clock ending in a synchronize), frames/s, forward and
   loss, backward and optimizer by CUDA events, launches and host syncs per
   step, peak memory, the device's idle share, spans ``train/*`` and the top
   kernels.  The p2p kernel is not launched.
12. The reference's scoring path on the port (``run_scoring``).  (a)
   ``tools.evaluate`` (``--skip-reference``) over its six rows at full width
   (32,768 points, ``ds_capacity`` 16,384, ``max_iters`` 4), each cut to
   N_EVAL_SCANS scans (warm-up 27, as the tool scores): ATE below
   EVAL_ATE_BARS, the filter state finite, the p2p kernel launched 4 times
   per scan on every row; the unaided tunnel's ATE reported, and its
   weak-direction count must fire after the warm-up.  (b) ``tools.loc_eval``
   through ``Perception``: ``build_map`` of the figure-eight world at radius
   LOC_EVAL_RADIUS (16,384 points a scan; at least LOC_EVAL_MIN_KEYFRAMES
   keyframes and a loop, the kernel 3 times per scan), then ``run`` over
   LOC_EVAL_LAPS laps without GNSS dropout, with the side LIO (the tool's
   default; relocalised, tracking at least LOC_EVAL_TRACKING of the frames,
   the kernel 3 times per frame, the tracked RMSE within
   LOC_EVAL_FUSION_MARGIN of the JAX package's on the same drive) and
   without it (the same, no launch, tracked RMSE x and y below
   LOC_EVAL_RMSE_M and heading below LOC_EVAL_HEADING_DEG).  (c)
   ``tools.eval_detection.evaluate_weights`` on ``weights/detector_refcap.msgpack``
   at its defaults: the fp32 key's mean AP at the WOD IoUs within
   DET_EVAL_MARGIN of the reference's JAX_DET_MEAN_AP_WOD, int8 reported;
   ``evaluate_mot`` on phase 8's drive (IoUs on the card), reported.  (d)
   The calibration RPCs through the interface registry: ``calibrate_ground``
   on a ``CorridorSim`` sweep from a mount tilted by CALIB_MOUNT (roll and
   pitch within CALIB_ANGLE_DEG, height within CALIB_HEIGHT_M); lidar-INS
   from (b)'s keyframes and their recorded fixes, pulled through the live
   route (heading within LIDAR_INS_DEG and translation within LIDAR_INS_M
   of the identity extrinsic, which is what the calibrator gives for the
   true poses; the planar drive leaves roll and pitch to the map's height
   errors, reported); ``export_colmap``
   of (b)'s map, read back (an image and a pose per keyframe, the poses
   within 1e-5).  No launch in (c) and (d).
13. The online system (``run_online``), in this process through the code
   that ``python -m lsd_tpu_torch run`` runs
   (``lsd_tpu_torch.__main__.start_system``), on a YAML config with
   ``input.mode: online``: one ``Custom`` LiDAR and GPCHC over UDP on ports
   found free, Source -> SLAM -> Sink with the SLAM stage in mapping mode at
   phase 10's settings (warmed up on two frames first), the UDP sink and the
   recorder on, the web API on port 0.  A sender thread streams
   ONLINE_SCANS scans of phase 4's ring (CAP points, in Custom datagrams of
   at most ONLINE_DATAGRAM_POINTS points) at 10 Hz wall clock and GPCHC at
   ONLINE_INS_HZ from the truth, stamped in GPS time; the LIO is seeded at
   the simulator's start.  Checks: the receiver counted every datagram sent
   and its ring dropped none; every point of every scan is in the captured
   frames, in order and bit-equal (the split and merged frames counted);
   the SLAM stage integrated at least ONLINE_MIN_INTEGRATED frames and the
   p2p kernel launched ``max_iters`` times per integrated frame; the LIO's
   RMSE against the truth below ONLINE_RMSE_BAR_M (no IMU row reaches an
   online frame, so the LIO stays near its seed: ROADMAP queue C);
   ``/v1/status`` Running with the frame counts, JSON-RPC ``slam.get_pose``
   equal to the module's last pose, ``/v1/message-meta`` listing
   ``slam.odometry``, ``/`` serving ``index.html`` byte-equal;
   ``tools/recv.py`` in a subprocess decoding ONLINE_RECV_FRAMES of the UDP
   sink's frames; the frames the SLAM stage processed, replayed offline from
   the sink's recording through ``Perception``, give the LIO's poses within
   ONLINE_REPLAY_ATOL_M; last, ``python -m lsd_tpu_torch run --config
   <yaml> --port 0`` in a subprocess answers ``/v1/status`` and exits 0 on
   SIGINT.  Reported: datagrams and frames per second, the SLAM stage's ms
   per frame, frames integrated, drops and drop share, IMU rows per frame,
   the RMSE beside that of a pose held at the seed, and the phase's seconds.
14. Multi-device code (``run_multi_device``; ``lsd_tpu_torch.parallel``),
   in this process on one NCCL rank of its own (world size 1; the
   collectives go through NCCL all the same) unless said otherwise.  (a)
   ``make_sharded_lio_step`` at phase 2's width over MD_SCANS scans of
   phase 2's world, ``research_thresh`` 0 (the sharded step matches planes
   once per scan), against ``lio_step`` at the same settings on the same
   scans, both under torch's deterministic algorithms: each scan's position
   within MD_POS_ATOL_M, the ATE below ATE_LIMIT_M, the p2p kernel launched
   ``max_iters`` times per scan and held against its plain version on this
   path's first-iteration inputs; ms per scan of both.  (b)
   ``sharded_lio_update`` on the next scan against ``lio_step``: the
   reference test's bars (``tests/test_parallel.py``: 5e-3 m, ``|q . q'|``
   above 1 - 1e-5).  (c) ``optimize_sharded`` and ``optimize_schur`` on phase
   4's saved graph, its poses perturbed from a seed, against
   ``posegraph.optimize``: positions within MD_PGO_ATOL_M (sharded) and
   MD_SCHUR_ATOL_M (Schur); ms per Gauss-Newton round by CUDA events.  (d)
   ``tools/campaign.py:merge_distributed`` on phase 4's map and phase 10a's
   ``Perception`` map: at least one cross edge, no fallback to the
   single-device solver; then what ``campaign.main`` runs on a one-card host,
   ``tools/campaign_merge.py`` in a subprocess on 8 gloo ranks of the CPU:
   the same cross edges, node positions within MD_MERGE_ATOL_M of the
   card's.  (e) ``make_sharded_lio_step`` on 2 gloo ranks in processes of
   their own, both on this card (CUDA tensors through gloo), over
   MD_GLOO_SCANS scans: the ranks' poses bitwise equal, each rank owning
   40-60 % of the map's occupied slots (the owner hash's uniformity bar of
   ``tests/test_sharded_map.py``, 0.8 of the mean share), the kernel
   ``max_iters`` times per scan in each.  (f) ``Trainer(mesh=...)`` against
   the one-card ``Trainer`` from phase 11's detector setup (the shipped
   checkpoint, float32): one batch's loss within 1e-4, its gradients within
   TRAIN_GRAD_RTOL of each leaf's largest magnitude, each trainer's
   optimizer update from its own gradient per leaf at cosine >=
   MD_UPDATE_COS and relative norm gap <= MD_UPDATE_GAP, and one real
   step finite.  Every group start has a
   60 s timeout and every spawned rank ends with the phase.
15. The rest of ``lsd_tpu_torch/tools`` (``run_tools``), each part with the
   launch counts from 0.  (a) ``tools.eval_formats`` at full width: CAP-point
   ``CircleSim`` scans (seed 33, the tool's rest and ramp), cut from the
   tool's 150 to N_FMT_SCANS, written as a rosbag (``tools.rosbag``) and as
   NCLT ``velodyne_hits.bin`` + ``ms25.csv`` (``tools.nclt``), converted, and
   each replayed through ``Perception`` on the card: ATE within
   FMT_ATE_MARGIN_M of the JAX package's figure at this cut (JAX_FMT_ATE),
   at least FMT_MIN_FRAMES of the scans paired with the truth, the p2p
   kernel 3 times per integrated scan and held against its plain version on
   the inputs of one rosbag replay's call.  (b) ``tools.export`` of the
   shipped 0.2 m checkpoint at EXPORT_POINTS points on the card
   (``torch.export``), loaded back: its outputs within EXPORT_ATOL of the
   eager module's on a scene of the detection evaluation; export and load
   seconds, ms per call of both.  (c) ``tools.profile.profile_lio_replay``
   over the first N_PROFILE_FRAMES frames of (a)'s rosbag recording (cut
   from 100), a trace in a temporary directory: 4 launches per frame.  (d)
   ``tools.loc_diag`` with the side LIO over the first N_LOC_DIAG frames of
   12b's drive (cut from all) on 12b's map: RMSE x and y within
   LOC_DIAG_ATOL_M of 12b's own run over the same frames, 3 launches per
   frame.  (e) ``tools.campaign_diag`` on 12b's map with its world's
   parameters: the five ablations' ATEs on the card within
   CAMPAIGN_DIAG_ATOL_M of the CPU's.  (f) ``tools.roofline.report``:
   measured peaks beside the data sheet's, the LIO step and its phases at
   bench shapes (ROOFLINE_REPS calls a timing, cut from 30).  (g)
   ``tools.bench_p2p`` over N_BENCH_P2P_SCANS scans (cut from 100): B1, the
   reference's route and the plain version per call, the routes' gap, the
   step with 4 launches per scan.  (h) ``tools.schur_chip_bench`` at its
   defaults (1,192 nodes, an 8-rank plan): ms per round, the all-reduce's
   bytes.  (i) ``tools.scaling`` without its CPU groups, SCALING_REPS pass a
   timing (cut from 3); its interconnect figures are projections.

Each path starts with the launch counts at 0 and reads them at its end.  It
prints one JSON line per path, the card's name and power limit, one
``{"kernels": [...]}`` line, and as its last line ``{"ok": true, "device":
{...}}``.  It has no CPU path: without a card, or without the
``lsd_tpu_torch`` package beside it, it fails.
"""
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# The profiler detaches CUPTI from the process at the end of every trace and
# attaches it again at the next.  Here traces follow a CUDA-graph capture
# (phase 2), and phase 10 ends its traces while the pipeline's threads launch
# kernels: a teardown or re-attach under either can abort the process
# (torch.profiler turns the teardown off itself for the CUDA graphs that it
# knows of, those of torch.compile).  CUPTI stays attached.
os.environ["TEARDOWN_CUPTI"] = "0"
# phase 13 runs its SLAM stage with torch's deterministic algorithms (see
# run_online), which need cuBLAS's workspace configured before its first use
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

N_WARM, N_BENCH = 5, 100
CAP, IMU_CAP = 2 ** 15, 16
ATE_LIMIT_M = 0.1
N_MAPPING, N_POINTS = 95, 30
MAPPING_RMSE_LIMIT_M = 0.3
# allowed relative rise of the float64 cost over a solve that starts from an
# optimized graph (save()'s): see check_pgo_costs.  The poses come back in
# float32, and rounding them alone moved that cost by -8.6e-5 ... +9.6e-5 in
# eight runs on an H100 80GB HBM3 at 700 W; the most it could move it is
# printed beside each reading (~1e-2).
PGO_FLAT_COST_RTOL = 1e-3
SYNC_COUNT_SCANS = range(40, 46)    # mapping scans whose host syncs are counted
N_TIMING = 100                      # launches per timing (median reported)
N_LOC, N_LOC_IMU, N_TRACK_CALLS = 70, 25, 25
LOC_T_START = 0.037                 # keeps the drive off the stamps the mapping run saw
N_LOC_CRUISE, N_LOC_CRUISE_IMU, CRUISE_T_START = 12, 8, 3.037
LOC_RMSE_LIMIT_M, LOC_TAIL_STEP_M = 1.0, 0.1
LOC_SYNC_SCANS = range(40, 46)      # localization scans whose host syncs are counted
N_ICP_ODOM, ICP_ODOM_ATE_LIMIT_M = 25, 0.35
RTK_MIN_KEYFRAMES, RTK_POSE_ATOL_M = 20, 1e-4
N_DRIVE, N_DRIVE_WARM, N_DRIVE_PROFILED, N_DRIVE_SYNC = 20, 2, 3, 2
# mean AP at the WOD IoUs of the JAX package's served detector (its
# build_detector_predict_fn, bf16) on the 16 scenes of its detection
# evaluation, on the CPU (jax 0.9.0): python -m tests.test_torch_detector_weights
JAX_MEAN_AP = {"reference": 0.49415356343815914, "true_reference": 0.5096206159231369}
DET_AP_MARGIN = 0.02
# float32 twin, card against CPU, TF32 off: head maps within this share of
# each map's largest magnitude; kept boxes within DET_BOX_ATOL (m, rad,
# score); a box within DET_BOX_ATOL of its class threshold may go unmatched
DET_MAP_RTOL, DET_BOX_ATOL = 1e-3, 1e-3
# the drive's bars, set from a CPU rehearsal before the first card run: an
# object is followed in a frame by the nearest track within DRIVE_GATE_M
DRIVE_MIN_OBJECTS, DRIVE_MIN_FRAMES, DRIVE_GATE_M = 2, 15, 2.0
DRIVE_MAX_SPEED, DRIVE_MIN_AGE = 1.5, 5
# phase 9: mean APs of the JAX package's camera models on the 16 scenes of
# their evaluations, on the CPU (jax 0.9.0): python -m tests.test_torch_camera_weights.
# One box gained or lost moves Mono3D's mean by up to 1/7/4 = 0.036 (7
# pedestrians, the fewest of a class) and Yolo2D's by up to 1/6/4 = 0.042
# (6 yellow lights; the 2 "off" lights would move it by 0.125)
JAX_MONO3D_AP, MONO3D_AP_BAR = 0.5667, 0.04
JAX_YOLO_AP, YOLO_AP_BAR = 0.9356060606060606, 0.05
# the float32 Mono3D, card against CPU, TF32 off: maps within this share of
# each map's largest magnitude (the CPU parity bar against JAX; a control
# run with cuDNN's TF32 on must exceed it), valid boxes within CAM_BOX_RTOL
# of 1 + |value|
CAM_MAP_RTOL, CAM_BOX_RTOL = 1e-4, 1e-3
CAM_HW = (1080, 1920)                # the camera frames' size
CAM_HEIGHT_M = 1.5                   # the drive's camera above the ground
N_CAM_DRIVE, CAM_MIN_TRACKED_FRAMES = 20, 15
N_TL_FRAMES, TL_MIN_FOUND = 20, 16
# phase 10: the pipeline's drives, the frames of each that are timed (see
# pipeline_report), and how long a drive may take
# (the mapping and localization drives were 95 and 70 scans until phase 12
# needed the time; at 60 the mapping run still closes loops: 20 keyframes, 9
# loops, RMSE 0.069 m in a CPU rehearsal, and the localization drive 0.256 m)
N_PIPE_MAP, N_PIPE_LOC, N_PIPE_DET = 60, 40, 20
PIPE_TIMED = {"mapping": 45, "localization": 30, "detection": 13}
PIPE_TIMEOUT_S = 300
# phase 11: training.  Card against CPU from the shipped checkpoints on one
# batch, TF32 off: float32 gradients (the detector's float32 twin, Mono3D)
# as close to their float64 twin's as the CPU's, per leaf within
# TRAIN_GRAD_RTOL or twice the CPU's distance of the leaf's largest
# magnitude (the CPU's own float32 gradient of the detector's first block
# lies 1.06e-2 of its largest magnitude from the float64 twin's at full width
# in a card run, and 4.1e-2 of the fourth block's at the rehearsal's size); the
# optimizer's update from the same gradient within TRAIN_GRAD_RTOL; Yolo2D,
# bf16 in both places, per leaf by cosine and relative norm gap (the CPU
# parity bars of tests/test_torch_train_camera.py against the reference).  From a seeded
# initialisation, TRAIN_LEARN_STEPS steps at TRAIN_LEARN_LR with warmup
# TRAIN_LEARN_WARMUP (the camera trainers' warmup is the reference's fixed
# 100): the mean loss of the last 10 below (1 - TRAIN_LOSS_DROP) times that
# of the first 10, every loss finite; the drops were set from a CPU
# rehearsal at reduced size before the first card run.  From the shipped
# checkpoints, TRAIN_WARM_STEPS steps at peak lr TRAIN_WARM_LR, saved, and
# served within each model's AP bar above.  TRAIN_TIMED_STEPS steps timed.
TRAIN_GRAD_RTOL = 1e-3
YOLO_GRAD_COS, YOLO_GRAD_GAP = 0.999, 0.05
TRAIN_LEARN_STEPS = {"detector": 60, "mono3d": 60, "yolo2d": 60}
TRAIN_LEARN_LR = {"detector": 2e-3, "mono3d": 5e-3, "yolo2d": 5e-3}
TRAIN_LEARN_WARMUP = 5
# rehearse_training() (the CPU, reduced size: detector +-25.6 m, Mono3D
# 96 x 160, Yolo2D 128 x 160, full widths otherwise) fell by 0.303, 0.558 and
# 0.807; the bars are about half of that
TRAIN_LOSS_DROP = {"detector": 0.15, "mono3d": 0.25, "yolo2d": 0.4}
TRAIN_WARM_STEPS, TRAIN_WARM_LR, TRAIN_TIMED_STEPS = 3, 1e-5, 20
# phase 12: the scoring path.  tools.evaluate's rows at full width, cut from
# the reference's 225 scans to N_EVAL_SCANS (warm-up 27 as the tool scores);
# the ATE bars are tests/test_robustness.py's tightened toward the JAX
# package's 225-scan figures (artifacts/EVAL_r05_robustness.json); the
# unaided tunnel diverges (ATE reported, None) and its degenerate-direction
# count stays 0 after the warm-up at 60 scans in both packages (the reference
# reached 1 later in its 225), so the weak-direction count must fire there.
N_EVAL_SCANS = 60
EVAL_ATE_BARS = {"circle": 0.02, "high_yaw": 0.02, "corridor": 0.05, "tunnel": None,
                 "tunnel_wheelspeed": 0.3, "imu_bias": 0.02}
# tools.loc_eval on the figure-eight world at radius 8 m (the reference's
# 30 m maps 900 scans), 0.4 laps, no dropout, 16,384 points a scan: a map
# with keyframes and a loop; then the drive relocalised and tracking.  With
# the side LIO (lio_fusion, the tool's default) both packages go metres off
# on this world (the side LIO starts cold at the drive's 5 m/s, ROADMAP queue
# C): the JAX package's figures at these knobs on the CPU (jax 0.9.0) and a
# margin of a quarter to a half of them; without it (--no-lio-fusion) the
# bars proposed from artifacts/EVAL_r05_loc_fig8.json hold.
LOC_EVAL_RADIUS, LOC_EVAL_LAPS, LOC_EVAL_POINTS = 8.0, 0.4, 16384
LOC_EVAL_MIN_KEYFRAMES, LOC_EVAL_TRACKING = 10, 0.9
LOC_EVAL_RMSE_M, LOC_EVAL_HEADING_DEG = 0.3, 1.0
JAX_LOC_EVAL_FUSION = {"rmse_x_tracking_m": 2.256, "rmse_y_tracking_m": 3.6696,
                       "rmse_heading_tracking_deg": 14.892}
LOC_EVAL_FUSION_MARGIN = {"rmse_x_tracking_m": 1.0, "rmse_y_tracking_m": 1.0,
                          "rmse_heading_tracking_deg": 5.0}
# tools.eval_detection at its defaults: the reference's fp32 mean AP at the
# WOD IoUs (artifacts/EVAL_r05_detection.json)
JAX_DET_MEAN_AP_WOD, DET_EVAL_MARGIN = 0.508, 0.01
# calibration: the tilted mount (roll, pitch deg, height m) and its bars;
# lidar-INS within these of the identity extrinsic, in heading: the 12b map's
# keyframes are ~0.09 m off in height, which tilts a fit of the planar
# drive's positions by 0.92 deg (rehearse_scoring; the card's run alike)
CALIB_MOUNT, CALIB_ANGLE_DEG, CALIB_HEIGHT_M = (2.5, -1.8, 1.9), 0.2, 0.02
LIDAR_INS_DEG, LIDAR_INS_M = 0.5, 0.1
# phase 13: the online system.  ONLINE_SCANS scans of the 8 m ring sent as
# Custom datagrams at 10 Hz wall clock and GPCHC at ONLINE_INS_HZ; the SLAM
# stage must integrate at least ONLINE_MIN_INTEGRATED frames, and the
# offline replay of what it processed must give its poses within
# ONLINE_REPLAY_ATOL_M.  The RMSE bar of the LIO against the truth was set
# before the first card run from rehearse_online() on the CPU: the GPCHC
# stream's GPS-time stamps give every online frame an empty IMU window, and
# without IMU rows the LIO stays near its seed in both packages (124 frames:
# JAX 11.912 m, the port 11.912 m; python -m tests.test_torch_online_sources
# <dir>; ROADMAP queue C); the bar is 1 m above that
ONLINE_SCANS, ONLINE_DATAGRAM_POINTS, ONLINE_INS_HZ = 150, 4093, 100
ONLINE_MIN_INTEGRATED, ONLINE_REPLAY_ATOL_M, ONLINE_RMSE_BAR_M = 20, 1e-4, 12.9
ONLINE_RECV_FRAMES, ONLINE_CLI_TIMEOUT_S = 5, 120
# phase 14: multi-device code at world size 1 on the card (and 2 gloo ranks
# on it).  The sharded step and lio_step do the same arithmetic at world
# size 1 (one table of the whole capacity, one rank's partials), so each
# scan's position is held to 1e-4 m; the sharded PGO to optimize at the
# reference test's 1e-3 (tests/test_sharded_pgo.py) and Schur at 5e-3
# (tests/test_schur_pgo.py); the card's merge to the 8-rank CPU merge at
# 1e-3 m
MD_SCANS, MD_GLOO_SCANS, MD_POS_ATOL_M = 30, 10, 1e-4
MD_PGO_ATOL_M, MD_SCHUR_ATOL_M, MD_MERGE_ATOL_M = 1e-3, 5e-3, 1e-3
MD_INIT_TIMEOUT_S, MD_MERGE_TIMEOUT_S = 60, 600
# phase 14f: each trainer's optimizer update from its own gradient, per
# leaf (measured on an H100 at world size 1: cosine above 0.99999999, norm
# gap at most 1.2e-4; an optimizer configured otherwise, or a gradient
# averaged wrongly, moves them by orders of magnitude)
MD_UPDATE_COS, MD_UPDATE_GAP = 0.999, 5e-3
# phase 15 (see the docstring).  The format chains' ATE bars were set before
# the first card run from the JAX package's tool at this cut on the CPU (jax
# 0.9.0: python -m lsd_tpu.tools.eval_formats --scans 60 --platform cpu; 60 and
# 58 frames paired); NCLT's packet framing drops scans, hence FMT_MIN_FRAMES.
# The profile's trace holds thousands of launches a step (233 MB for 8 steps on
# an H100), hence N_PROFILE_FRAMES.  12b's side-LIO run and loc_diag run under
# deterministic algorithms: with the default ones the two parted by up to
# 6 mm over the same 40 frames on the card
N_FMT_SCANS, FMT_ATE_MARGIN_M, FMT_MIN_FRAMES = 60, 0.05, 0.9
JAX_FMT_ATE = {"rosbag": 0.13428257211903147, "nclt": 0.33368374371429477}
EXPORT_POINTS, EXPORT_ATOL = 2 ** 17, 1e-5
N_PROFILE_FRAMES, N_LOC_DIAG, LOC_DIAG_ATOL_M = 8, 40, 1e-3
LOC_EVAL_MAP_LAPS, CAMPAIGN_DIAG_ATOL_M = 1.15, 1e-3   # tools/loc_eval.py:build_map's laps
ROOFLINE_REPS, N_BENCH_P2P_SCANS, SCALING_REPS = 10, 30, 1
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12             # fp32 outside the tensor cores

# fp32 operations per point of the fused reduction without extrinsic
# estimation (the main path's flag), counted from csrc/p2p_reduce.cu: every
# point is transformed to the world frame and gated (18 + 18 + 6 + 6 + 5 =
# 53); a point that passes the gate also builds its 6 pose Jacobian entries
# (15 + 12 = 27) and accumulates them (6 + 2 * 21 + 2 * 6 + 3 = 63, a fused
# multiply-add counted as 2).  The 57 extrinsic sums are zero and need no
# work.
P2P_OPS_GATE, P2P_OPS_VALID = 53, 53 + 27 + 63

# fp32 operations per valid IMU slot of csrc/imu_propagate.cu: F P and
# (F P) F^T dense, 24^3 multiply-adds each (counted as 2), and the 24 noise
# terms; the nominal update (~250) is left out.  A masked slot does none.
IMU_OPS_VALID = 2 * 2 * 24 ** 3 + 2 * 24
H100_BF16_FLOPS = 989e12            # bf16 tensor cores, dense
# phase 2b: the set-attention kernel against its plain version, as a share of
# the largest output: both sum in float32 in another order before one bf16
# rounding, so an output can land one bf16 step (2^-8 of it) apart
DSVT_ATTN_TOL = 1e-2
DSVT_SEED = 11
# phase 2: the gate kernel against its plain version: both decompose the
# same float32 block, the kernel in float64, the plain version in float32;
# E's entries are those of a projection (at most 1), and the blocks' kept
# and dropped eigenvalues lie at least 3.5 times the threshold apart
GATE_TOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def time_ms(fn, n=N_TIMING):
    """Median milliseconds of ``fn()`` over n calls, each between CUDA events."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, match="", n=N_TIMING, tries=5, required=True, launches=None):
    """(device ms, kernels, whole) per ``fn()``: the summed time and the
    count of the kernels whose name contains ``match`` that n calls launch,
    from the profiler's device trace, over n.  With ``launches``, a
    kernel's ``LaunchCount``, the kernels are counted where they run
    instead, exactly, and a count that is not a whole number a call fails
    the run.  The profiler now and then drops kernel records from a trace
    or carries some over from before it: an empty trace is taken first, to
    take what an earlier one left behind, then a trace that holds the
    kernels of every call is sought, up to ``tries`` traces.  Where one is
    found, ``whole`` is True.  Else the last trace gives each kernel name's
    mean time, taken as many times a call as the trace holds it rounded
    (the exact count with ``launches``), and ``whole`` is False; where it
    holds no kernel at all the run fails, or, when the time is not
    ``required``, (None, 0, False) is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        pass
    for k in range(tries):
        if launches is not None:
            launches.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key]
        count = sum(e.count for e in ev)
        if launches is None:
            per_call = round(count / n)
        else:
            launched = launches.read()
            if launched % n:
                fail(f"{launches.name}: {launched} launches counted on the device for {n} calls")
            per_call = launched // n
        if per_call >= 1 and count == per_call * n:
            if k:
                log(f"the profiler dropped records of {match or 'all'!r} kernels in "
                    f"{k} trace(s), taken again")
            return sum(e.self_device_time_total for e in ev) / 1e3 / n, per_call, True
    if per_call >= 1 and count:
        # records dropped or carried over leave each name's mean time as it was
        ms = sum(e.self_device_time_total / e.count
                 * (per_call if launches is not None else round(e.count / n)) for e in ev) / 1e3
        log(f"no trace of {match or 'all'!r} kernels was whole in {tries} ({count} records "
            f"for {per_call * n} launches in the last): device time from each kernel's mean")
        return ms, per_call, False
    msg = (f"the profiler recorded {count} kernels matching {match!r} for {n} calls "
           f"in the last of {tries} traces")
    if required:
        fail(msg)
    log(msg + "; no device time taken")
    return None, 0, False


def partial_traces(whole: bool, plain_whole: bool) -> dict:
    """For a kernel's report: which of its device times ``device_ms`` took
    from each kernel's mean in a trace that missed records, if any."""
    names = [k for k, ok in (("ms", whole), ("plain_ms", plain_whole)) if not ok]
    return dict(from_partial_trace=names) if names else {}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_run(dev, n_scans=N_WARM + N_BENCH):
    """Scans on the device, the initial navigation state and the config."""
    import torch
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.tools.profile_lio import BENCH_CFG as cfg, nav_at_start

    sim = CircleSim(SimConfig(n_scans=n_scans, points_per_scan=CAP,
                              point_noise=0.01, seed=7))
    data = sim.generate(capacity=CAP, imu_capacity=IMU_CAP)
    nav0 = nav_at_start(sim, dev)
    scans = [tuple(torch.as_tensor(a, device=dev) for a in d[:5]) for d in data]
    gt = np.stack([d[5] for d in data])
    return cfg, nav0, scans, gt


def p2p_inputs(cfg, st, scan):
    """The fused reduction's first-iteration inputs for ``scan`` at state ``st``."""
    from lsd_tpu_torch.slam.lio import p2p_weight, scan_front
    front = scan_front(cfg, st, *scan)
    nav = front.nav_prop
    normals, dpl, _, _ = front.planes
    return (front.ds_pts, normals, dpl, p2p_weight(cfg, front.ds_mask, front.planes),
            nav.rot, nav.ext_rot, nav.ext_t, nav.pos)


def compare_p2p(args, max_resid):
    """Hold the p2p kernel against its plain version on ``args``, with and
    without the extrinsic block, on a ragged length, all points masked, and
    in the 8-block cluster; returns the largest absolute error."""
    import torch
    from lsd_tpu_torch.ops.p2p import _launch, launch_shape, p2p_reduce, p2p_reduce_plain

    n_full = args[0].shape[0]
    zero_w = torch.zeros_like(args[3])
    cases = [("N=%d est_ext=0" % n_full, args, False),
             ("N=%d est_ext=1" % n_full, args, True),
             ("N=%d ragged est_ext=0" % (n_full - 37),
              tuple(a[:n_full - 37] if a.dim() and a.shape[0] == n_full else a
                    for a in args), False),
             ("N=%d ragged est_ext=1" % (n_full - 37),
              tuple(a[:n_full - 37] if a.dim() and a.shape[0] == n_full else a
                    for a in args), True),
             ("N=%d all-masked" % n_full, args[:3] + (zero_w,) + args[4:], False)]
    blocks, threads = launch_shape(args[0].device)
    if blocks == 16:
        # the 8-block cluster that a card without room for 16 falls back to
        # (called directly: these launches are not the main path's)
        cases += [(f"{name}, 8-block cluster", a, est, 8) for name, a, est in cases[:2]]
    max_err = 0.0
    for name, a, est, *cluster in cases:
        if cluster:
            call = lambda: tuple(_launch(a, max_resid, est, cluster[0]).split_with_sizes(
                (24 * 24, 24, 3)))
        else:
            call = lambda: p2p_reduce(*a, max_resid, est_extrinsic=est)
        HtH, Htr, st = call()
        HtH2, Htr2, st2 = call()
        HtH, HtH2 = HtH.view(24, 24), HtH2.view(24, 24)
        torch.cuda.synchronize()
        if not (torch.equal(HtH, HtH2) and torch.equal(Htr, Htr2) and torch.equal(st, st2)):
            fail(f"p2p_reduce {name}: two launches differ bitwise")
        rH, rr, rs = p2p_reduce_plain(*a, max_resid, est_extrinsic=est)
        err_H = float((HtH - rH).abs().max())
        err_r = float((Htr - rr).abs().max())
        tol_H = 1e-5 * float(rH.abs().max())
        tol_r = 1e-4 * max(float(rr.abs().max()), 1.0)
        nv, rnv = float(st[0]), float(rs[0])
        # n_valid is exact: the kernel, built without FMA contraction, rounds
        # each operation of the gate as the plain version does
        ok = (err_H <= tol_H and err_r <= tol_r and nv == rnv
              and abs(float(st[1]) - float(rs[1])) <= 1e-5 * abs(float(rs[1])) + 1e-6
              and abs(float(st[2]) - float(rs[2])) <= 1e-5 * abs(float(rs[2])) + 1e-6)
        log(f"p2p_reduce {name}: n_valid {nv:.0f} (plain {rnv:.0f}) "
            f"|dHtH| {err_H:.3e} <= {tol_H:.3e}, |dHtr| {err_r:.3e} <= {tol_r:.3e}, "
            f"sum|r| {float(st[1]):.6g} (plain {float(rs[1]):.6g}), bitwise repeatable")
        if not ok:
            fail(f"p2p_reduce {name}: kernel disagrees with its plain version")
        max_err = max(max_err, err_H, err_r)
    return max_err


def check_p2p(args, max_resid, report):
    """Hold the p2p kernel against its plain version; time both."""
    import torch
    from lsd_tpu_torch.ops.p2p import _launch, launch_shape, p2p_reduce, p2p_reduce_plain

    max_err = compare_p2p(args, max_resid)
    check_p2p_graph(args, max_resid)
    blocks, threads = launch_shape(args[0].device)

    # times at the main path's shape and flag: device time per call of the
    # kernel (of all the plain version's kernels), and each call's time
    # between CUDA events; the launch floor is the device time of a
    # one-element op
    ms, per_call, whole = device_ms(lambda: p2p_reduce(*args, max_resid), match="p2p_",
                                    launches=p2p_reduce.launches)
    if per_call != 1:
        fail(f"p2p_reduce: {per_call} launches per call counted on the device, expected 1")
    plain_ms, plain_kernels, plain_whole = device_ms(lambda: p2p_reduce_plain(*args, max_resid))
    one = torch.zeros(1, device=args[0].device)
    floor_ms, _, _ = device_ms(lambda: one.add_(1.0))
    ms_8 = (device_ms(lambda: _launch(args, max_resid, False, 8), match="p2p_",
                      launches=p2p_reduce.launches)[0]
            if blocks == 16 else None)
    call_ms = time_ms(lambda: p2p_reduce(*args, max_resid))
    plain_call_ms = time_ms(lambda: p2p_reduce_plain(*args, max_resid))
    n = args[0].shape[0]
    n_valid = float(p2p_reduce_plain(*args, max_resid)[2][0])
    in_bytes = n * 8 * 4 + 24 * 4                 # points, normals, d, weight; pose
    out_bytes = (24 * 24 + 24 + 3) * 4
    ops = n_valid * P2P_OPS_VALID + (n - n_valid) * P2P_OPS_GATE
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    log(f"p2p_reduce N={n}: device time per call: kernel {ms:.5f} ms ({per_call:.0f} "
        f"launch, one cluster of {blocks} blocks x {threads} threads; an 8-block "
        f"cluster: {'-' if ms_8 is None else f'{ms_8:.5f}'} ms), plain {plain_ms:.5f} ms ({plain_kernels} kernels); call time "
        f"(CUDA events, median of {N_TIMING}): kernel {call_ms:.4f} ms, plain "
        f"{plain_call_ms:.4f} ms; bound {max(t_bytes, t_ops):.6f} ms "
        f"({in_bytes + out_bytes} B, {ops:.0f} fp32 ops, {n_valid:.0f} valid); "
        f"launch floor {floor_ms:.5f} ms; no single PyTorch call computes this "
        f"function (library time: none)")
    report.update(name="p2p_reduce", route="cuda",
                  source="lsd_tpu_torch/csrc/p2p_reduce.cu",
                  replaces="lsd_tpu/ops/pallas_p2p.py:43",
                  max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                  bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                  library_ms=None, floor_ms=floor_ms, call_ms=call_ms,
                  plain_call_ms=plain_call_ms, cluster_blocks=blocks, block_threads=threads,
                  ms_8_block_cluster=ms_8, **partial_traces(whole, plain_whole))


def check_p2p_graph(args, max_resid):
    """A call captured in a CUDA graph and replayed equals a direct call,
    bitwise, and the replay reads the inputs as they are at replay."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    args = tuple(a.clone() for a in args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        p2p_reduce(*args, max_resid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = p2p_reduce(*args, max_resid)
    for scale in (1.0, 0.5):
        args[3].mul_(scale)
        graph.replay()
        direct = p2p_reduce(*args, max_resid)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(captured, direct)):
            fail(f"p2p_reduce: a CUDA-graph replay differs from a direct call (weights x{scale})")
    log("p2p_reduce: CUDA-graph replay equals a direct call bitwise, twice")


def imu_inputs(cfg, st, scan, slots):
    """``propagate``'s inputs at state ``st`` with ``scan``'s IMU batch laid
    into ``slots`` slots: its own rows first, the rest masked out."""
    import torch
    imu, mask = scan[3], scan[4]
    pad = slots - imu.shape[0]
    imu = torch.cat([imu, imu.new_zeros(pad, 7)]).contiguous()
    mask = torch.cat([mask, mask.new_zeros(pad)]).contiguous()
    return st.nav, st.P, imu, mask, cfg.imu_noise, cfg.acc_scale


def compare_imu(args):
    """Hold the IMU kernel against ``propagate_plain`` on ``args``: two
    launches bitwise equal, state and track within rtol 1e-5 and atol 1e-6
    (float32 rounding of the same recursion), P within 1e-5 of its largest
    entry (the kernel sums each product in a fixed order, the plain version
    through cuBLAS); returns the largest absolute error."""
    import torch
    from lsd_tpu_torch.slam.imu import propagate, propagate_plain

    def flat(res):
        st, P, tr = res
        return [st.quat, st.pos, st.vel, P, tr["quat"], tr["pos"], tr["vel"]]
    out, again = flat(propagate(*args)), flat(propagate(*args))
    ref = flat(propagate_plain(*args))
    torch.cuda.synchronize()
    slots, valid = args[2].shape[0], int(args[3].sum())
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"imu_propagate M={slots}: two launches differ bitwise")
    errs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    p_tol = 1e-5 * float(ref[3].abs().max())
    ok = errs[3] <= p_tol and all(
        torch.allclose(a, b, rtol=1e-5, atol=1e-6) for k, (a, b) in enumerate(zip(out, ref))
        if k != 3)
    log(f"imu_propagate M={slots} ({valid} valid): |dquat| {errs[0]:.3e}, |dpos| "
        f"{errs[1]:.3e}, |dvel| {errs[2]:.3e}, |dP| {errs[3]:.3e} <= {p_tol:.3e}, track "
        f"{max(errs[4:]):.3e}, bitwise repeatable")
    if not ok:
        fail(f"imu_propagate M={slots}: kernel disagrees with propagate_plain")
    return max(errs)


def check_imu_graph(args):
    """A propagation captured in a CUDA graph and replayed equals a direct
    call bitwise, and the replay reads the IMU rows as they are at replay."""
    import torch
    from lsd_tpu_torch.slam.imu import propagate
    args = list(args)
    args[2] = args[2].clone()
    flat = lambda r: [r[0].quat, r[0].pos, r[0].vel, r[1], r[2]["quat"], r[2]["pos"]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        propagate(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flat(propagate(*args))
    for scale in (1.0, 0.5):
        args[2][:, 1:4].mul_(scale)
        graph.replay()
        direct = flat(propagate(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(captured, direct)):
            fail(f"imu_propagate: a CUDA-graph replay differs from a direct call (gyro x{scale})")
    log("imu_propagate: CUDA-graph replay equals a direct call bitwise, twice")


def dsvt_inputs(dev, seed=DSVT_SEED):
    """A bench-size frame for the set-attention kernel: its four partitions
    (shift 0 and 1, x and y), seeded bf16 per-pillar Q and K (one (P, 384)
    tensor, as the layer projects them) and V, and the frame's pillars."""
    import torch
    from lsd_tpu_torch.models.detector import DetectorConfig
    from lsd_tpu_torch.models.dsvt import DSVTConfig, partition_shift
    from lsd_tpu_torch.ops.voxelize import pillarize_dynamic
    from port_bench.gen import street
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "port_bench", "traffic", "urban-drive-waymo-top.json")) as f:
        tr = json.load(f)
    pts = torch.as_tensor(street.Street(tr, seed).frame(0), device=dev)
    cfg = DetectorConfig.dsvt_pillar()
    _, _, _, coords, pmask, _ = pillarize_dynamic(
        pts, torch.ones(len(pts), dtype=torch.bool, device=dev), cfg.voxel_size, cfg.pc_range,
        cfg.max_voxels)
    parts = []
    for win, sh in DSVTConfig().shifts():
        parts += partition_shift(coords, pmask, win, sh, cfg.grid_hw, DSVTConfig().set_size)[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    P, D = cfg.max_voxels, cfg.pillar_filters
    qk = torch.randn(P, 2 * D, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(P, D, generator=g, device=dev).to(torch.bfloat16)
    return qk, v, parts, int(pmask.sum())


def check_dsvt(dev, report):
    """Hold the set-attention kernel against ``set_attention_plain`` on each
    partition of a bench-size frame; graph replay; time both."""
    import torch
    from lsd_tpu_torch.models.dsvt import set_attention, set_attention_plain
    qk, v, parts, pillars = dsvt_inputs(dev)
    D = v.shape[1]
    q, k = qk[:, :D], qk[:, D:]
    max_err = 0.0
    for part in parts:
        got = set_attention(q, k, v, part, 8)
        again = set_attention(q, k, v, part, 8)
        want = set_attention_plain(q, k, v, part, 8)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail("dsvt_set_attn: two launches on the same inputs differ")
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        max_err = max(max_err, err)
        if not err <= DSVT_ATTN_TOL:
            fail(f"dsvt_set_attn: {err:.3g} of the largest output off its plain version "
                 f"(bar {DSVT_ATTN_TOL})")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        set_attention(q, k, v, parts[0], 8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = set_attention(q, k, v, parts[0], 8)
    v.mul_(0.5)                        # the replay reads V as it is now
    graph.replay()
    direct = set_attention(q, k, v, parts[0], 8)
    torch.cuda.synchronize()
    if not torch.equal(captured, direct):
        fail("dsvt_set_attn: a CUDA-graph replay differs from a direct call")

    part = parts[0]
    n0 = set_attention.launches
    set_attention(q, k, v, part, 8)
    if set_attention.launches - n0 != 1:
        fail(f"dsvt_set_attn: a call launched {set_attention.launches - n0} kernels, expected 1")
    ms, per_call, whole = device_ms(lambda: set_attention(q, k, v, part, 8),
                                    match="dsvt_set_attn")
    if per_call != 1:
        fail(f"dsvt_set_attn: the profiler saw {per_call} kernels per call, expected 1")
    plain_ms, plain_kernels, plain_whole = device_ms(
        lambda: set_attention_plain(q, k, v, part, 8), n=10)
    one = torch.zeros(1, device=dev)
    floor_ms, _, _ = device_ms(lambda: one.add_(1.0))
    call_ms = time_ms(lambda: set_attention(q, k, v, part, 8))
    plain_call_ms = time_ms(lambda: set_attention_plain(q, k, v, part, 8), n=10)
    sets, slots = int(part.n_sets), part.inds.shape[1]
    in_bytes = pillars * 3 * D * 2 + sets * slots * 5       # q, k, v rows; index and flags a slot
    out_bytes = pillars * D * 2
    ops = sets * 2 * 2 * slots * slots * D
    t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_BF16_FLOPS * 1e3
    log(f"dsvt_set_attn at {pillars} pillars, {sets} sets of {slots} (shift 0, x): device time "
        f"per call: kernel {ms:.5f} ms ({per_call} launch of {part.inds.shape[0]} blocks x 288 "
        f"threads), plain {plain_ms:.5f} ms ({plain_kernels} kernels); call time (CUDA "
        f"events, median): kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; bound "
        f"{max(t_bytes, t_ops):.6f} ms ({in_bytes + out_bytes} B, {ops} bf16 ops); launch "
        f"floor {floor_ms:.5f} ms; largest gap to the plain version {max_err:.3g} of the "
        f"largest output; no single PyTorch call computes this function (library time: none)")
    report.update(name="dsvt_set_attn", route="cuda", source="lsd_tpu_torch/csrc/dsvt_set_attn.cu",
                  replaces="none (the JAX package has no transformer)", max_abs_err=max_err,
                  pillars=pillars, sets=sets, ms=ms, plain_ms=plain_ms,
                  plain_kernels=plain_kernels, call_ms=call_ms, plain_call_ms=plain_call_ms,
                  floor_ms=floor_ms, bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
                  **partial_traces(whole, plain_whole))


def check_imu(cfg, st, scan, report):
    """Hold the IMU kernel against ``propagate_plain`` at the scan's 16
    slots and laid into 64; time both at each."""
    import torch
    from lsd_tpu_torch.slam.imu import propagate, propagate_plain

    report.update(name="imu_propagate", route="cuda",
                  source="lsd_tpu_torch/csrc/imu_propagate.cu",
                  replaces="lax.scan of lsd_tpu/slam/imu.py:propagate (no Pallas kernel)",
                  max_abs_err=0.0, library_ms=None)
    for slots in (IMU_CAP, 64):
        args = imu_inputs(cfg, st, scan, slots)
        report["max_abs_err"] = max(report["max_abs_err"], compare_imu(args))
        if slots == IMU_CAP:
            check_imu_graph(args)
        ms, per_call, whole = device_ms(lambda: propagate(*args), match="imu_propagate",
                                        launches=propagate.launches)
        if per_call != 1:
            fail(f"imu_propagate: {per_call} launches per call counted on the device, "
                 "expected 1")
        # the plain version makes thousands of launches a call: fewer calls
        plain_ms, plain_kernels, plain_whole = device_ms(lambda: propagate_plain(*args), n=10)
        call_ms = time_ms(lambda: propagate(*args))
        plain_call_ms = time_ms(lambda: propagate_plain(*args), n=10)
        valid = int(args[3].sum())
        in_bytes = (24 * 24 + 19) * 4 + slots * (7 * 4 + 1)   # P, state; IMU rows, mask
        out_bytes = (24 * 24 + 10 + 10 * slots) * 4             # P, state, track
        ops = valid * IMU_OPS_VALID
        t_bytes = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_FP32_FLOPS * 1e3
        log(f"imu_propagate M={slots} ({valid} valid): device time per call: kernel "
            f"{ms:.5f} ms ({per_call} launch), plain {plain_ms:.5f} ms ({plain_kernels} "
            f"kernels); call time (CUDA events, median): kernel {call_ms:.4f} ms, plain "
            f"{plain_call_ms:.4f} ms; bound {max(t_bytes, t_ops):.6f} ms "
            f"({in_bytes + out_bytes} B, {ops} fp32 ops); no single PyTorch call "
            f"computes this function (library time: none)")
        report[f"m{slots}"] = dict(valid=valid, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                   plain_kernels=plain_kernels, plain_call_ms=plain_call_ms,
                                   **partial_traces(whole, plain_whole),
                                   bound_ms=max(t_bytes, t_ops),
                                   bound_by="bytes" if t_bytes >= t_ops else "operations")


def gate_blocks(cfg, seed=0):
    """HtH matrices whose pose blocks have 0 to 3 eigenvalues under
    ``degen_thresh`` (the rest 4 to 20 times over it), in random bases."""
    rng = np.random.default_rng(seed)
    out = []
    for n_small in range(4):
        lam = np.concatenate([rng.uniform(0.0, 0.5, n_small),
                              rng.uniform(4.0, 20.0, 6 - n_small)]) * cfg.degen_thresh
        Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
        H = np.eye(24) * 3.0
        H[:6, :6] = (Q * lam) @ Q.T
        out.append((n_small, H.astype(np.float32)))
    return out


def check_gate(cfg, HtH, report):
    """Hold the gate kernel against ``_gate_degenerate_plain`` on the main
    path's ``HtH`` and on ``gate_blocks``: E within GATE_TOL, counts equal,
    two launches bitwise equal, a CUDA-graph replay equal to a direct call;
    time both."""
    import torch
    from lsd_tpu_torch.slam.lio import _gate_degenerate, _gate_degenerate_plain
    dev = HtH.device
    cases = [("main path", None, HtH)] + [
        (f"{n} under the threshold", n, torch.as_tensor(H, device=dev))
        for n, H in gate_blocks(cfg)]
    max_err = 0.0
    for name, n_small, H in cases:
        got, again = _gate_degenerate(cfg, H), _gate_degenerate(cfg, H)
        want = _gate_degenerate_plain(cfg, H)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"lio_gate ({name}): two launches differ bitwise")
        err = float((got[0] - want[0]).abs().max())
        counts, want_counts = [int(got[1]), int(got[2])], [int(want[1]), int(want[2])]
        log(f"lio_gate ({name}): |dE| {err:.3e} <= {GATE_TOL}, n_degenerate/n_weak "
            f"{counts} (plain {want_counts}), bitwise repeatable")
        if err > GATE_TOL or counts != want_counts or (
                n_small is not None and counts[0] != n_small):
            fail(f"lio_gate ({name}): kernel disagrees with _gate_degenerate_plain")
        max_err = max(max_err, err)
    H = HtH.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _gate_degenerate(cfg, H)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _gate_degenerate(cfg, H)
    H[:6, :6].mul_(0.5)
    graph.replay()
    direct = _gate_degenerate(cfg, H)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(captured, direct)):
        fail("lio_gate: a CUDA-graph replay differs from a direct call")
    log("lio_gate: CUDA-graph replay equals a direct call bitwise")

    ms, per_call, whole = device_ms(lambda: _gate_degenerate(cfg, HtH), match="lio_gate",
                                    launches=_gate_degenerate.launches)
    if per_call != 1:
        fail(f"lio_gate: {per_call} launches per call counted on the device, expected 1")
    plain_ms, plain_kernels, plain_whole = device_ms(
        lambda: _gate_degenerate_plain(cfg, HtH), n=20)
    call_ms = time_ms(lambda: _gate_degenerate(cfg, HtH))
    plain_call_ms = time_ms(lambda: _gate_degenerate_plain(cfg, HtH), n=20)
    # the 6x6 block read once (144 B), E and the two counts written
    in_bytes, out_bytes = 36 * 4, 24 * 24 * 4 + 2 * 4
    bound_ms = (in_bytes + out_bytes) / H100_BYTES_PER_S * 1e3
    log(f"lio_gate: device time per call: kernel {ms:.5f} ms ({per_call} launch of one "
        f"block x 64 threads), plain {plain_ms:.5f} ms ({plain_kernels} kernels, with "
        f"its waits); call time (CUDA events, median): kernel {call_ms:.4f} ms, plain "
        f"{plain_call_ms:.4f} ms; bound {bound_ms:.7f} ms ({in_bytes + out_bytes} B; its "
        f"~2,000 fp64 operations a decomposition take less); no single PyTorch call "
        f"computes this function without waiting (library time: none)")
    report.update(name="lio_gate", route="cuda", source="lsd_tpu_torch/csrc/lio_gate.cu",
                  replaces="jnp.linalg.eigh of lsd_tpu/slam/lio.py:_gate_degenerate "
                           "(no Pallas kernel)",
                  max_abs_err=max_err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                  plain_kernels=plain_kernels, plain_call_ms=plain_call_ms,
                  bound_ms=bound_ms, bound_by="bytes", library_ms=None,
                  **partial_traces(whole, plain_whole))


class CallTimer:
    """Replaces ``owner.name`` by a wrapper that times each call, until
    ``restore()``: between two CUDA events (``ms()`` then gives device-side
    milliseconds) or, with ``host=True``, on the host clock between two
    synchronizes.  Keeps each call's arguments, result and thread."""

    def __init__(self, owner, name, host=False):
        self.owner, self.name, self.fn, self.host = owner, name, getattr(owner, name), host
        self.spans, self.args, self.results, self.threads = [], [], [], []
        setattr(owner, name, self)

    def __call__(self, *args, **kwargs):
        import torch
        if self.host:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.spans.append((time.perf_counter() - t0) * 1e3)
        else:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.fn(*args, **kwargs)
            b.record()
            self.spans.append((a, b))
        self.args.append(args)
        self.results.append(out)
        self.threads.append(threading.current_thread().name)
        return out

    def restore(self):
        setattr(self.owner, self.name, self.fn)

    def ms(self):
        import torch
        if self.host:
            return list(self.spans)
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.spans]


def run_mapping(dev, card, lio_cfg, map_dir, n_scans=N_MAPPING, points=CAP):
    """Phase 4: the mapping path, its map saved into ``map_dir``; returns
    (report, the simulator, the scans)."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam import mapper as mapper_mod
    from lsd_tpu_torch.slam.map_io import load_map
    from lsd_tpu_torch.tools.profile_lio import mapping_run, sync_sites

    t0 = time.perf_counter()
    sim, data, nav0, mcfg = mapping_run(dev, n_scans, points, lio_cfg)
    log(f"mapping: made {len(data)} scans of {points} points in {time.perf_counter() - t0:.1f} s")
    mapper = mapper_mod.Mapper(mcfg, nav0)
    pgo = CallTimer(mapper_mod, "optimize")
    icp = CallTimer(mapper_mod, "icp_point_to_plane")
    syncs = {True: [], False: []}                  # by is_keyframe
    sync_sites_seen = {}
    p2p_reduce.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # scans arrive as host arrays, as the sensor delivers them
    for k, d in enumerate(data):
        step = lambda: mapper.process_scan(*d[:5], stamp_us=int(k * 1e5))
        if k in SYNC_COUNT_SCANS:
            out, sites = sync_sites(step)
            syncs[out["is_keyframe"]].append(sum(sites.values()))
            for site, n in sites.items():
                sync_sites_seen[site] = sync_sites_seen.get(site, 0) + n
        else:
            step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p2p_reduce.launches.read()
    if launches != lio_cfg.max_iters * n_scans:
        fail(f"mapping: p2p_reduce launched {launches} times over {n_scans} scans, "
             f"expected max_iters x scans = {lio_cfg.max_iters * n_scans}")
    loops_in_run = len(mapper.loops)
    mapper.save(map_dir)                           # runs one more PGO
    loaded = load_map(map_dir)
    pgo.restore()
    icp.restore()
    pgo_ms, icp_ms = pgo.ms(), icp.ms()

    n_kf = len(mapper.store)
    if not n_kf > 15:
        fail(f"mapping: {n_kf} keyframes, expected more than 15")
    if mapper.loop_stats["accepted"] < 1:
        fail(f"mapping: no loop was accepted; loop_stats {mapper.loop_stats}")
    traj = mapper.trajectory()
    gt = np.stack([d[5] for d in data])
    if traj.shape != (n_scans, 4, 4) or not np.isfinite(traj).all():
        fail(f"mapping: trajectory of shape {traj.shape} is not {n_scans} finite poses")
    rmse = float(np.sqrt(np.mean(np.sum((traj[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1))))
    if not rmse < MAPPING_RMSE_LIMIT_M:
        fail(f"mapping: trajectory RMSE {rmse} m is not below {MAPPING_RMSE_LIMIT_M} m")
    all_costs = check_pgo_costs("mapping", pgo, flat=(len(pgo.results) - 1,))
    if len(loaded["poses"]) != n_kf or len(loaded["edges"]) < n_kf - 1:
        fail(f"mapping: the saved map loads {len(loaded['poses'])} poses and "
             f"{len(loaded['edges'])} edges for {n_kf} keyframes")
    for T, kf in zip(loaded["poses"], mapper.store.frames):
        if not np.allclose(T, kf.pose, atol=1e-5):
            fail(f"mapping: keyframe {kf.id}'s pose does not survive save and load")
    report = dict(
        card=card, scans=n_scans, points_per_scan=points,
        ms_per_scan=dt / n_scans * 1e3, scans_per_s=n_scans / dt,
        keyframes=n_kf, loops=loops_in_run, loop_stats=mapper.loop_stats,
        rmse_m=rmse, pgo_solves=len(pgo_ms), pgo_ms_median=float(np.median(pgo_ms)),
        pgo_ms_max=float(np.max(pgo_ms)),
        pgo_costs_first_last=all_costs[:, [0, -1]].tolist(),
        icp_candidates=len(icp_ms),
        icp_ms_per_candidate=float(np.median(icp_ms)) if icp_ms else None,
        host_syncs_per_keyframe_scan=float(np.mean(syncs[True])) if syncs[True] else None,
        host_syncs_per_other_scan=float(np.mean(syncs[False])) if syncs[False] else None,
        host_sync_sites=sync_sites_seen, p2p_launches=launches,
        loaded_poses=len(loaded["poses"]), loaded_edges=len(loaded["edges"]))
    log(f"mapping, {n_scans} scans of {points} points on {card}: "
        f"{report['ms_per_scan']:.2f} ms/scan, {n_kf} keyframes, {loops_in_run} loops, "
        f"loop_stats {mapper.loop_stats}, RMSE {rmse:.4f} m, PGO {len(pgo_ms)} solves "
        f"median {report['pgo_ms_median']:.1f} ms, ICP {len(icp_ms)} candidates median "
        f"{report['icp_ms_per_candidate']} ms, host syncs per scan "
        f"{report['host_syncs_per_keyframe_scan']} (keyframe) / "
        f"{report['host_syncs_per_other_scan']} (other), p2p_reduce launches {launches}")

    report["async"] = run_mapping_async(mapper_mod, mcfg, nav0, data, gt)
    return report, sim, data


def pgo_cost64(graph, cfg):
    """The cost that ``optimize`` reports for ``graph`` at the poses it
    holds (robust weights taken at those poses), evaluated in float64."""
    import torch
    from lsd_tpu_torch.slam import posegraph as pg
    if bool(graph.gps.mask.any() | graph.floor.mask.any() | graph.orient.mask.any()):
        fail("pgo_cost64 sums SE3 edges only, and this graph holds a prior")
    f64 = lambda t: t.to(torch.float64)
    nodes = graph.nodes._replace(quat=f64(graph.nodes.quat), pos=f64(graph.nodes.pos))
    se3 = graph.se3._replace(q_meas=f64(graph.se3.q_meas), t_meas=f64(graph.se3.t_meas),
                             sqrt_info=f64(graph.se3.sqrt_info))
    r = pg._se3_residual(nodes, se3, torch.zeros_like(nodes.pos).repeat(1, 2))
    w = pg._huber_weights(r, cfg.huber_delta)
    if cfg.dcs_phi > 0:
        is_loop = torch.abs(se3.idx[:, 0] - se3.idx[:, 1]) > 1
        s2 = torch.clamp(2.0 * cfg.dcs_phi / (cfg.dcs_phi + torch.sum(r ** 2, dim=-1)), max=1.0)
        w = w * torch.where(is_loop, torch.sqrt(s2), 1.0)
    return float(torch.sum((r * w[:, None]) ** 2))


def pgo_rounding_floor(graph):
    """The cost that ``graph`` would show if every SE3 edge's residual were
    off by one float32 spacing at the size of its poses' coordinates: the sum
    over the edges of ``|sqrt_info|^2 * (eps * max(1, max |pos|))^2``.  A cost
    under it cannot be told from rounding."""
    import torch
    scale = max(1.0, float(graph.nodes.pos[graph.nodes.mask].abs().max()))
    info = torch.sum(graph.se3.sqrt_info[graph.se3.mask].double() ** 2)
    return float(info) * (torch.finfo(torch.float32).eps * scale) ** 2


def check_pgo_costs(where, solves, flat=()):
    """Every solve's costs are finite and its last round's is not above its
    first's; returns them as an array (one fetch).  ``solves`` is the
    ``CallTimer`` that wrapped ``optimize``.

    The solves numbered in ``flat`` start from an optimized graph.  There
    the float32 costs that ``optimize`` reports only wander: a residual is
    millimetres, the difference of poses metres from the origin whose
    float32 spacing is a micrometre, so each cost carries ~1e-3 relative
    rounding, and Gauss-Newton has no step acceptance to hide it.  Those
    solves are judged by the cost of the graph they were given and of the
    graph they returned, both evaluated in float64, which may rise by
    PGO_FLAT_COST_RTOL at most.  Beside it goes the most that rounding every
    pose to the nearest float32 could change that cost, ``sqrt(cost * floor)
    + floor / 4`` with ``floor`` from ``pgo_rounding_floor`` (half a spacing
    on every edge, all with the worst sign).

    A solve whose first cost is already under ``pgo_rounding_floor`` (the
    first of a drive: a chain of odometry edges and no loop yet, which is at
    its optimum of zero as it stands) reports rounding and nothing else.  It
    is held to staying under that floor in every round."""
    import torch
    all_costs = torch.stack([info["costs"] for _, info in solves.results]).cpu().numpy()
    for k, costs in enumerate(all_costs):
        if not np.isfinite(costs).all():
            fail(f"{where}: PGO solve {k}'s costs {costs.tolist()} are not finite")
        floor = pgo_rounding_floor(solves.args[k][0])
        if costs[0] <= floor:
            log(f"{where}: PGO solve {k} starts at its optimum: costs {costs.tolist()} "
                f"against a rounding floor of {floor:.3g}")
            if costs.max() > floor:
                fail(f"{where}: PGO solve {k} began under the rounding floor {floor:.3g} "
                     f"and left it: costs {costs.tolist()}")
            continue
        if k in flat:
            graph_in, cfg = solves.args[k]
            before, after = pgo_cost64(graph_in, cfg), pgo_cost64(solves.results[k][0], cfg)
            log(f"{where}: PGO solve {k} starts from an optimized graph: cost in float64 "
                f"{before:.8g} -> {after:.8g} (relative change {(after - before) / before:+.2e}); "
                f"as reported in float32 {costs[0]:.8g} -> {costs[-1]:.8g} "
                f"({(costs[-1] - costs[0]) / costs[0]:+.2e}, largest round-to-round swing "
                f"{np.max(np.abs(np.diff(costs))) / costs[0]:.2e}); rounding the poses to "
                f"float32 can move the float64 cost by at most "
                f"{(np.sqrt(before * floor) + floor / 4) / before:.2e} of it")
            ok = np.isfinite(after) and after <= before * (1.0 + PGO_FLAT_COST_RTOL)
        else:
            ok = costs[-1] <= costs[0]
        if not ok:
            fail(f"{where}: PGO solve {k}'s costs {costs.tolist()} do not fall from first to "
                 "last")
    return all_costs


def run_mapping_async(mapper_mod, mcfg, nav0, data, gt):
    """The same drive with the background graph worker and the pipelined
    fetch.  The worker prints what a job raises and goes on, and the poses
    come from the odometry thread, so a finite trajectory says nothing of
    the worker: the checks below hold it to having done every keyframe's
    graph work itself, on the card, with nothing raised and nothing dropped."""
    import dataclasses
    import torch
    n = len(data)
    t0 = time.perf_counter()
    amapper = mapper_mod.Mapper(dataclasses.replace(mcfg, async_graph=True, async_fetch=True),
                                nav0)
    timers = {name: CallTimer(mapper_mod, name)
              for name in ("optimize", "icp_point_to_plane", "sc_query")}
    scan_ms = []                       # odometry's own time a scan, the waits included
    for k, d in enumerate(data):
        t1 = time.perf_counter()
        amapper.process_scan(*d[:5], stamp_us=int(k * 1e5))
        scan_ms.append((time.perf_counter() - t1) * 1e3)
    amapper.flush()
    dt = time.perf_counter() - t0
    for t in timers.values():
        t.restore()
    worker = amapper._worker
    amapper.close()
    if worker.is_alive():
        fail("mapping (async): the graph worker is still alive after close()")
    if amapper.worker_errors:
        fail(f"mapping (async): the graph worker's jobs raised {amapper.worker_errors!r}")
    if "dropped_jobs" in amapper.loop_stats:
        fail(f"mapping (async): graph jobs were dropped; loop_stats {amapper.loop_stats}")
    n_kf = len(amapper.store)
    if amapper.sc_ids != list(range(n_kf)):
        fail(f"mapping (async): the worker added {len(amapper.sc_ids)} descriptors for "
             f"{n_kf} keyframes")
    for name, t in timers.items():
        if not t.threads or set(t.threads) != {worker.name}:
            fail(f"mapping (async): {name} ran {len(t.threads)} times on threads "
                 f"{sorted(set(t.threads))}, expected at least once and only on {worker.name}")
    if amapper.loop_stats["accepted"] < 1:
        fail(f"mapping (async): no loop was accepted; loop_stats {amapper.loop_stats}")
    icp_poses = torch.stack([torch.cat(out[:2]) for out in timers["icp_point_to_plane"].results])
    if not bool(torch.isfinite(icp_poses).all()):
        fail("mapping (async): an ICP on the worker thread gave a non-finite pose")
    check_pgo_costs("mapping (async)", timers["optimize"])
    atraj = amapper.trajectory()
    if atraj.shape != (n, 4, 4) or not np.isfinite(atraj).all():
        fail(f"mapping (async): trajectory of shape {atraj.shape} is not {n} finite poses")
    rmse = float(np.sqrt(np.mean(np.sum((atraj[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1))))
    if not rmse < MAPPING_RMSE_LIMIT_M:
        fail(f"mapping (async): trajectory RMSE {rmse} m is not below {MAPPING_RMSE_LIMIT_M} m")
    report = dict(scans=n, keyframes=n_kf, ms_per_scan=dt / n * 1e3, rmse_m=rmse,
                  scan_ms_p50=float(np.median(scan_ms)),
                  scan_ms_p95=float(np.percentile(scan_ms, 95)), scan_ms_max=max(scan_ms),
                  loops=len(amapper.loops), loop_stats=amapper.loop_stats,
                  worker_errors=0, worker_pgo_solves=len(timers["optimize"].threads),
                  worker_icp_candidates=len(timers["icp_point_to_plane"].threads),
                  worker_sc_queries=len(timers["sc_query"].threads))
    log(f"mapping (async_graph, async_fetch), {n} scans: {report['ms_per_scan']:.2f} ms/scan, "
        f"process_scan p50/p95/max {report['scan_ms_p50']:.2f}/{report['scan_ms_p95']:.2f}/"
        f"{report['scan_ms_max']:.2f} ms (host clock, the waits on the worker's queue included), "
        f"{n_kf} keyframes and as many descriptors, {report['loops']} loops, loop_stats "
        f"{amapper.loop_stats}, RMSE {rmse:.4f} m; on the worker thread {report['worker_sc_queries']} "
        f"ScanContext queries, {report['worker_icp_candidates']} ICP verifications and "
        f"{report['worker_pgo_solves']} PGO solves, none raised, none dropped; flush() and "
        "close() returned, the worker has ended")
    return report


def run_points(dev, card, cfg, nav0, scans, gt, n_scans=N_POINTS):
    """Phase 5: the LIO step with the raw-point map; returns its report."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.lio import lio_init, lio_step
    from lsd_tpu_torch.utils.metrics import ate_rmse

    cfg = cfg._replace(map_type="points", map_capacity=2 ** 17)
    st = lio_init(cfg, nav0)
    poses = []
    p2p_reduce.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in scans[:n_scans]:
        st, info = lio_step(cfg, st, *scan)
        poses.append(st.nav.pos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = p2p_reduce.launches.read()
    if launches != cfg.max_iters * n_scans:
        fail(f"raw-point map: p2p_reduce launched {launches} times over {n_scans} scans, "
             f"expected max_iters x scans = {cfg.max_iters * n_scans}")
    if not all(bool(torch.isfinite(x).all()) for x in (*st.nav, st.P, st.map.points)):
        fail("raw-point map: the filter state is not finite")
    est = np.tile(np.eye(4), (n_scans, 1, 1))
    est[:, :3, 3] = torch.stack(poses).cpu().numpy()
    ate = ate_rmse(est, gt[:n_scans], warmup=5)
    if not ate < ATE_LIMIT_M:
        fail(f"raw-point map: ATE {ate} m is not below {ATE_LIMIT_M} m")
    report = dict(card=card, scans=n_scans, points_per_scan=scans[0][0].shape[0],
                  ms_per_scan=dt / n_scans * 1e3, ate_m=ate,
                  num_valid=int(info["num_valid"]),
                  map_voxels=int((st.map.keys >= 0).sum()), p2p_launches=launches)
    log(f"lio_step with map_type='points', {n_scans} scans on {card}: "
        f"{report['ms_per_scan']:.2f} ms/scan, ATE {ate:.5f} m, num_valid "
        f"{report['num_valid']}, {report['map_voxels']} voxels, p2p_reduce launches {launches}")
    return report


def check_tracking(where, outs, errs, n_scans):
    """The reference test's bars on a localization drive; returns the RMSE."""
    if outs[0]["status"] != "initialized":
        fail(f"{where}: the first scan returned {outs[0]['status']!r}, not 'initialized'")
    bad = [(k, o["status"]) for k, o in enumerate(outs[1:], 1) if o["status"] != "tracking"]
    if bad or len(outs) != n_scans:
        fail(f"{where}: scans that are not 'tracking': {bad} of {len(outs)}")
    if not all(np.isfinite(o["pose"]).all() and o["pose"].shape == (4, 4) for o in outs):
        fail(f"{where}: a pose is not a finite 4x4")
    rmse = float(np.sqrt(np.mean(np.square(errs[3:]))))
    if not rmse < LOC_RMSE_LIMIT_M:
        fail(f"{where}: position RMSE {rmse} m after the first 3 poses is not below "
             f"{LOC_RMSE_LIMIT_M} m; errors {errs}")
    if not np.all(np.abs(np.diff(errs[-4:])) < LOC_TAIL_STEP_M):
        fail(f"{where}: the last four errors {errs[-4:]} differ by {LOC_TAIL_STEP_M} m or more")
    return rmse


def follow(loc, drive, scans, side_lio, t_start=LOC_T_START):
    """Feed ``scans`` of ``drive`` to ``loc``, with their stamps and IMU batch
    if ``side_lio``; returns (outputs, position errors in m (NaN where a
    scan gave no pose), host ms per scan).  With the side LIO the scan is
    undistorted to its end, so the pose is held against the truth there;
    without it the raw sweep is matched and the pose is held against the
    truth at the sweep's start, as the reference test holds it."""
    import torch
    from lsd_tpu_torch.tools.profile_lio import drive_localizer
    outs, errs, ms = [], [], []
    feed = drive_localizer(loc, drive, scans, t_start, side_lio=side_lio)
    for k in range(len(scans)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = next(feed)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        truth = scans[k][5][:3, 3] if side_lio else drive.pose(t_start + k * 0.1)[1]
        outs.append(out)
        errs.append(float(np.linalg.norm(out["pose"][:3, 3] - truth))
                    if out["pose"] is not None else float("nan"))
    return outs, errs, ms


def run_localization(dev, card, map_dir, sim, map_data):
    """Phase 6: the localization path on the map phase 4 saved from the
    scans ``map_data`` of ``sim``."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam import localization as loc_mod
    from lsd_tpu_torch.tools.profile_lio import drive_localizer, localization_drive, sync_sites

    # ---- production mode: the side LIO's increments drive the filter -------
    t0 = time.perf_counter()
    # one scan more than the drive feeds: the kernel is held against its
    # plain version on it, at the side LIO's state after the drive
    drive, scans, hint = localization_drive(sim, N_LOC + 1, CAP)
    log(f"localization: made {len(scans)} scans of {CAP} points in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = loc_mod.LocalizerConfig()
    if not cfg.use_lio_odometry:
        fail("localization: LocalizerConfig() no longer runs the side LIO by default")
    t0 = time.perf_counter()
    loc = loc_mod.Localizer(map_dir, cfg)
    load_ms = (time.perf_counter() - t0) * 1e3
    loc.set_init_pose(hint)
    build = CallTimer(loc, "_build_local_map", host=True)
    reloc = CallTimer(loc, "_relocalize", host=True)
    track = CallTimer(loc_mod, "localize_track_step")
    outs, scan_ms, used, syncs, sync_sites_seen = [], [], [], {True: [], False: []}, {}
    p2p_reduce.launches.reset()
    feed = drive_localizer(loc, drive, scans, LOC_T_START)
    for k in range(N_LOC):
        builds = len(build.spans)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k in LOC_SYNC_SCANS:
            (_, out), sites = sync_sites(lambda: next(feed))
            syncs[len(build.spans) > builds].append(sum(sites.values()))
            for site, n in sites.items():
                sync_sites_seen[site] = sync_sites_seen.get(site, 0) + n
        else:
            _, out = next(feed)
        torch.cuda.synchronize()
        scan_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
        used.append(k > 0 and loc.last_step_diag["has_odom"])
    launches = p2p_reduce.launches.read()
    for timer in (track, build, reloc):
        timer.restore()
    track_ms, build_ms, reloc_ms = track.ms(), build.ms(), reloc.ms()
    if launches != cfg.lio.max_iters * N_LOC:
        fail(f"localization: p2p_reduce launched {launches} times over {N_LOC} scans, "
             f"expected the side LIO's max_iters x scans = {cfg.lio.max_iters * N_LOC}")
    errs = [float(np.linalg.norm(o["pose"][:3, 3] - s[5][:3, 3])) if o["pose"] is not None
            else float("nan") for o, s in zip(outs, scans)]
    rmse = check_tracking("localization", outs, errs, N_LOC)
    # the kernel against its plain version at the shape this path gives it:
    # the side LIO's own state after the drive, the next scan's first
    # iteration (after the count was read: these launches are not the path's)
    side_args = p2p_inputs(cfg.lio, loc._lio_state,
                           tuple(torch.as_tensor(a, device=dev) for a in scans[N_LOC][:5]))
    if side_args[0].shape[0] != cfg.lio.ds_capacity:
        fail(f"localization: the side LIO reduces {side_args[0].shape[0]} points, expected "
             f"ds_capacity = {cfg.lio.ds_capacity}")
    side_err = compare_p2p(side_args, cfg.lio.max_resid)
    # late in a long process the profiler may drop records in every trace:
    # the comparison above is the check, the device time is a reading
    side_ms, _, _ = device_ms(lambda: p2p_reduce(*side_args, cfg.lio.max_resid),
                              match="p2p_", required=False, launches=p2p_reduce.launches)
    side_call_ms = time_ms(lambda: p2p_reduce(*side_args, cfg.lio.max_resid))
    log(f"p2p_reduce at the side LIO's shape, N={cfg.lio.ds_capacity}: max abs error "
        f"{side_err:.3e}, device time per call {side_ms} ms, call time {side_call_ms:.4f} ms")
    if any(used[:10]) or not all(used[10:]):
        fail(f"localization: the side LIO's increments were used on scans "
             f"{[k for k, u in enumerate(used) if u]}, expected every scan after its 10 "
             "warm-up scans")
    if len(build_ms) < 2:
        fail(f"localization: the local map was built {len(build_ms)} times, expected the "
             "first build and at least one recentre")
    if len(track_ms) != N_LOC - 1 or len(reloc_ms) != 1:
        fail(f"localization: {len(track_ms)} track steps and {len(reloc_ms)} relocalizations "
             f"over {N_LOC} scans")
    steady = scan_ms[10:]
    report = dict(
        card=card, scans=N_LOC, points_per_scan=CAP, keyframes=len(loc.store),
        load_map_and_descriptors_ms=load_ms,
        ms_per_process_scan_median=float(np.median(steady)),
        ms_per_process_scan_min=float(np.min(steady)),
        ms_per_process_scan_max=float(np.max(steady)),
        ms_per_track_step_median=float(np.median(track_ms[9:])),
        ms_per_track_step_min=float(np.min(track_ms[9:])),
        ms_per_track_step_max=float(np.max(track_ms[9:])),
        ms_per_build_local_map=[round(x, 2) for x in build_ms],
        ms_per_relocalization=reloc_ms[0],
        host_syncs_per_process_scan=float(np.mean(syncs[False])) if syncs[False] else None,
        host_syncs_per_recentring_scan=float(np.mean(syncs[True])) if syncs[True] else None,
        host_sync_sites=sync_sites_seen, rmse_m=rmse, max_err_m=float(np.max(errs[3:])),
        recentres=len(build_ms) - 1, p2p_launches=launches,
        p2p_at_side_lio_shape=dict(n=cfg.lio.ds_capacity, max_abs_err=side_err, ms=side_ms,
                                   call_ms=side_call_ms))
    log(f"localization (side LIO on), {N_LOC} scans of {CAP} points on {card}: "
        f"{report['ms_per_process_scan_median']:.2f} ms per process_scan (median of the "
        f"{len(steady)} after warm-up; {report['ms_per_process_scan_min']:.2f}-"
        f"{report['ms_per_process_scan_max']:.2f}), track step "
        f"{report['ms_per_track_step_median']:.2f} ms, local map builds "
        f"{report['ms_per_build_local_map']} ms, relocalization from the hint "
        f"{reloc_ms[0]:.1f} ms, host syncs per process_scan "
        f"{report['host_syncs_per_process_scan']} ({report['host_syncs_per_recentring_scan']} "
        f"when it recentres), RMSE {rmse:.4f} m, {report['recentres']} recentres, "
        f"p2p_reduce launches {launches}")

    # ---- IMU-driven prediction, no stamps and no IMU batch ------------------
    loc2 = loc_mod.Localizer(map_dir, cfg)
    loc2.set_init_pose(hint)
    track = CallTimer(loc_mod, "localize_track_step")
    p2p_reduce.launches.reset()
    outs2, errs2, ms2 = follow(loc2, drive, scans[:N_LOC_IMU], side_lio=False)
    track.restore()
    if (launches := p2p_reduce.launches.read()) != 0:
        fail(f"localization (IMU prediction): p2p_reduce launched {launches} times "
             "with no side LIO running")
    rmse2 = check_tracking("localization (IMU prediction)", outs2, errs2, N_LOC_IMU)
    report["imu_prediction"] = dict(
        scans=N_LOC_IMU, rmse_m=rmse2, speed_at_the_end_m_s=float(np.linalg.norm(
            drive.velocity(LOC_T_START + (N_LOC_IMU - 1) * 0.1))),
        ms_per_process_scan_median=float(np.median(ms2[1:])),
        ms_per_track_step_median=float(np.median(track.ms())))
    log(f"localization (IMU-driven prediction, 15 NDT searches), {N_LOC_IMU} scans: "
        f"{report['imu_prediction']['ms_per_process_scan_median']:.2f} ms per process_scan, "
        f"track step {report['imu_prediction']['ms_per_track_step_median']:.2f} ms, "
        f"RMSE {rmse2:.4f} m")

    # ---- both modes begun at cruise: reported, not judged -------------------
    # The reference test's own drive (at the mapping run's speed, 3.037 s
    # into the lap).  A filter that starts cold at 6.4 m/s is a known weak
    # spot of the reference that the port reproduces: the side LIO has not
    # converged when its increments come into use, and at this point count
    # the IMU-driven filter settles metres off, all the while "tracking"
    # (tests/test_torch_localization_cruise.py holds both packages to it).
    cruise, cscans, chint = localization_drive(sim, N_LOC_CRUISE, CAP, t_start=CRUISE_T_START,
                                               rest_time=0.0, ramp_time=0.0)
    report["cruise_start"] = {}
    for mode, side_lio, n in (("imu_prediction", False, N_LOC_CRUISE_IMU),
                              ("side_lio", True, N_LOC_CRUISE)):
        loc3 = loc_mod.Localizer(map_dir, cfg)
        loc3.set_init_pose(chint)
        outs3, errs3, _ = follow(loc3, cruise, cscans[:n], side_lio, t_start=CRUISE_T_START)
        statuses = [o["status"] for o in outs3]
        report["cruise_start"][mode] = dict(
            scans=n, statuses={st: statuses.count(st) for st in sorted(set(statuses))},
            err_m=[None if np.isnan(e) else round(e, 3) for e in errs3])
        log(f"localization begun at cruise, {mode}, {n} scans (not judged): "
            f"{report['cruise_start'][mode]}")

    # ---- global relocalization without a hint, through the entry point ------
    # Not judged (the ring world is ambiguous to ScanContext), but it must
    # not raise: the drive's last scan; the raw sweep a keyframe was made
    # from; and that keyframe's stored cloud, whose descriptor is in the
    # database, so that the candidate passes and the ICP check runs.
    kf = loc.store.frames[len(loc.store) // 2]
    sweep = map_data[int(round(kf.stamp_us / 1e5))]
    kf_pts = np.zeros((1 << int(np.ceil(np.log2(len(kf.cloud)))), 3), np.float32)
    kf_pts[:len(kf.cloud)] = kf.cloud[:, :3]
    report["global_relocalization"] = {}
    for name, P, M, truth in (
            ("last_scan_of_the_drive", scans[N_LOC - 1][0], scans[N_LOC - 1][2],
             scans[N_LOC - 1][5]),
            ("sweep_of_a_keyframe", sweep[0], sweep[2], sweep[5]),
            ("stored_cloud_of_that_keyframe", kf_pts, np.arange(len(kf_pts)) < len(kf.cloud),
             kf.pose)):
        fresh = loc_mod.Localizer(map_dir, cfg)
        reloc = CallTimer(fresh, "_relocalize", host=True)
        out = fresh.process_scan(P, M, stamp_us=0)
        report["global_relocalization"][name] = dict(
            points=int(M.sum()), status=out["status"], ms=reloc.ms()[0], **fresh.last_reloc,
            err_m=None if out["pose"] is None
            else float(np.linalg.norm(out["pose"][:3, 3] - truth[:3, 3])))
        log(f"global relocalization without a hint, {name} (not judged): "
            f"{report['global_relocalization'][name]}")

    # ---- the tracking step alone --------------------------------------------
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    P, S, M = (torch.as_tensor(a, device=dev) for a in scans[N_LOC - 1][:3])
    z3 = f32([0.0, 0.0, 0.0])
    args = (loc.ukf, loc.ndt_map, loc.icp_map, P, M, f32(0.1), z3, z3, z3,
            torch.zeros((), dtype=torch.bool, device=dev), f32(4.0))
    kw = dict(odom_dq=f32([1.0, 0.0, 0.0, 0.0]), odom_dt=z3, gate_t=f32(1.0),
              gate_ang=f32(0.17), gps_gate=f32(2.5), stamps=S, ukf_cfg=cfg.ukf, has_odom=True,
              ndt_searches=cfg.ndt_searches_odom, track_voxel=cfg.track_voxel,
              track_capacity=cfg.track_capacity)
    step = lambda: loc_mod.localize_track_step(*args, **kw)
    _, sites = sync_sites(step)
    if sites:
        fail(f"localize_track_step made host syncs: {sites}")

    def timed(fetch_each):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(N_TRACK_CALLS):
            pose = step()[1]
            if fetch_each:
                pose.cpu()
        pose.cpu()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / N_TRACK_CALLS
    step()
    report["track_step_alone"] = dict(calls=N_TRACK_CALLS, host_syncs=0,
                                      ms_fetch_every_call=timed(True),
                                      ms_one_fetch_at_the_end=timed(False))
    log(f"localize_track_step alone, {N_TRACK_CALLS} calls: "
        f"{report['track_step_alone']['ms_fetch_every_call']:.2f} ms per call with a fetch "
        f"each, {report['track_step_alone']['ms_one_fetch_at_the_end']:.2f} ms with one fetch "
        "at the end, 0 host syncs inside it")
    return report


def run_rtkm(dev, card, sim, data, mcfg_kw):
    """Phase 7a: RTK-interpolated mapping over phase 4's scans."""
    import torch
    from lsd_tpu_torch.geometry.utm import UTMProjector, grid_convergence
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.mapper import MapperConfig
    from lsd_tpu_torch.slam.rtkm import RtkMapper

    # fixes at the simulator's poses every 0.1 s, through the projection and
    # back: lat/lon of the pose's offset from the first, heading in NED
    # degrees against true north (the mapper takes the grid convergence off)
    proj = UTMProjector()
    proj.project(42.0, -83.0)
    _, p0 = sim.pose(0.0)
    m = RtkMapper(MapperConfig(**mcfg_kw))
    n = len(data)
    for k in range(n + 2):
        R, p = sim.pose(k * 0.1)
        lat, lon = proj.unproject(p[0] - p0[0], p[1] - p0[1])
        yaw = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
        m.feed_ins(dict(timestamp=int(k * 1e5), latitude=float(lat), longitude=float(lon),
                        altitude=100.0 + p[2] - p0[2], pitch=0.0, roll=0.0,
                        heading=90.0 - yaw + grid_convergence(proj.lon0, float(lat), float(lon))))
    p2p_reduce.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    worst = 0.0
    for k, d in enumerate(data):
        out = m.process_scan(d[0], d[1], d[2], stamp_us=int(k * 1e5))
        if out["pose"] is None:
            fail(f"rtkm: scan {k} got no pose ({out['status']})")
        # the scan-end pose: the fix at (k + 1) * 0.1 s, in the frame that
        # starts at the first fix
        R, p = sim.pose((k + 1) * 0.1)
        worst = max(worst, float(np.abs(out["odom"][:3, 3] - (p - p0)).max()),
                    float(np.abs(out["odom"][:3, :3] - R).max()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not worst < RTK_POSE_ATOL_M:
        fail(f"rtkm: a scan's pose is {worst} off its interpolated fix, allowed "
             f"{RTK_POSE_ATOL_M}")
    n_kf = len(m.store)
    if n_kf < RTK_MIN_KEYFRAMES or m.graph.num_nodes != n_kf or m.sc_ids != list(range(n_kf)):
        fail(f"rtkm: {n_kf} keyframes, {m.graph.num_nodes} graph nodes, {len(m.sc_ids)} "
             f"descriptors; expected at least {RTK_MIN_KEYFRAMES} of each, all equal")
    if (launches := p2p_reduce.launches.read()) != 0:
        fail(f"rtkm: p2p_reduce launched {launches} times; RTK mapping runs no LIO")
    traj = m.trajectory()
    if traj.shape != (n, 4, 4) or not np.isfinite(traj).all():
        fail(f"rtkm: trajectory of shape {traj.shape} is not {n} finite poses")
    report = dict(card=card, scans=n, points_per_scan=data[0][0].shape[0],
                  ms_per_scan=dt / n * 1e3, keyframes=n_kf, loops=len(m.loops),
                  loop_stats=m.loop_stats, max_pose_minus_fix=worst,
                  origin_lla=[float(v) for v in m.origin_lla])
    log(f"rtkm, {n} scans on {card}: {report['ms_per_scan']:.2f} ms/scan, {n_kf} keyframes, "
        f"{len(m.loops)} loops, loop_stats {m.loop_stats}, poses within {worst:.2e} of their "
        "fixes")
    return report


def run_icp_odometry(dev, card):
    """Phase 7b: LiDAR-only odometry on the reference test's world."""
    import torch
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam.icp_odometry import IcpOdometry, IcpOdometryConfig
    from lsd_tpu_torch.tools.profile_lio import sync_sites

    sim = CircleSim(SimConfig(radius=10.0, omega=0.15, n_scans=N_ICP_ODOM, points_per_scan=CAP,
                              seed=66))
    data = sim.generate(capacity=CAP, imu_capacity=IMU_CAP)
    odo = IcpOdometry(IcpOdometryConfig())
    T0_inv = np.linalg.inv(data[0][5])
    errs, valid, syncs = [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, d in enumerate(data):
        if k == N_ICP_ODOM - 1:
            out, sites = sync_sites(lambda: odo.process_scan(d[0], d[2]))
            syncs = sum(sites.values())
        else:
            out = odo.process_scan(d[0], d[2])
        errs.append(float(np.linalg.norm(out["pose"][:3, 3] - (T0_inv @ d[5])[:3, 3])))
        valid.append(out["num_valid"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ate = float(np.sqrt(np.mean(np.square(errs[2:]))))
    if not (np.isfinite(errs).all() and ate < ICP_ODOM_ATE_LIMIT_M):
        fail(f"icp_odometry: relative-motion ATE {ate} m after the first two scans is not "
             f"below {ICP_ODOM_ATE_LIMIT_M} m; errors {errs}")
    if syncs != 1:
        fail(f"icp_odometry: a scan made {syncs} host syncs, expected its one packed fetch: "
             f"{sites}")
    report = dict(card=card, scans=N_ICP_ODOM, points_per_scan=CAP,
                  ms_per_scan=dt / N_ICP_ODOM * 1e3, ate_m=ate, num_valid_last=valid[-1], host_syncs_per_scan=syncs)
    log(f"icp_odometry, {N_ICP_ODOM} scans of {CAP} points on {card}: "
        f"{report['ms_per_scan']:.2f} ms/scan, relative-motion ATE {ate:.4f} m, num_valid "
        f"{valid[-1]}, {syncs} host sync per scan")
    return report


def match_boxes(ref, got, thresh, tol):
    """Greedy one-to-one match of two sets of kept detections (boxes,
    scores, labels) by label and centre; returns (worst centre, heading
    modulo pi and score deviation, unmatched count).  A box without a
    partner within ``tol`` must lie within ``tol`` of its class threshold."""
    worst, used, unmatched = np.zeros(3), np.zeros(len(got[0]), bool), 0
    for b, sc, lb in zip(*ref):
        d = np.linalg.norm(got[0][:, :2] - b[:2], axis=1) if len(got[0]) else np.zeros(0)
        d[used | (got[2] != lb)] = np.inf
        i = int(np.argmin(d)) if len(d) else -1
        if i < 0 or d[i] > tol:
            if abs(sc - thresh[lb]) > tol:
                fail(f"detection: a kept box {b.tolist()} (score {sc}) has no partner")
            unmatched += 1
            continue
        used[i] = True
        dh = abs((got[0][i, 6] - b[6] + np.pi / 2) % np.pi - np.pi / 2)
        worst = np.maximum(worst, [d[i], dh, abs(got[1][i] - sc)])
    for sc, lb in zip(got[1][~used], got[2][~used]):
        if abs(sc - thresh[lb]) > tol:
            fail(f"detection: a kept box (score {sc}) has no partner")
        unmatched += 1
    return worst, unmatched


def check_detector_fp32(dev, capacity, state_dict):
    """The float32 twin of a shipped checkpoint on the card and on the
    host's CPU, on one realistic scene of two accumulated frames."""
    import torch
    from lsd_tpu_torch.detection.accumulate import FrameAccumulator
    from lsd_tpu_torch.detection.post import PostProcessConfig, postprocess
    from lsd_tpu_torch.models.detector import CenterPointDetector
    from lsd_tpu_torch.ops.voxelize import voxelize_dynamic
    from lsd_tpu_torch.tools.profile_detector import CAPACITIES, ego_drive

    cfg = CAPACITIES[capacity]()
    frames, _ = ego_drive(2, seed=999)
    acc = FrameAccumulator(2, frames[0][0].shape[0])
    for f in frames:
        pts, msk = acc.push(*f)
    out = {}
    for d in ("cpu", dev):
        model = CenterPointDetector(cfg, dtype=torch.float32)
        model.load_state_dict(state_dict)
        model = model.to(d).eval()
        P, M = torch.as_tensor(pts[:, :4], device=d), torch.as_tensor(msk, device=d)
        with torch.inference_mode():
            vox = voxelize_dynamic(P, M, cfg.voxel_size, cfg.pc_range, cfg.max_voxels,
                                   cfg.max_points_per_voxel)
            t0 = time.perf_counter()
            maps = model(P, M)
            kept = postprocess(PostProcessConfig(), *model.decode(maps))
            if d != "cpu":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        k = kept[3].cpu()
        out[str(d)] = dict(vox=[a.cpu() for a in vox], maps={n: v.cpu() for n, v in maps.items()},
                           kept=[a.cpu().numpy()[k.numpy()] for a in kept[:3]], ms=ms)
    cpu, card = out["cpu"], out[str(dev)]
    for name, a, b in zip(("voxels", "coords", "counts", "mask"), cpu["vox"], card["vox"]):
        if not torch.equal(a, b):
            fail(f"detection ({capacity}): voxelize_dynamic's {name} differ between card and CPU")
    map_err = {n: float((card["maps"][n] - v).abs().max() / v.abs().max())
               for n, v in cpu["maps"].items()}
    if max(map_err.values()) > DET_MAP_RTOL:
        fail(f"detection ({capacity}): float32 head maps differ between card and CPU: {map_err}")
    worst, unmatched = match_boxes(cpu["kept"], card["kept"], PostProcessConfig().score_thresh,
                                   DET_BOX_ATOL)
    n_vox = int(cpu["vox"][3].sum())
    report = dict(points=int(msk.sum()), pillars=n_vox,
                  full_pillars=int((cpu["vox"][2] == cfg.max_points_per_voxel).sum()),
                  map_rel_err=map_err, kept_boxes=len(cpu["kept"][0]), unmatched=unmatched,
                  worst_centre_m=float(worst[0]), worst_heading_rad=float(worst[1]),
                  worst_score=float(worst[2]), fp32_ms_card=card["ms"], fp32_ms_cpu=cpu["ms"])
    log(f"detection ({capacity}), float32 twin, card against CPU: {report}")
    return report


def follow_objects(history, objects, step):
    """For each of the drive's objects, the track that follows it in each
    frame (the nearest output track within DRIVE_GATE_M of where the object
    lies in that frame): (objects followed over DRIVE_MIN_FRAMES frames or
    more by a single ID, the largest speed of a track of age DRIVE_MIN_AGE
    or more that follows an object, per-object summaries)."""
    gt_boxes, gt_labels = objects
    summaries, stable, top_speed = [], 0, 0.0
    for b, lb in zip(gt_boxes, gt_labels):
        ids = []
        for k, objs in enumerate(history):
            best = None
            for o in objs:
                dist = float(np.hypot(o["box"][0] - (b[0] - k * step), o["box"][1] - b[1]))
                if dist < DRIVE_GATE_M and (best is None or dist < best[0]):
                    best = (dist, o)
            if best is not None:
                ids.append(best[1]["id"])
                if best[1]["age"] >= DRIVE_MIN_AGE:
                    top_speed = max(top_speed, float(np.linalg.norm(best[1]["velocity"][:2])))
        one_id = len(set(ids)) == 1
        stable += one_id and len(ids) >= DRIVE_MIN_FRAMES
        summaries.append(dict(label=int(lb), range_m=round(float(np.hypot(*b[:2])), 1),
                              frames=len(ids), ids=sorted(set(ids))))
    return stable, top_speed, summaries


def mot_frames(history, objects, step):
    """The drive's frames as ``evaluate_mot`` takes them: the output tracks
    against the scene's objects (ids in the scene's order) where they lie in
    each frame, inside the drives' ROI."""
    gt_boxes = objects[0]
    out = []
    for k, objs in enumerate(history):
        gt = gt_boxes - [k * step, 0, 0, 0, 0, 0, 0]
        inside = np.max(np.abs(gt[:, :2]), axis=1) < 60.0
        out.append(dict(gt_ids=np.flatnonzero(inside), gt_boxes=gt[inside],
                        track_ids=np.asarray([o["id"] for o in objs], np.int64),
                        boxes=np.asarray([o["box"] for o in objs], float).reshape(-1, 7),
                        scores=np.asarray([o["score"] for o in objs], float)))
    return out


def drive_detector(dev, capacity, ins_history=False, drive_frames=None):
    """``N_DRIVE`` frames of ``ego_drive`` through ``DetectModule.process``
    (``profile_detector.detect_module``) at ``capacity``; returns the report and
    adds the drive's frames, as ``evaluate_mot`` takes them, to
    ``drive_frames``.
    With ``ins_history`` the accumulator ages its history by the motion as
    the reference's INS reports it (the previous frame's pose of this one),
    the tracker still by the drive's motion (unjudged)."""
    import torch
    from lsd_tpu_torch.detection.accumulate import FrameAccumulator
    from lsd_tpu_torch.runtime.modules import build_detector_predict_fn
    from lsd_tpu_torch.tools.profile_detector import (CAPACITIES, detect_module, ego_drive,
                                                      frame_dict, frame_profile)

    class InsAccumulator(FrameAccumulator):
        def push(self, points, mask, motion=None):
            return super().push(points, mask, None if motion is None else np.linalg.inv(motion))

    cfg = CAPACITIES[capacity]()
    predict = build_detector_predict_fn(det_cfg=cfg, with_seg=True, device=dev)
    n_all = N_DRIVE_WARM + N_DRIVE + N_DRIVE_PROFILED + N_DRIVE_SYNC
    frames, objects = ego_drive(n_all)
    dicts = [frame_dict(*f, k) for k, f in enumerate(frames)]
    # warm-up on a throwaway module (cuDNN picks its algorithms on first use)
    warm = detect_module(predict, cfg, dev)
    for d in dicts[:N_DRIVE_WARM]:
        warm.process(dict(d))
    events = []

    def timed_predict(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = predict(*args)
        b.record()
        events.append((a, b))
        return out

    mod = detect_module(timed_predict, cfg, dev)
    if ins_history:
        mod.accumulator = InsAccumulator(2)      # process resizes it, keeping its class
    step = lambda d: mod.process(dict(d))
    history, wall = [], []
    drive = dicts[:N_DRIVE]
    for d in drive:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(d)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        history.append(out["objects"])
    predict_ms = [a.elapsed_time(b) for a, b in events]
    stable, top_speed, summaries = follow_objects(history, objects, 1.0)
    tracked = [len(h) for h in history]
    if drive_frames is not None:
        drive_frames.extend(mot_frames(history, objects, 1.0))
    report = dict(capacity=capacity, frames=N_DRIVE, points_per_frame=2 * mod.accumulator.cap,
                  ms_per_frame_median=float(np.median(wall[1:])),
                  ms_per_frame_min=float(np.min(wall[1:])), ms_per_frame_max=float(np.max(wall)),
                  predict_ms_median=float(np.median(predict_ms[1:])),
                  predict_ms_min=float(np.min(predict_ms[1:])),
                  objects_in_scene=len(objects[0]), objects_followed=stable,
                  top_speed_m_s=top_speed, tracked_per_frame=tracked, per_object=summaries)
    if ins_history:
        return report
    # the frames after the drive: launches, device busy share and spans
    # under the profiler, then host syncs by site
    mod.set_model(predict)
    prof = frame_profile(mod, dicts[N_DRIVE:N_DRIVE + N_DRIVE_PROFILED],
                         dicts[N_DRIVE + N_DRIVE_PROFILED:])
    report.update(
        launches_per_frame=prof["kernel_launches_per_frame"],
        device_busy_ms_per_frame=prof["device_busy_ms_per_frame"],
        device_idle_share=prof["device_idle_share"],
        wall_ms_per_frame_traced=prof["wall_ms_per_frame"],
        spans={k: dict(host_ms=round(v["host_ms"], 3), launches=v["launches"])
               for k, v in prof["spans"].items()},
        top_kernels=prof["kernels"][:8],
        host_syncs_per_frame=prof["host_syncs_per_frame"],
        host_sync_sites=prof["host_sync_sites_per_frame"],
        host_syncs_in_predict=prof["host_syncs_in_predict"])
    if prof["host_syncs_in_predict"]:
        fail(f"detection ({capacity}): predict made host syncs: "
             f"{prof['host_sync_sites_in_predict']}")
    return report


def run_detection(dev, card, drive_frames=None):
    """Phase 8: the detection path at full width, both shipped checkpoints;
    the 0.2 m checkpoint's drive goes to ``drive_frames`` (``mot_frames``)."""
    import torch
    from lsd_tpu_torch.convert import detector_params_from_flax
    from lsd_tpu_torch.models.params_io import count_params, load_params
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.runtime.modules import build_detector_predict_fn, shipped_detector_weights
    from lsd_tpu_torch.tools.profile_detector import CAPACITIES, eval_scenes, mean_ap

    p2p_reduce.launches.reset()
    report = dict(card=card, checkpoints={}, float32_card_vs_cpu={}, accuracy={}, drive={})
    scenes = eval_scenes()
    # the shipped checkpoints' capacities (DSVT-Pillar has none: phase 2b)
    for capacity in sorted(JAX_MEAN_AP):
        make_cfg = CAPACITIES[capacity]
        path = shipped_detector_weights(make_cfg())
        if path is None:
            fail(f"detection: no shipped checkpoint for the {capacity} capacity")
        t0 = time.perf_counter()
        tree = load_params(path)
        state_dict = detector_params_from_flax(tree)
        load_ms = (time.perf_counter() - t0) * 1e3
        arrays, numbers = count_params(tree)
        report["checkpoints"][capacity] = dict(file=os.path.basename(path), arrays=arrays,
                                               parameters=numbers, load_ms=load_ms)
        log(f"detection: read {os.path.basename(path)} with the port's reader: {arrays} arrays, "
            f"{numbers} parameters, {load_ms:.1f} ms")
        report["float32_card_vs_cpu"][capacity] = check_detector_fp32(dev, capacity, state_dict)

        predict = build_detector_predict_fn(det_cfg=make_cfg(), device=dev)
        ap, per_class, kept = mean_ap(predict, scenes)
        ref = JAX_MEAN_AP[capacity]
        report["accuracy"][capacity] = dict(scenes=len(scenes), mean_ap=ap, per_class=per_class,
                                            jax_mean_ap=ref, kept_boxes=int(sum(kept)))
        log(f"detection ({capacity}), bf16 as served, {len(scenes)} scenes: mean AP {ap:.4f} at "
            f"the WOD IoUs (per class {per_class}), the JAX package's {ref:.4f} on the CPU")
        if not abs(ap - ref) <= DET_AP_MARGIN:
            fail(f"detection ({capacity}): mean AP {ap:.4f} is not within {DET_AP_MARGIN} of "
                 f"the JAX package's {ref:.4f}")
        del predict

        drive = drive_detector(dev, capacity,
                               drive_frames=drive_frames if capacity == "reference" else None)
        report["drive"][capacity] = drive
        log(f"detection drive ({capacity}), {N_DRIVE} frames of {drive['points_per_frame']} "
            f"points: {drive['ms_per_frame_median']:.2f} ms per frame (predict "
            f"{drive['predict_ms_median']:.2f} ms by CUDA events), {drive['launches_per_frame']:.0f} "
            f"launches and {drive['host_syncs_per_frame']} host syncs per frame (predict "
            f"{drive['host_syncs_in_predict']}), device idle {drive['device_idle_share']:.3f}; "
            f"{drive['objects_followed']} of {drive['objects_in_scene']} objects followed by one "
            f"ID, top speed {drive['top_speed_m_s']:.2f} m/s; per object {drive['per_object']}; "
            f"spans {drive['spans']}")
        if capacity == "reference":
            if drive["objects_followed"] < DRIVE_MIN_OBJECTS:
                fail(f"detection drive: {drive['objects_followed']} objects followed by one ID "
                     f"over {DRIVE_MIN_FRAMES} frames, expected at least {DRIVE_MIN_OBJECTS}")
            if not drive["top_speed_m_s"] < DRIVE_MAX_SPEED:
                fail(f"detection drive: a track of a static object reports "
                     f"{drive['top_speed_m_s']:.2f} m/s")
            ins = drive_detector(dev, capacity, ins_history=True)
            report["drive"]["reference_ins_history"] = ins
            log(f"detection drive with the history aged by the INS's motion (not judged): "
                f"{ins['objects_followed']} objects followed, top speed "
                f"{ins['top_speed_m_s']:.2f} m/s, per object {ins['per_object']}")
        torch.cuda.empty_cache()
    report["p2p_launches"] = p2p_reduce.launches.read()
    if report["p2p_launches"] != 0:
        fail(f"detection: p2p_reduce launched {report['p2p_launches']} times; no SLAM runs here")
    return report


# ---------------------------------------------------------------------------
# phase 9: the camera path


def camera_street_image(hw=CAM_HW, seed=7):
    """A street scene of the Mono3D evaluation's kind (shaded cuboids of the
    four classes) rendered at the camera's own size, as uint8, and its
    intrinsic."""
    from lsd_tpu_torch.training.camera_data import Mono3DSceneConfig, SyntheticMono3DDataset
    ds = SyntheticMono3DDataset(Mono3DSceneConfig(hw=hw), seed=seed)
    img = ds.scene()[0]
    return np.round(img * 255).astype(np.uint8), ds.K


def drive_camera_frames(objects, n, step, hw=CAM_HW, seed=7):
    """The front camera's view of ``ego_drive``'s objects in each of its n
    frames (the vehicle moves ``step`` m along +x per frame), drawn as the
    Mono3D evaluation draws its scenes (shaded cuboids on a sky and ground
    background) at the camera's own size, as uint8.  The camera sits
    CAM_HEIGHT_M above the LiDAR's origin (on the ground), looking along +x
    (camera z -> lidar x, camera x -> lidar -y, camera y -> lidar -z).
    Returns the frames and the intrinsic."""
    from lsd_tpu_torch.training import camera_data as cd
    ds = cd.SyntheticMono3DDataset(cd.Mono3DSceneConfig(hw=hw, cam_height=CAM_HEIGHT_M), seed=seed)
    rng, K, (H, W) = ds.rng, ds.K, hw
    horizon = int(K[1, 2])
    bg = np.empty((H, W, 3), np.float32)
    bg[:horizon] = rng.uniform(0.55, 0.85) + rng.normal(0, 0.02, (horizon, W, 3))
    gnd = rng.uniform(0.25, 0.45)
    bg[horizon:] = (np.linspace(gnd * 1.2, gnd * 0.8, H - horizon)[:, None, None]
                    + rng.normal(0, 0.02, (H - horizon, W, 3)))
    boxes, labels = objects
    albedo = {0: (0.55, 0.1), 1: (0.5, 0.2), 2: (0.45, 0.15), 3: (0.85, 0.05)}
    colours = [np.clip(albedo[int(c)][0] + rng.normal(0, albedo[int(c)][1], 3), 0.05, 1.0)
               for c in labels]
    frames = []
    for k in range(n):
        img = bg.copy()
        # lidar (x, y, z, l, w, h, yaw) -> camera (x, y, z, l, w, h, yaw), the
        # inverse of mono3d_infer.cam_box_to_lidar's rotation
        cam = [(np.asarray([-b[1], CAM_HEIGHT_M - b[2], b[0] - k * step, b[3], b[4], b[5],
                            np.arctan2(-np.cos(b[6]), -np.sin(b[6]))]), colours[i])
               for i, b in enumerate(boxes)]
        cam = [(b, c) for b, c in cam if b[2] - max(b[3], b[4]) > 1.0]
        for b, colour in sorted(cam, key=lambda bc: -bc[0][2]):     # far first
            corners = ds._corners(b)
            ctr = corners.mean(0)
            for f in ds._FACES:
                q = corners[list(f)]
                nrm = np.cross(q[1] - q[0], q[3] - q[0])
                nrm /= np.linalg.norm(nrm)
                if np.dot(nrm, ctr - q.mean(0)) > 0:
                    nrm = -nrm
                if np.dot(nrm, q.mean(0)) > 0:
                    continue
                shade = np.clip(colour * (0.35 + 0.65 * abs(float(np.dot(nrm, cd._LIGHT)))),
                                0.02, 1.0).astype(np.float32)
                cd._fill_quad(img, shade, ds._project(q))
        frames.append(np.round(np.clip(img, 0, 1) * 255).astype(np.uint8))
    return frames, K


def traffic_light_frame(seed, hw=CAM_HW):
    """A traffic-light scene of the Yolo2D evaluation's kind drawn at 256 x
    320 and scaled to the camera's size by nearest neighbour (BGR order is
    the scene's RGB order: the model was trained on it); returns the uint8
    frame and the scene's first light box in its pixels."""
    from lsd_tpu_torch.training.camera_data import (SyntheticTrafficLightDataset,
                                                    TrafficLightSceneConfig)
    img, boxes, _ = SyntheticTrafficLightDataset(TrafficLightSceneConfig(), seed=seed).scene()
    h, w = img.shape[:2]
    rows = np.arange(hw[0]) * h // hw[0]
    cols = np.arange(hw[1]) * w // hw[1]
    frame = np.round(img[rows][:, cols] * 255).astype(np.uint8)
    return frame, boxes[0] * np.asarray([hw[1] / w, hw[0] / h] * 2)


def profile_calls(fn, n, prefixes=("camera/", "detect/")):
    """Launches, device busy ms and idle share per call of ``fn`` over n
    calls under the profiler (host clock, ending in a synchronize), and the
    host ms and launches of the spans named with ``prefixes`` (their ranges
    also show on the device's timeline, not as kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lsd_tpu_torch.tools.profile_lio import trace_report
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rep = trace_report(prof, n, wall, prefixes)
    return dict(wall_ms_traced=rep["wall_ms_per_scan"],
                launches=rep["kernel_launches_per_scan"],
                device_busy_ms=rep["device_busy_ms_per_scan"],
                device_idle_share=rep["device_idle_share"],
                spans={k: dict(host_ms=round(v["host_ms"], 3), launches=v["launches"])
                       for k, v in rep["spans"].items()},
                top_kernels=rep["kernels"][:6])


def syncs_per_call(fn, n=3):
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    total, sites = 0, {}
    for _ in range(n):
        for site, c in sync_sites(fn)[1].items():
            sites[site] = sites.get(site, 0) + c
            total += c
    return total / n, {k: v / n for k, v in sites.items()}


def check_mono3d_fp32(dev, tree):
    """The float32 Mono3D on the card (TF32 off) against the host's CPU on
    one 384 x 640 scene of the evaluation: maps and decoded valid boxes.
    A control run on the card with cuDNN's TF32 on must break the maps'
    bar, or the bar could not see the fault it is there for."""
    import torch
    from lsd_tpu_torch.convert import load_camera_params
    from lsd_tpu_torch.models.mono3d import Mono3D, Mono3DConfig, decode_mono3d, maps_hwc
    from lsd_tpu_torch.training.camera_data import (Mono3DSceneConfig, SyntheticMono3DDataset,
                                                    default_intrinsic)
    from lsd_tpu_torch.utils.precision import set_slam_precision
    img = SyntheticMono3DDataset(Mono3DSceneConfig(hw=(384, 640)), batch_size=1,
                                 seed=999).batch()["image"][0]
    K = default_intrinsic((384, 640)).astype(np.float32)
    out = {}
    for d, tf32 in (("cpu", False), (dev, False), (dev, True)):
        set_slam_precision()
        torch.backends.cudnn.allow_tf32 = tf32
        model = Mono3D(Mono3DConfig())
        load_camera_params(model, tree)
        model = model.to(d).eval()
        x = torch.as_tensor(img, device=d).permute(2, 0, 1)[None]
        with torch.inference_mode():
            model(x)                       # first use: library set-up
            if d != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps = maps_hwc(model(x))
            dec = decode_mono3d(maps, torch.as_tensor(K, device=d), 64, 4)
            if d != "cpu":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        out[(str(d), tf32)] = dict(maps={k: v.cpu() for k, v in maps.items()},
                                   dec=[a.cpu().numpy() for a in dec], ms=ms)
    set_slam_precision()
    cpu, card, control = out[("cpu", False)], out[(str(dev), False)], out[(str(dev), True)]

    def rel_err(run):
        return {k: float((run["maps"][k] - v).abs().max() / v.abs().max())
                for k, v in cpu["maps"].items()}
    map_err, tf32_err = rel_err(card), rel_err(control)
    log(f"camera, float32 Mono3D maps against the CPU: TF32 off {map_err}, TF32 on {tf32_err} "
        f"(bar {CAM_MAP_RTOL})")
    if max(map_err.values()) > CAM_MAP_RTOL:
        fail(f"camera: float32 Mono3D maps differ between card and CPU: {map_err}")
    if max(tf32_err.values()) <= CAM_MAP_RTOL:
        fail(f"camera: the control run with TF32 on stays within the bar {CAM_MAP_RTOL}: "
             f"{tf32_err}")
    (cb, cs, cl, cv), (gb, gs, gl, gv) = cpu["dec"], card["dec"]
    if not (np.array_equal(cv, gv) and np.array_equal(cl[cv], gl[cv])):
        fail("camera: the decoded valid boxes of the float32 Mono3D differ between card and CPU")
    box_err = float(np.max(np.abs(gb[cv] - cb[cv]) / (1.0 + np.abs(cb[cv])))) if cv.any() else 0.0
    if box_err > CAM_BOX_RTOL:
        fail(f"camera: decoded Mono3D boxes differ between card and CPU by {box_err}")
    report = dict(map_rel_err=map_err, map_rel_err_tf32_control=tf32_err,
                  valid_boxes=int(cv.sum()), box_rel_err=box_err,
                  score_err=float(np.max(np.abs(gs - cs))), fp32_ms_card=card["ms"],
                  fp32_ms_cpu=cpu["ms"])
    log(f"camera, float32 Mono3D at 384 x 640, card against CPU: {report}")
    return report


def camera_detect_config(K, camera: bool):
    """``DetectModule``'s config: the 0.2 m LiDAR checkpoint, two
    accumulated frames, the drives' ROI, and with ``camera`` the mono3d
    branch on camera cam0, CAM_HEIGHT_M above the LiDAR, looking along its
    +x (camera z -> lidar x, camera x -> lidar -y, camera y -> lidar -z)."""
    import copy
    from lsd_tpu_torch.runtime.config import AttrDict, DEFAULT_CONFIG
    cfg = AttrDict(copy.deepcopy(DEFAULT_CONFIG))
    cfg.detection.enable = True
    cfg.detection.capacity = "reference"
    cfg.detection.mono3d = dict(enable=camera, weights="", camera="cam0", score_threshold=0.3)
    cfg.camera = [dict(name="cam0", intrinsic_parameters=[K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                       extrinsic_parameters=[0.0, 0.0, CAM_HEIGHT_M, 0.0, -90.0, -90.0])]
    r, e = 60.0, [[-2.5, -1.2], [2.5, -1.2], [2.5, 1.2], [-2.5, 1.2]]
    cfg.roi = [dict(contour=[[-r, -r], [r, -r], [r, r], [-r, r]], is_included=True),
               dict(contour=e, is_included=False)]
    return cfg


def detect_frames(n):
    """``ego_drive``'s frames as the runtime's frame dicts, each with the
    camera's view of the drive's objects (``drive_camera_frames``);
    ``motion_t`` is the drive's motion (the tracker's convention, as phase 8
    passes it).  Returns the frames and the camera's intrinsic."""
    from lsd_tpu_torch.tools.profile_detector import ego_drive
    frames, objects = ego_drive(n)
    images, K = drive_camera_frames(objects, n, -frames[1][2][0, 3])
    out = []
    for k, ((pts, mask, motion), img) in enumerate(zip(frames, images)):
        t = 1_000_000 + 100_000 * k
        d = dict(frame_start_timestamp=t, frame_timestamp_monotonic=t, timestep=100_000,
                 points={"top": pts[mask]}, points_attr={}, lidar_valid=True,
                 image={"cam0": img}, image_valid=True)
        if motion is not None:
            d.update(motion_t=motion, motion_valid=True)
        out.append(d)
    return out, K


def drive_detect_module(dev, camera):
    """``DetectModule.process`` over CAM_DRIVE frames after a warm-up on a
    throwaway module; returns the report and the objects per frame."""
    import torch
    from lsd_tpu_torch.runtime.interface import clear_interfaces
    from lsd_tpu_torch.runtime.modules import DetectModule
    from torch.profiler import record_function
    n_all = N_DRIVE_WARM + N_CAM_DRIVE + N_DRIVE_PROFILED + N_DRIVE_SYNC
    frames, K = detect_frames(n_all)

    def module():
        clear_interfaces()
        cfg = camera_detect_config(K, camera)
        mod = DetectModule(cfg, device=dev)
        mod.setup(cfg)
        return mod
    warm = module()
    for d in frames[:N_DRIVE_WARM]:
        warm.process(dict(d))
    mod = module()
    fused_kinds, lidar_in = {}, []

    def spanned(fn, name):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped
    mod.predict_fn = spanned(mod.predict_fn, "camera/lidar_predict")
    mod.tracker.update = spanned(mod.tracker.update, "camera/tracker")
    if camera:
        mod.mono3d.detect = spanned(mod.mono3d.detect, "camera/mono3d_detect")
        fusion = spanned(mod._run_mono3d_fusion, "camera/fusion")

        def counted_fusion(d, frame, lidar_objs):
            out = fusion(d, frame, lidar_objs)
            for o in out:
                fused_kinds[o.get("fused")] = fused_kinds.get(o.get("fused"), 0) + 1
            # every LiDAR object comes out, matched or not
            from_lidar = sum(o.get("fused") in ("matched", "unmatch_lidar") for o in out)
            if from_lidar != len(lidar_objs):
                fail(f"camera drive: fusion took {len(lidar_objs)} LiDAR objects and gave back "
                     f"{from_lidar}")
            lidar_in.append(len(lidar_objs))
            return out
        mod._run_mono3d_fusion = counted_fusion
    history, wall = [], []
    for d in frames[N_DRIVE_WARM:N_DRIVE_WARM + N_CAM_DRIVE]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mod.process(dict(d))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        history.append(out["objects"])
    rest = frames[N_DRIVE_WARM + N_CAM_DRIVE:]
    it = iter(rest[:N_DRIVE_PROFILED])
    prof = profile_calls(lambda: mod.process(dict(next(it))), N_DRIVE_PROFILED)
    it = iter(rest[N_DRIVE_PROFILED:])
    syncs, sites = syncs_per_call(lambda: mod.process(dict(next(it))), N_DRIVE_SYNC)
    for k, objs in enumerate(history):
        for o in objs:
            if not np.all(np.isfinite(np.asarray(o["box"], float))):
                fail(f"camera drive (camera={camera}): frame {k} has a non-finite object {o}")
    tracked = [len(h) for h in history]
    report = dict(camera=camera, frames=N_CAM_DRIVE, ms_per_frame_median=float(np.median(wall[1:])),
                  ms_per_frame_min=float(np.min(wall[1:])), ms_per_frame_max=float(np.max(wall)),
                  tracked_per_frame=tracked, host_syncs_per_frame=syncs, host_sync_sites=sites,
                  fused_kinds=fused_kinds, lidar_objects_per_frame=lidar_in[:N_CAM_DRIVE], **prof)
    if min(tracked[-CAM_MIN_TRACKED_FRAMES:]) < 1:
        fail(f"camera drive (camera={camera}): no tracked object in one of the last "
             f"{CAM_MIN_TRACKED_FRAMES} frames: {tracked}")
    if camera:
        # the tracks must not rest on camera objects alone
        if min(lidar_in[N_CAM_DRIVE - CAM_MIN_TRACKED_FRAMES:N_CAM_DRIVE]) < 1:
            fail(f"camera drive: no LiDAR object reached the fusion in one of the last "
                 f"{CAM_MIN_TRACKED_FRAMES} frames: {lidar_in[:N_CAM_DRIVE]}")
        if not (fused_kinds.get("matched") and fused_kinds.get("unmatch_camera")):
            fail(f"camera drive: a fusion kind never occurred: {fused_kinds}")
    return report


def run_trafficlight(dev, tree_path):
    """TrafficlightModule.process over N_TL_FRAMES 1920 x 1080 frames, the
    4-class function injected; each frame's pose puts the map light on the
    scene's first light.  Returns the report."""
    import torch
    from lsd_tpu_torch.models.yolo2d import Yolo2DConfig
    from lsd_tpu_torch.runtime.config import ConfigManager
    from lsd_tpu_torch.runtime.trafficlight_module import TrafficlightModule, build_yolo_predict_fn
    try:
        build_yolo_predict_fn(tree_path, device=dev)
        fail("trafficlight: the 8-class config took the 4-class checkpoint")
    except ValueError as exc:
        refusal = str(exc)
    predict = build_yolo_predict_fn(tree_path, cfg=Yolo2DConfig(num_classes=4), device=dev)
    calls = []

    def counted(image):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = predict(image)
        b.record()
        calls.append((a, b))
        return out
    f, cx, cy, light = 1000.0, CAM_HW[1] / 2, CAM_HW[0] / 2, np.asarray([30.0, 0.0, 5.0])
    cfg = ConfigManager().config
    cfg.trafficlight = dict(enable=False, camera="front", intrinsic=[[f, 0, cx], [0, f, cy], [0, 0, 1]],
                            image_size=[CAM_HW[1], CAM_HW[0]],
                            lights=[dict(name="tl_0", position=light.tolist())])
    mod = TrafficlightModule(cfg, device=dev)
    mod.setup(cfg)
    mod.set_model(counted)
    frames = [traffic_light_frame(seed) for seed in range(N_TL_FRAMES + 2)]

    def pose_for(box):
        # the vehicle offset so that the light (30 m ahead) projects onto the box's centre
        u, v = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
        T = np.eye(4)
        T[1, 3] = (u - cx) * light[0] / f
        T[2, 3] = light[2] + (v - cy) * light[0] / f
        return T
    for img, box in frames[:2]:                                  # warm-up
        mod.process(dict(image={"front": img}, slam_pose=pose_for(box)))
    del calls[:]
    wall, lights = [], []
    for img, box in frames[2:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mod.process(dict(image={"front": img}, slam_pose=pose_for(box)))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        lights.append(out["lights"])
    if len(calls) != N_TL_FRAMES:
        fail(f"trafficlight: the model ran {len(calls)} times over {N_TL_FRAMES} frames")
    keys = {"id", "color", "pictogram", "confidence", "name"}
    for ls in lights:
        for l in ls:
            if not (set(l) >= keys and l["name"] == "tl_0" and np.isfinite(l["confidence"])):
                fail(f"trafficlight: a lights entry is not proto-ready: {l}")
    found = sum(len(ls) == 1 for ls in lights)
    if found < TL_MIN_FOUND:
        fail(f"trafficlight: the map light was matched in {found} of {N_TL_FRAMES} frames")
    img = frames[2][0]
    predict_ms = [a.elapsed_time(b) for a, b in calls]
    syncs, sites = syncs_per_call(lambda: predict(img))
    report = dict(frames=N_TL_FRAMES, model_calls=len(calls), lights_found=found,
                  colors=[ls[0]["color"] if ls else None for ls in lights],
                  ms_per_frame_median=float(np.median(wall)), ms_per_frame_max=float(np.max(wall)),
                  predict_ms_median=float(np.median(predict_ms)),
                  host_syncs_per_predict=syncs, host_sync_sites=sites,
                  eight_class_refusal=refusal, **profile_calls(lambda: predict(img), 5))
    log(f"trafficlight: {report}")
    return report


def check_quantized(dev, tree, scenes, intrinsic):
    """quantized_matmul's int32 accumulators on the card against the CPU at
    the reference test's shape (8 x 64 @ 64 x 32, rows padded) and at a
    Mono3D 1x1 head's (15,360 x 64 @ 64 x 12, columns padded); then the
    shipped Mono3D through save_quantized and the port's reader, served on
    the card over the 16 scenes (mean AP reported)."""
    import torch
    from lsd_tpu_torch.convert import load_camera_params
    from lsd_tpu_torch.models import quantize as tq
    from lsd_tpu_torch.models.mono3d import Mono3D, Mono3DConfig
    from lsd_tpu_torch.models.params_io import load_params
    from lsd_tpu_torch.training.camera_data import mono3d_ap, mono3d_frames
    rng = np.random.default_rng(11)
    report = {}
    for m, k, n in ((8, 64, 32), (15360, 64, 12)):
        x = rng.normal(size=(m, k)).astype(np.float32)
        q = tq._quantize_leaf(rng.normal(size=(k, n)).astype(np.float32))
        xq = torch.as_tensor(np.clip(np.round(x / (np.abs(x).max() / 127)), -127, 127).astype(np.int8))
        wq = torch.as_tensor(q["q"])
        acc_cpu = tq._int_mm(xq, wq)
        acc_card = tq._int_mm(xq.to(dev), wq.to(dev)).cpu()
        if not torch.equal(acc_cpu, acc_card):
            fail(f"quantized_matmul ({m}x{k}@{k}x{n}): int32 accumulators differ card vs CPU")
        args = (torch.as_tensor(x), wq, torch.as_tensor(q["scale"]))
        y_cpu = tq.quantized_matmul(*args)
        y_card = tq.quantized_matmul(*(a.to(dev) for a in args)).cpu()
        err = float((y_card - y_cpu).abs().max())
        report[f"{m}x{k}@{k}x{n}"] = dict(acc_equal=True, out_max_abs_err=err,
                                          ms=time_ms(lambda: tq.quantized_matmul(
                                              *(a.to(dev) for a in args))))
    with tempfile.TemporaryDirectory() as tmp:
        path = tq.save_quantized(os.path.join(tmp, "mono3d.int8.msgpack"), tree)
        size = os.path.getsize(path)
        qtree = load_params(path)
    model = Mono3D(Mono3DConfig())
    load_camera_params(model, qtree)
    ap = mono3d_ap(mono3d_frames(model.to(dev).eval(), scenes, intrinsic, dev))
    report.update(int8_file_bytes=size, int8_mean_ap=ap["mean_ap"], int8_per_class=ap["per_class"],
                  max_quantization_error=max(tq.quantization_error(tree).values()))
    log(f"quantization: {report}")
    return report


def run_camera(dev, card):
    """Phase 9: the camera models and their pipeline modules on the card."""
    import torch
    from lsd_tpu_torch.convert import load_camera_params
    from lsd_tpu_torch.detection.mono3d_infer import Mono3DInfer, shipped_mono3d_weights
    from lsd_tpu_torch.models.mono3d import Mono3D, Mono3DConfig
    from lsd_tpu_torch.models.params_io import count_params, load_params
    from lsd_tpu_torch.models.yolo2d import Yolo2D, Yolo2DConfig, nms_2d
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    from lsd_tpu_torch.training import camera_data as cd

    p2p_reduce.launches.reset()
    root = os.path.dirname(os.path.abspath(__file__))
    m3_path, tl_path = shipped_mono3d_weights(), os.path.join(root, "weights",
                                                              "yolo2d_trafficlight.msgpack")
    if m3_path is None or not os.path.exists(tl_path):
        fail("camera: a shipped camera checkpoint is missing")
    m3_tree, tl_tree = load_params(m3_path), load_params(tl_path)
    report = dict(card=card, checkpoints={os.path.basename(p): count_params(t)[1]
                                          for p, t in ((m3_path, m3_tree), (tl_path, tl_tree))})
    report["mono3d_fp32_card_vs_cpu"] = check_mono3d_fp32(dev, m3_tree)

    # the evaluations' scenes, on the card
    m3_scenes = list(cd.SyntheticMono3DDataset(cd.Mono3DSceneConfig(hw=(384, 640)), batch_size=4,
                                               seed=999).batches(4))
    K384 = cd.default_intrinsic((384, 640))
    model = Mono3D(Mono3DConfig())
    load_camera_params(model, m3_tree)
    model = model.to(dev).eval()
    ap = cd.mono3d_ap(cd.mono3d_frames(model, m3_scenes, K384, dev))
    report["mono3d_accuracy"] = dict(ap, jax_mean_ap=JAX_MONO3D_AP, bar=MONO3D_AP_BAR)
    log(f"camera: Mono3D on the card, 16 scenes: {ap} (the JAX package's {JAX_MONO3D_AP})")
    if not abs(ap["mean_ap"] - JAX_MONO3D_AP) <= MONO3D_AP_BAR:
        fail(f"camera: Mono3D mean AP {ap['mean_ap']} is not within {MONO3D_AP_BAR} of "
             f"{JAX_MONO3D_AP}")
    yolo = Yolo2D(Yolo2DConfig(num_classes=4))
    load_camera_params(yolo, tl_tree)
    yolo = yolo.to(dev).eval()
    tl_scenes = list(cd.SyntheticTrafficLightDataset(cd.TrafficLightSceneConfig(), batch_size=4,
                                                     seed=999).batches(4))
    yap = cd.yolo2d_ap(cd.yolo2d_frames(yolo, tl_scenes, dev), 4)
    report["yolo2d_accuracy"] = dict(yap, jax_mean_ap=JAX_YOLO_AP, bar=YOLO_AP_BAR)
    log(f"camera: Yolo2D bf16 on the card, 16 scenes: {yap} (the JAX package's {JAX_YOLO_AP})")
    if not abs(yap["mean_ap"] - JAX_YOLO_AP) <= YOLO_AP_BAR:
        fail(f"camera: Yolo2D mean AP {yap['mean_ap']} is not within {YOLO_AP_BAR} of {JAX_YOLO_AP}")
    # nms_2d on the card makes no host sync
    from lsd_tpu_torch.models.mono3d import maps_hwc
    from lsd_tpu_torch.models.yolo2d import decode_yolo2d
    with torch.inference_mode():
        x = torch.as_tensor(tl_scenes[0]["image"][0], device=dev).permute(2, 0, 1)[None]
        boxes, scores, labels, mask = decode_yolo2d(maps_hwc(yolo(x)), 16, 64)
        nms_2d(boxes, scores, mask)
        _, sites = sync_sites(lambda: nms_2d(boxes, scores, mask))
    if sites:
        fail(f"camera: nms_2d made host syncs: {sites}")
    report["nms_2d"] = dict(host_syncs=0, ms=time_ms(lambda: nms_2d(boxes, scores, mask)),
                            **profile_calls(lambda: nms_2d(boxes, scores, mask), 5))
    del model, yolo

    # Mono3DInfer on a full-size frame: one packed fetch, no other sync
    img, K = camera_street_image()
    infer = Mono3DInfer(device=dev)
    with torch.inference_mode():
        prepped, Ks = infer._prep(img, K)
        infer._predict(prepped, Ks)
        _, sites = sync_sites(lambda: infer._predict(prepped, Ks))
    if sites:
        fail(f"camera: Mono3D's model and decode made host syncs: {sites}")
    det = infer.detect(img, K)
    syncs, sync_at = syncs_per_call(lambda: infer.detect(img, K))
    report["mono3d_infer"] = dict(
        objects=len(det["camera_objs"]), predict_ms=time_ms(lambda: infer._predict(prepped, Ks)),
        detect_ms=time_ms(lambda: infer.detect(img, K), n=20), host_syncs_per_detect=syncs,
        host_sync_sites=sync_at, **profile_calls(lambda: infer.detect(img, K), 5))
    log(f"camera: Mono3DInfer.detect on a {CAM_HW[1]} x {CAM_HW[0]} frame: "
        f"{report['mono3d_infer']}")
    del infer

    # DetectModule with and without the camera branch
    report["detect_module"] = {}
    for camera in (True, False):
        rep = drive_detect_module(dev, camera)
        report["detect_module"]["with_camera" if camera else "lidar_only"] = rep
        log(f"camera: DetectModule.process, {N_CAM_DRIVE} frames, camera {camera}: "
            f"{rep['ms_per_frame_median']:.2f} ms per frame, {rep['launches']:.0f} launches, "
            f"{rep['host_syncs_per_frame']} host syncs, idle {rep['device_idle_share']:.3f}, "
            f"fused {rep['fused_kinds']}, tracked {rep['tracked_per_frame']}, spans {rep['spans']}, "
            f"top kernels {rep['top_kernels']}")

    report["trafficlight"] = run_trafficlight(dev, tl_path)
    report["quantization"] = check_quantized(dev, m3_tree, m3_scenes, K384)
    report["p2p_launches"] = p2p_reduce.launches.read()
    if report["p2p_launches"] != 0:
        fail(f"camera: p2p_reduce launched {report['p2p_launches']} times; no SLAM runs here")
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 10: the runtime's default pipeline


def pipeline_perception(dev, rec_dir, out_dir, pipeline, edit):
    """The port's ``Perception`` on ``dev`` over the recording ``rec_dir``,
    recording every output frame under ``out_dir``; ``edit(cfg)`` sets the
    sections the sub-phase needs.  The config goes through ``set_config``
    (and its network validation); returns the facade after ``setup()``."""
    from lsd_tpu_torch.runtime import clear_interfaces
    from lsd_tpu_torch.runtime.perception import Perception
    clear_interfaces()
    p = Perception(device=dev)
    cfg = p.get_config()
    cfg["pipeline"] = pipeline
    cfg["input"].update(mode="offline", data_path=rec_dir)
    cfg["system"]["record"].update(use=True, path=out_dir)
    edit(cfg)
    verdict = p.set_config(cfg)
    if verdict not in ("Success", "Reset", "Reboot"):
        fail(f"pipeline: set_config refused the config: {verdict}")
    p.setup()
    return p


class Stamps:
    """Replaces ``owner.name`` (a module's function, a class's method or an
    object's) by a wrapper that keeps, without a synchronize, the host
    clock at each return, the call's host ms (wall, and the CPU time of
    its thread: the difference is time spent waiting, for the GIL among
    others) and its result (with ``keep``; else whether it was truthy),
    until ``restore()``."""

    def __init__(self, owner, name, keep=False):
        self.owner, self.name, self.keep = owner, name, keep
        self.fn = getattr(owner, name)
        self.own = isinstance(owner, type) or name in vars(owner)
        self.times, self.results, self.ms, self.cpu_ms = [], [], [], []
        fn = self.fn

        def wrapped(*args, **kwargs):
            t0, c0 = time.perf_counter(), time.thread_time()
            out = fn(*args, **kwargs)
            t1, c1 = time.perf_counter(), time.thread_time()
            self.times.append(t1)
            self.results.append(out if self.keep else bool(out))
            self.ms.append((t1 - t0) * 1e3)
            self.cpu_ms.append((c1 - c0) * 1e3)
            return out
        setattr(owner, name, wrapped)

    def first_true(self):
        """The host clock at the first call whose result was truthy."""
        return next(t for t, out in zip(self.times, self.results) if out)

    def restore(self):
        if self.own:
            setattr(self.owner, self.name, self.fn)
        else:
            delattr(self.owner, self.name)


def drive_pipeline(where, p, count, n):
    """Start ``p`` and wait until ``count()`` reaches ``n``, watching the
    pipeline's status; returns the statuses seen.  Nothing is traced while
    the pipeline's threads run: a card run crashed in a thread without a
    Python frame as phase 10c began, right after 10b's profiled stretch
    (ROADMAP queue C)."""
    statuses = set()
    deadline = time.perf_counter() + PIPE_TIMEOUT_S
    p.start()
    while True:
        c = count()
        if c >= n:
            break
        st = p.get_status()
        statuses.add(st["status"])
        if st["status"] == "Error" or time.perf_counter() > deadline:
            fail(f"pipeline ({where}): {c} of {n} frames done; status {st}")
        time.sleep(0.002)
    statuses.add(p.get_status()["status"])
    return statuses


def recorded_frames(out_dir):
    """The frame dicts the pipeline's FrameSinkModule wrote, in order, read
    back with the port's player."""
    from lsd_tpu_torch.io.player import FramePlayer
    dirs = sorted(os.path.join(out_dir, d) for d in os.listdir(out_dir))
    player = FramePlayer(dirs)
    return [player.read_dict(k) for k in range(len(player))]


def check_modules(where, p, statuses):
    """No module restarted, the status was never Error, every module's
    thread is alive."""
    st = p.get_status()
    if st["restarts"] or "Error" in statuses:
        fail(f"pipeline ({where}): restarts {st['restarts']}, statuses {sorted(statuses)}")
    dead = [name for name, m in st["modules"].items() if not m["alive"]]
    if dead:
        fail(f"pipeline ({where}): the threads of {dead} are not alive")
    return st


def pipeline_report(where, card, n, first, done, stage, read, conv, direct, launches,
                    extra):
    """The numbers every sub-phase reports over the timed window, the first
    PIPE_TIMED[where] frames (the frames after them were once profiled and
    are left out, so the figures stay comparable): ms per frame from the first frame
    in to the last of them done; the stage's ``process`` per frame (median
    over them, and the first frame, which warms the path up); reading a
    frame (``FramePlayer.read_dict``) and ``frame_from_dict``, mean wall and
    thread CPU ms (a mean: the thread clock may tick in 10 ms steps); and
    the whole drive's ms per frame."""
    k = PIPE_TIMED[where]
    t_first = first.first_true()
    mean = lambda a: float(np.mean(a[:k]))
    report = dict(card=card, frames=n, timed_frames=k,
                  ms_per_frame=(done.times[k - 1] - t_first) / k * 1e3,
                  stage_ms_median=float(np.median(stage.ms[1:k])), stage_ms_first=stage.ms[0],
                  direct_ms_per_scan=direct, p2p_launches=launches,
                  get_data_host_ms_per_frame=mean(read.ms) + mean(conv.ms),
                  read_dict_host_ms=mean(read.ms), read_dict_cpu_ms=mean(read.cpu_ms),
                  frame_from_dict_host_ms=mean(conv.ms), frame_from_dict_cpu_ms=mean(conv.cpu_ms),
                  ms_per_frame_all_frames=(done.times[n - 1] - t_first) / n * 1e3, **extra)
    log(f"pipeline ({where}) on {card}: {report}")
    return report


def run_pipeline_mapping(dev, card, root, sim, data, nav0, direct):
    """Phase 10a: phase 4's scans, with RTK fixes from the truth, replayed
    through the default pipeline in mapping mode; returns the report and the
    saved map's directory."""
    from lsd_tpu_torch.comms import MessageBus
    from lsd_tpu_torch.comms.messages import decode_typed
    from lsd_tpu_torch.io.frame import IMU_CAPACITY
    from lsd_tpu_torch.io.player import FramePlayer
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.runtime import call_interface, modules
    from lsd_tpu_torch.slam.lio import lio_init
    from lsd_tpu_torch.slam.map_io import load_map
    from lsd_tpu_torch.tools.recording import write_recording

    n = len(data)
    t0 = time.perf_counter()
    rec_dir = write_recording(os.path.join(root, "rec_mapping"), sim, data, with_fixes=True)
    log(f"pipeline (mapping): wrote {n} frames with fixes in {time.perf_counter() - t0:.1f} s")

    def edit(cfg):
        cfg["slam"].update(mode="mapping", resolution=0.4, key_frames_interval=[1.5, 0.3])
    out_dir = os.path.join(root, "out_mapping")
    p = pipeline_perception(dev, rec_dir, out_dir, [["Source", "SLAM", "Sink"]], edit)
    slam = p.module_manager.modules["SLAM"]
    eng = slam.engine
    if not (eng.cfg.async_graph and eng.cfg.async_fetch):
        fail("pipeline (mapping): SlamModule no longer runs async_graph and async_fetch by default")
    # the simulator's start, as the reference's own replay test seeds it
    eng.lio_state = lio_init(eng.cfg.lio, nav0)
    odometry = []
    sub = MessageBus.core().subscribe(
        lambda ch, payload: odometry.append(payload) if ch == "slam.odometry" else None)
    read = Stamps(FramePlayer, "read_dict")
    conv = Stamps(modules, "frame_from_dict")
    first = Stamps(p.module_manager.modules["Source"], "get_data")
    done = Stamps(eng, "_complete_scan")
    stage = Stamps(slam, "process")
    p2p_reduce.launches.reset()
    try:
        statuses = drive_pipeline("mapping", p, lambda: len(eng.odometry), n)
        launches = p2p_reduce.launches.read()
        eng.flush()                     # the graph worker's last jobs
        if call_interface("slam.save_mapping", os.path.join(root, "maps"), "pipeline") != "ok":
            fail("pipeline (mapping): slam.save_mapping did not answer ok")
        slam.editor._save_thread.join(timeout=300)
        check_modules("mapping", p, statuses)
    finally:
        for s in (read, conv, first, done, stage):
            s.restore()
        sub.close()
        p.release()
    map_dir = os.path.join(root, "maps", "pipeline")
    gt = np.stack([d[5] for d in data])
    traj = eng.trajectory()
    stamps = [s for s, _ in eng.odometry]
    if traj.shape != (n, 4, 4) or stamps != [1_000_000 + k * 100_000 for k in range(n)]:
        fail(f"pipeline (mapping): {traj.shape[0]} scans integrated of {n}, stamps {stamps[:3]}...")
    if eng.worker_errors:
        fail(f"pipeline (mapping): the graph worker's jobs raised {eng.worker_errors!r}")
    rmse = float(np.sqrt(np.mean(np.sum((traj[:, :3, 3] - gt[:, :3, 3]) ** 2, axis=1))))
    n_kf = len(eng.store)
    if not (n_kf > 15 and len(eng.loops) >= 1 and rmse < MAPPING_RMSE_LIMIT_M):
        fail(f"pipeline (mapping): {n_kf} keyframes, {len(eng.loops)} loops ({eng.loop_stats}), "
             f"RMSE {rmse} m; expected more than 15, at least 1, below {MAPPING_RMSE_LIMIT_M}")
    if not eng.graph.gps or eng.origin_lla is None:
        fail(f"pipeline (mapping): {len(eng.graph.gps)} GPS priors, origin {eng.origin_lla}")
    if not os.path.exists(os.path.join(map_dir, "graph", "graph.g2o")):
        fail("pipeline (mapping): slam.save_mapping wrote no graph.g2o")
    loaded = load_map(map_dir)
    if len(loaded["poses"]) != n_kf:
        fail(f"pipeline (mapping): the saved map loads {len(loaded['poses'])} poses of {n_kf}")
    if launches != eng.cfg.lio.max_iters * n:
        fail(f"pipeline (mapping): p2p_reduce launched {launches} times over {n} scans, "
             f"expected max_iters x scans = {eng.cfg.lio.max_iters * n}")
    if not odometry or decode_typed(odometry[-1])[0] != "Odometry":
        fail(f"pipeline (mapping): the bus subscriber received {len(odometry)} slam.odometry "
             "messages")
    frames = recorded_frames(out_dir)
    recorded = {d["frame_start_timestamp"] for d in frames if d.get("slam_pose") is not None}
    if len(recorded) != n:
        fail(f"pipeline (mapping): the sink recorded {len(recorded)} of {n} frames with a pose")
    report = pipeline_report(
        "mapping", card, n, first, done, stage, read, conv, direct, launches,
        dict(imu_rows_per_frame=int(data[0][4].sum()), imu_slots_per_lio_step=IMU_CAPACITY,
             keyframes=n_kf, loops=len(eng.loops), loop_stats=eng.loop_stats, rmse_m=rmse,
             gps_priors=len(eng.graph.gps), orientation_priors=len(eng.graph.orient),
             origin_lla=[float(v) for v in eng.origin_lla], bus_odometry_messages=len(odometry),
             sink_frames=len(frames), max_iters=eng.cfg.lio.max_iters,
             ds_capacity=eng.cfg.lio.ds_capacity,
             # the stage's tail over every frame: odometry waits while the
             # graph worker's queue is full (slam/mapper.py:_enqueue_graph_job)
             stage_ms_p95_all_frames=float(np.percentile(stage.ms[:n], 95)),
             stage_ms_max_all_frames=float(np.max(stage.ms[:n])),
             dropped_jobs=eng.loop_stats.get("dropped_jobs", 0)))
    return report, map_dir


def run_pipeline_localization(dev, card, root, sim, map_dir, direct):
    """Phase 10b: 70 scans of ``localization_drive``, from rest, with fixes,
    through the default pipeline in localization mode on 10a's map."""
    from lsd_tpu_torch.io.frame import IMU_CAPACITY
    from lsd_tpu_torch.io.player import FramePlayer
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.runtime import call_interface, modules
    from lsd_tpu_torch.tools.profile_lio import localization_drive
    from lsd_tpu_torch.tools.recording import write_recording

    n = N_PIPE_LOC
    drive, scans, hint = localization_drive(sim, n, CAP)
    rec_dir = write_recording(os.path.join(root, "rec_localization"), drive, scans,
                              t_start=LOC_T_START, first_us=20_000_000, with_fixes=True,
                              p0=sim.pose(0.0)[1])

    def edit(cfg):
        cfg["slam"].update(mode="localization", map_path=map_dir)
    out_dir = os.path.join(root, "out_localization")
    p = pipeline_perception(dev, rec_dir, out_dir, [["Source", "SLAM", "Sink"]], edit)
    slam = p.module_manager.modules["SLAM"]
    eng = slam.engine
    call_interface("slam.set_init_pose", hint.tolist())
    read = Stamps(FramePlayer, "read_dict")
    conv = Stamps(modules, "frame_from_dict")
    first = Stamps(p.module_manager.modules["Source"], "get_data")
    done = Stamps(eng, "process_scan", keep=True)
    stage = Stamps(slam, "process")
    p2p_reduce.launches.reset()
    try:
        statuses = drive_pipeline("localization", p, lambda: len(done.times), n)
        launches = p2p_reduce.launches.read()
        side_scans = eng._lio_n
        check_modules("localization", p, statuses)
    finally:
        for s in (read, conv, first, done, stage):
            s.restore()
        p.release()
    statuses_out = [o["status"] for o in done.results[:n]]
    poses = {}
    for d in recorded_frames(out_dir):
        poses.setdefault(d["frame_start_timestamp"], d["slam_pose"])
    stamps = [20_000_000 + k * 100_000 for k in range(n)]
    if sorted(poses) != stamps:
        fail(f"pipeline (localization): the sink recorded {len(poses)} of {n} frames")
    errs = [float(np.linalg.norm(np.asarray(poses[s])[:3, 3] - scans[k][5][:3, 3]))
            for k, s in enumerate(stamps)]
    rmse = float(np.sqrt(np.mean(np.square(errs[3:]))))
    if not rmse < LOC_RMSE_LIMIT_M:
        fail(f"pipeline (localization): position RMSE {rmse} m after the first 3 poses is not "
             f"below {LOC_RMSE_LIMIT_M} m; errors {errs}; statuses {statuses_out}")
    if not np.all(np.abs(np.diff(errs[-4:])) < LOC_TAIL_STEP_M):
        fail(f"pipeline (localization): the last four errors {errs[-4:]} differ by "
             f"{LOC_TAIL_STEP_M} m or more")
    if side_scans != n or launches != eng.cfg.lio.max_iters * side_scans:
        fail(f"pipeline (localization): p2p_reduce launched {launches} times, the side LIO ran "
             f"{side_scans} scans of {n}; expected max_iters x side-LIO scans")
    return pipeline_report(
        "localization", card, n, first, done, stage, read, conv, direct, launches,
        dict(imu_rows_per_frame=int(scans[0][4].sum()), imu_slots_per_lio_step=IMU_CAPACITY,
             rmse_m=rmse, max_err_m=float(np.max(errs[3:])), last_errs_m=errs[-4:],
             side_lio_scans=side_scans,
             statuses={s: statuses_out.count(s) for s in sorted(set(statuses_out))}))


def free_udp_sockets(n):
    """``n`` loopback UDP sockets bound to ports that ``network_validation``
    accepts (1024-49151): a receiver here, or ports for the sources and
    sinks to bind once these are closed (the reference's own tests use fixed
    ports, which may be in use beside this run)."""
    import socket
    held = []
    for port in range(20000, 49151, 7):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.bind(("127.0.0.1", port))
            held.append(s)
        except OSError:
            s.close()
        if len(held) == n:
            return held
    fail(f"found {len(held)} free UDP ports on the loopback of {n}")


def run_pipeline_detection(dev, card, root, direct):
    """Phase 10c: 20 frames of phase 8's drive through [Source, Detect,
    Sink] with the 0.2 m checkpoint, the UDP sink sending to a receiver here."""
    from lsd_tpu_torch.io.player import FramePlayer
    from lsd_tpu_torch.io.recorder import FrameRecorder
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.proto.detection import parse_detection, serialize_detection
    from lsd_tpu_torch.runtime import modules
    from lsd_tpu_torch.tools.profile_detector import ego_drive
    from lsd_tpu_torch.tools.recording import points_frame_dict

    n = N_PIPE_DET
    frames, _ = ego_drive(n)
    rec = FrameRecorder(os.path.join(root, "rec_detection"))
    for k, (pts, msk, motion) in enumerate(frames):
        rec.write(points_frame_dict(pts, msk, 1_000_000 + k * 100_000, motion))
    sock = free_udp_sockets(1)[0]
    sock.settimeout(0.2)
    port = sock.getsockname()[1]
    datagrams, stop = [], threading.Event()

    def receive():
        while not stop.is_set():
            try:
                datagrams.append(sock.recv(65535))
            except OSError:
                continue
    receiver = threading.Thread(target=receive, name="UdpReceiver", daemon=True)
    receiver.start()

    def edit(cfg):
        cfg["detection"].update(enable=True, capacity="reference")
        cfg["output"]["protocol"]["UDP"].update(use=True, dest="127.0.0.1", port=port)
    out_dir = os.path.join(root, "out_detection")
    p = pipeline_perception(dev, rec.log_dir, out_dir, [["Source", "Detect", "Sink"]], edit)
    detect = p.module_manager.modules["Detect"]
    sink = p.module_manager.modules["Sink"]
    read = Stamps(FramePlayer, "read_dict")
    conv = Stamps(modules, "frame_from_dict")
    first = Stamps(p.module_manager.modules["Source"], "get_data")
    done = Stamps(detect, "process")
    p2p_reduce.launches.reset()
    try:
        statuses = drive_pipeline("detection", p, lambda: len(done.times), n)
        launches = p2p_reduce.launches.read()
        deadline = time.perf_counter() + 30
        while (sink.frames < n or len(datagrams) < n) and time.perf_counter() < deadline:
            time.sleep(0.01)
        check_modules("detection", p, statuses)
    finally:
        for s in (read, conv, first, done):
            s.restore()
        p.release()
        stop.set()
        receiver.join(5)
        sock.close()
    recorded = recorded_frames(out_dir)
    m = min(len(recorded), len(datagrams))
    stamps = [d["frame_start_timestamp"] for d in recorded[:n]]
    if m < n or stamps != [1_000_000 + k * 100_000 for k in range(n)]:
        fail(f"pipeline (detection): {len(recorded)} frames recorded, {len(datagrams)} datagrams "
             f"received; expected the {n} frames in order first")
    objects = []
    for k in range(m):
        got = parse_detection(datagrams[k])
        want = parse_detection(serialize_detection(dict(objects=recorded[k]["objects"])))
        if got["header"]["timestamp"] != recorded[k]["frame_timestamp_monotonic"] or \
                got.get("object", []) != want.get("object", []):
            fail(f"pipeline (detection): datagram {k} does not parse back to the objects the "
                 f"sink recorded for frame {recorded[k]['frame_start_timestamp']}")
        objects.append(len(recorded[k]["objects"]))
    if not any(objects[:n]):
        fail("pipeline (detection): no frame has an object")
    if launches != 0:
        fail(f"pipeline (detection): p2p_reduce launched {launches} times; no SLAM runs here")
    return pipeline_report(
        "detection", card, n, first, done, done, read, conv, direct, launches,
        dict(datagrams=len(datagrams), recorded_frames=len(recorded),
             objects_per_frame=objects[:n], udp_port=port))


def run_pipeline(dev, card, sim, data, mapping_report, loc_report, det_report, keep_map):
    """Phase 10: the runtime's default pipeline, mapping, localization on
    that map, and detection; 10a's map is copied to ``keep_map``."""
    from lsd_tpu_torch.tools.profile_lio import nav_at_start
    report = {}
    with tempfile.TemporaryDirectory() as root:
        report["mapping"], map_dir = run_pipeline_mapping(
            dev, card, root, sim, data[:N_PIPE_MAP], nav_at_start(sim, dev),
            dict(phase4_sync=mapping_report["ms_per_scan"],
                 phase4_async=mapping_report["async"]["ms_per_scan"]))
        shutil.copytree(map_dir, keep_map)
        report["localization"] = run_pipeline_localization(
            dev, card, root, sim, map_dir,
            dict(phase6_process_scan_median=loc_report["ms_per_process_scan_median"]))
        report["detection"] = run_pipeline_detection(
            dev, card, root,
            dict(phase8_frame_median=det_report["drive"]["reference"]["ms_per_frame_median"]))
    return report


# ---------------------------------------------------------------------------
# phase 11: training


def training_setups():
    """Per model: its trainer (``make(device, seed, lr, warmup, total,
    dtype)``; ``dtype`` None trains in the model's own types, float32 gives
    the detector's float32 twin), its batches, its shipped checkpoint and
    how the served path scores a checkpoint (mean AP, the JAX package's,
    the bar)."""
    import torch
    from lsd_tpu_torch.detection.mono3d_infer import Mono3DInfer
    from lsd_tpu_torch.models.detector import DetectorConfig
    from lsd_tpu_torch.models.mono3d import Mono3DConfig
    from lsd_tpu_torch.models.yolo2d import Yolo2DConfig
    from lsd_tpu_torch.runtime.modules import build_detector_predict_fn
    from lsd_tpu_torch.runtime.trafficlight_module import build_yolo_predict_fn
    from lsd_tpu_torch.tools.profile_detector import eval_scenes, mean_ap, scene_config
    from lsd_tpu_torch.training import camera_data as cd
    from lsd_tpu_torch.training.data import SyntheticDetectionDataset
    from lsd_tpu_torch.training.mono3d import Mono3DTrainer
    from lsd_tpu_torch.training.trainer import Trainer, TrainerConfig
    from lsd_tpu_torch.training.yolo import YoloTrainer
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")

    def detector(dev, seed, lr, warmup, total, dtype=None):
        return Trainer(DetectorConfig.reference_capacity(),
                       TrainerConfig(lr=lr, warmup_steps=warmup, total_steps=total), device=dev,
                       seed=seed, dtype=dtype or torch.bfloat16)

    def detector_ap(path, dev):
        predict = build_detector_predict_fn(path, DetectorConfig.reference_capacity(), device=dev)
        return mean_ap(predict, eval_scenes())[0], JAX_MEAN_AP["reference"], DET_AP_MARGIN

    def mono3d_ap(path, dev):
        scenes = cd.SyntheticMono3DDataset(cd.Mono3DSceneConfig(hw=(384, 640)), batch_size=4,
                                           seed=999).batches(4)
        model = Mono3DInfer(path, device=dev).model
        frames = cd.mono3d_frames(model, scenes, cd.default_intrinsic((384, 640)), dev)
        return cd.mono3d_ap(frames)["mean_ap"], JAX_MONO3D_AP, MONO3D_AP_BAR

    def yolo_ap(path, dev):
        model = build_yolo_predict_fn(path, cfg=Yolo2DConfig(num_classes=4), device=dev).model
        scenes = cd.SyntheticTrafficLightDataset(cd.TrafficLightSceneConfig(), batch_size=4,
                                                 seed=999).batches(4)
        return cd.yolo2d_ap(cd.yolo2d_frames(model, scenes, dev), 4)["mean_ap"], JAX_YOLO_AP, \
            YOLO_AP_BAR

    return {
        "detector": dict(
            make=detector, weights=os.path.join(root, "detector_refcap.msgpack"),
            data=lambda seed: SyntheticDetectionDataset(scene_config(), batch_size=2, seed=seed),
            batch=2, serve=detector_ap),
        "mono3d": dict(
            make=lambda dev, seed, lr, warmup, total, dtype=None: Mono3DTrainer(
                Mono3DConfig(), lr=lr, total_steps=total, seed=seed, device=dev),
            weights=os.path.join(root, "mono3d.msgpack"),
            data=lambda seed: cd.SyntheticMono3DDataset(cd.Mono3DSceneConfig(hw=(384, 640)),
                                                        batch_size=4, seed=seed),
            batch=4, serve=mono3d_ap),
        "yolo2d": dict(
            make=lambda dev, seed, lr, warmup, total, dtype=None: YoloTrainer(
                Yolo2DConfig(num_classes=4), hw=(256, 320), lr=lr, total_steps=total, seed=seed,
                device=dev),
            weights=os.path.join(root, "yolo2d_trafficlight.msgpack"),
            data=lambda seed: cd.SyntheticTrafficLightDataset(cd.TrafficLightSceneConfig(),
                                                              batch_size=8, seed=seed),
            batch=8, serve=yolo_ap),
    }


def gradients(tr, batch):
    """(loss, {name: gradient}) of one batch, nothing stepped; a float64
    model takes its image in float64."""
    import torch
    if "image" in batch and next(tr.model.parameters()).dtype == torch.float64:
        batch = dict(batch, image=batch["image"].astype(np.float64))
    tr.opt.zero_grad()
    loss, _ = tr.loss_on_batch(tr.upload(batch))
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in tr.model.named_parameters()}


def leaf_share(got, want):
    """Largest |got - want| over the largest |want|, each leaf on the CPU."""
    return {n: float((got[n].cpu() - w).abs().max() / max(float(w.abs().max()), 1e-30))
            for n, w in want.items()}


def leaf_cos_gap(got, want):
    """Per leaf: (cosine similarity, relative norm gap) in float64."""
    out = {}
    for n, w in want.items():
        g, w = got[n].cpu().double().reshape(-1), w.double().reshape(-1)
        out[n] = (float(g @ w / (g.norm() * w.norm())), float((g - w).norm() / w.norm()))
    return out


def optimizer_update(tr, grads):
    """The parameters' change of one optimizer step from ``grads`` with the
    optimizer at the end of its warmup (peak lr, zero moments); the
    parameters and the optimizer are put back."""
    import torch
    state = {k: (v if isinstance(v, int) else {n: t.clone() for n, t in v.items()})
             for k, v in tr.opt.state_dict().items()}
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    tr.opt.count = tr.opt.schedule_count = tr.opt.warmup_steps
    for n, p in tr.model.named_parameters():
        p.grad = grads[n].to(p.device)
    tr.opt.step()
    tr.opt.zero_grad()
    upd = {n: p.detach() - before[n] for n, p in tr.model.named_parameters()}
    with torch.no_grad():
        for n, p in tr.model.named_parameters():
            p.copy_(before[n])
    tr.opt.load_state_dict(state)
    return upd


def check_train_parity(name, setup, dev):
    """Step 1: one batch's gradients on the card against the CPU, from the
    shipped checkpoint, and the optimizer's update from the same gradient.
    The float32 models are also held to their float64 twin on the card: the
    card's gradient must be as close to it as the CPU's (within
    TRAIN_GRAD_RTOL or twice the CPU's distance, per leaf)."""
    import torch
    batch = next(setup["data"](1).batches(1))
    float_twin = name != "yolo2d"           # Yolo2D computes in bf16 everywhere
    runs = {}
    for key, where, dtype in (("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
                              ("card64", dev, torch.float64)):
        if key == "card64" and not float_twin:
            continue
        tr = setup["make"](where, 0, 1e-3, 100, 1000, dtype if float_twin else None)
        if dtype == torch.float64:
            tr.model.double()
        tr.load(setup["weights"])
        t0 = time.perf_counter()
        loss, grads = gradients(tr, batch)
        runs[key] = (tr, loss, grads, (time.perf_counter() - t0) * 1e3)
    (cpu_tr, cpu_loss, cpu_g, cpu_ms), (card_tr, card_loss, card_g, card_ms) = \
        runs["cpu"], runs["card"]
    report = dict(loss_cpu=cpu_loss, loss_card=card_loss, cpu_ms=cpu_ms, card_ms=card_ms,
                  leaves=len(cpu_g))
    if float_twin:
        truth = {n: g.cpu().double() for n, g in runs["card64"][2].items()}
        share = leaf_share(card_g, cpu_g)
        to_cpu, to_card = leaf_share(cpu_g, truth), leaf_share(card_g, truth)
        bars = {n: max(TRAIN_GRAD_RTOL, 2.0 * e) for n, e in to_cpu.items()}
        worst = max(share, key=share.get)
        report.update(loss_float64=runs["card64"][1], grad_card_vs_cpu_max_share=share[worst],
                      grad_card_vs_cpu_worst_leaf=worst,
                      grad_cpu_vs_float64_max_share=max(to_cpu.values()),
                      grad_cpu_vs_float64_worst_leaf=max(to_cpu, key=to_cpu.get),
                      grad_card_vs_float64_max_share=max(to_card.values()),
                      grad_card_vs_float64_worst_leaf=max(to_card, key=to_card.get),
                      float64_ms=runs["card64"][3])
        bad = {n: (e, bars[n]) for n, e in to_card.items() if e > bars[n]}
        if bad:
            fail(f"training ({name}): the card's float32 gradients are further from the float64 "
                 f"twin's than the CPU's allow (leaf: distance, bar): {bad}")
    else:
        cg = leaf_cos_gap(card_g, cpu_g)
        # a ConvBlock's conv bias feeds a GroupNorm, which subtracts each
        # group's mean: its exact gradient is (nearly) 0 and what either place
        # computes is bf16 rounding (tests/test_torch_train_camera.py)
        judged = {n: v for n, v in cg.items() if not (n.startswith("ConvBlock")
                                                      and n.endswith("Conv_0.bias"))}
        report.update(min_cos=min(c for c, _ in judged.values()),
                      max_gap=max(g for _, g in judged.values()),
                      before_groupnorm_cos={n: c for n, (c, _) in cg.items() if n not in judged})
        bad = {n: v for n, v in judged.items() if v[0] < YOLO_GRAD_COS or v[1] > YOLO_GRAD_GAP}
        if bad:
            fail(f"training ({name}): gradients differ between card and CPU beyond cosine "
                 f"{YOLO_GRAD_COS} / gap {YOLO_GRAD_GAP}: {bad}")
    # the optimizer on the card against the CPU, both from the CPU's gradient
    upd_cpu = optimizer_update(cpu_tr, cpu_g)
    upd_card = optimizer_update(card_tr, cpu_g)
    ushare = leaf_share(upd_card, upd_cpu)
    uworst = max(ushare, key=ushare.get)
    # not judged: the card's update from its own gradient (Adam divides each
    # element by its own RMS: a gradient within rounding noise of 0 moves by
    # up to lr either way)
    own = leaf_cos_gap(optimizer_update(card_tr, card_g), upd_cpu)
    report.update(update_max_share=ushare[uworst], update_worst_leaf=uworst,
                  own_gradient_update_max_gap=max(g for _, g in own.values()),
                  own_gradient_update_min_cos=min(c for c, _ in own.values()))
    if ushare[uworst] > TRAIN_GRAD_RTOL:
        fail(f"training ({name}): the optimizer's update of {uworst} differs between card and "
             f"CPU by {ushare[uworst]:.3e} of its largest magnitude (bar {TRAIN_GRAD_RTOL})")
    log(f"training ({name}), card against CPU from the shipped checkpoint: {report}")
    return report


def check_learns(name, setup, dev):
    """Step 2: from a seeded initialisation the loss falls."""
    import torch
    n = TRAIN_LEARN_STEPS[name]
    tr = setup["make"](dev, 0, TRAIN_LEARN_LR[name], TRAIN_LEARN_WARMUP, n)
    t0 = time.perf_counter()
    losses = [tr.train_step(tr.upload(b))[0] for b in setup["data"](0).batches(n)]
    losses = torch.stack(losses).cpu().numpy().astype(float)
    wall = time.perf_counter() - t0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    drop = 1.0 - last / first
    report = dict(steps=n, lr=TRAIN_LEARN_LR[name], first10=first, last10=last, drop=drop,
                  bar=TRAIN_LOSS_DROP[name], s_with_data=wall, losses=losses.tolist())
    log(f"training ({name}), {n} steps from a seeded initialisation: mean loss of the first 10 "
        f"{first:.4f}, of the last 10 {last:.4f}, drop {drop:.3f} (bar {TRAIN_LOSS_DROP[name]})")
    if not np.isfinite(losses).all():
        fail(f"training ({name}): a loss is not finite: {losses.tolist()}")
    if not drop > TRAIN_LOSS_DROP[name]:
        fail(f"training ({name}): the mean loss fell by {drop:.3f}, not by more than "
             f"{TRAIN_LOSS_DROP[name]}")
    return report


def flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, prefix + k + "/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype))
    return out


def check_warm_checkpoint(name, setup, dev, out_dir):
    """Step 3: warm-started from the shipped checkpoint, a few steps, saved,
    and served within the model's AP bar."""
    from lsd_tpu_torch.models.params_io import load_params
    tr = setup["make"](dev, 0, TRAIN_WARM_LR, 1, TRAIN_WARM_STEPS + 1)
    tr.load(setup["weights"])
    for b in setup["data"](2).batches(TRAIN_WARM_STEPS):
        tr.train_step(tr.upload(b))
    path = tr.save(os.path.join(out_dir, f"{name}.msgpack"))
    saved, shipped = flat_shapes(load_params(path)), flat_shapes(load_params(setup["weights"]))
    if saved != shipped:
        fail(f"training ({name}): the saved checkpoint's keys or shapes differ from the shipped "
             f"file's: {sorted(set(saved.items()) ^ set(shipped.items()))[:6]}")
    ap, ref, bar = setup["serve"](path, dev)
    report = dict(steps=TRAIN_WARM_STEPS, lr=TRAIN_WARM_LR, leaves=len(saved), mean_ap=ap,
                  jax_mean_ap=ref, bar=bar)
    log(f"training ({name}): warm-started, {TRAIN_WARM_STEPS} steps, saved and served: "
        f"mean AP {ap:.4f} (the JAX package's {ref:.4f}, bar {bar})")
    if not abs(ap - ref) <= bar:
        fail(f"training ({name}): the saved checkpoint serves at mean AP {ap:.4f}, not within "
             f"{bar} of {ref:.4f}")
    return report, tr


def time_training(tr, setup):
    """Step 4 (reported): one batch's step timed and profiled."""
    import torch
    batch = next(setup["data"](3).batches(1))
    step = lambda: tr.train_step(tr.upload(batch))
    events_ms = time_ms(step, n=TRAIN_TIMED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
    # the step's parts between CUDA events (gaps between them included)
    parts = {k: [] for k in ("forward_and_loss", "backward", "optim")}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = tr.loss_on_batch(tr.upload(batch))
        ev[1].record()
        loss.backward()
        ev[2].record()
        tr.opt.step()
        tr.opt.zero_grad()
        ev[3].record()
        ev[3].synchronize()
        for k, a, b in zip(parts, ev, ev[1:]):
            parts[k].append(a.elapsed_time(b))
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    syncs, sites = syncs_per_call(step)
    # the detector's spans detect/* nest in train/forward
    prof = profile_calls(step, 5, prefixes=("train/", "detect/"))
    return dict(batch=setup["batch"], ms_per_step_events=events_ms, ms_per_step_wall=wall_ms,
                frames_per_s=setup["batch"] / wall_ms * 1e3,
                ms_by_part_events={k: float(np.median(v)) for k, v in parts.items()},
                peak_memory_bytes=int(peak), host_syncs_per_step=syncs, host_sync_sites=sites,
                # the device's busy time over the untraced step (the trace's
                # own wall time includes the profiler's cost)
                device_idle_share_untraced=1.0 - prof["device_busy_ms"] / wall_ms, **prof)


def run_training(dev, card):
    """Phase 11: the three trainers at full width on the card."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    p2p_reduce.launches.reset()
    report = dict(card=card)
    with tempfile.TemporaryDirectory() as out_dir:
        for name, setup in training_setups().items():
            t0 = time.perf_counter()
            rep = dict(parity=check_train_parity(name, setup, dev))
            rep["learns"] = check_learns(name, setup, dev)
            rep["checkpoint"], tr = check_warm_checkpoint(name, setup, dev, out_dir)
            rep["step"] = time_training(tr, setup)
            rep["phase_s"] = time.perf_counter() - t0
            log(f"training ({name}) on {card}: {rep['step']['ms_per_step_events']:.2f} ms per step "
                f"(CUDA events), {rep['step']['ms_per_step_wall']:.2f} ms on the host clock, "
                f"{rep['step']['frames_per_s']:.1f} frames/s, parts {rep['step']['ms_by_part_events']}, "
                f"{rep['step']['launches']:.0f} launches and {rep['step']['host_syncs_per_step']} "
                f"host syncs per step, peak memory {rep['step']['peak_memory_bytes'] / 2**30:.2f} "
                f"GiB, idle {rep['step']['device_idle_share_untraced']:.3f} "
                f"({rep['step']['device_idle_share']:.3f} traced), spans {rep['step']['spans']}, "
                f"top kernels {rep['step']['top_kernels']}; {rep['phase_s']:.1f} s")
            report[name] = rep
            del tr
            torch.cuda.empty_cache()
    report["p2p_launches"] = p2p_reduce.launches.read()
    if report["p2p_launches"] != 0:
        fail(f"training: p2p_reduce launched {report['p2p_launches']} times; no SLAM runs here")
    return report


def rehearse_training():
    """Phase 11 on the host's CPU at reduced size, to check its control flow
    and set its loss-drop bars before a card run (the card-vs-CPU checks
    then compare the CPU with itself, and nothing of the card is timed):

        python3 -c "import chip_smoke; chip_smoke.rehearse_training()"

    The detector at +-25.6 m (16,384 pillars, 2**14 points), Mono3D at
    96 x 160 and Yolo2D at 128 x 160, full widths otherwise (the shipped
    weights load at any grid or image size); the AP bars are not judged.
    Prints each model's loss drop and parity report; ~90 s."""
    import torch
    from lsd_tpu_torch.models.detector import DetectorConfig
    from lsd_tpu_torch.models.mono3d import Mono3DConfig
    from lsd_tpu_torch.models.yolo2d import Yolo2DConfig
    from lsd_tpu_torch.training import camera_data as cd
    from lsd_tpu_torch.training.data import SyntheticDetectionDataset, SyntheticSceneConfig
    from lsd_tpu_torch.training.mono3d import Mono3DTrainer
    from lsd_tpu_torch.training.trainer import Trainer, TrainerConfig
    from lsd_tpu_torch.training.yolo import YoloTrainer

    class Event:
        def __init__(self, **_):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    g = globals()
    saved = {k: g[k] for k in ("time_ms", "profile_calls", "syncs_per_call", "training_setups",
                               "TRAIN_LOSS_DROP")}
    saved_cuda = {k: getattr(torch.cuda, k) for k in (
        "Event", "synchronize", "reset_peak_memory_stats", "max_memory_allocated", "empty_cache")}
    full = training_setups()
    dcfg = DetectorConfig.reference_capacity()._replace(
        pc_range=(-25.6, -25.6, -3.0, 25.6, 25.6, 3.0), max_voxels=16384)
    scfg = SyntheticSceneConfig(realistic=True, xy_range=24.0)
    m_hw, y_hw = (96, 160), (128, 160)
    small = {
        "detector": dict(make=lambda dev, seed, lr, warmup, total, dtype=None: Trainer(
            dcfg, TrainerConfig(lr=lr, warmup_steps=warmup, total_steps=total), device=dev,
            seed=seed, dtype=dtype or torch.bfloat16),
            data=lambda seed: SyntheticDetectionDataset(scfg, point_capacity=2 ** 14,
                                                        batch_size=2, seed=seed)),
        "mono3d": dict(make=lambda dev, seed, lr, warmup, total, dtype=None: Mono3DTrainer(
            Mono3DConfig(image_hw=m_hw), lr=lr, total_steps=total, seed=seed, device=dev),
            data=lambda seed: cd.SyntheticMono3DDataset(cd.Mono3DSceneConfig(hw=m_hw),
                                                        batch_size=4, seed=seed)),
        "yolo2d": dict(make=lambda dev, seed, lr, warmup, total, dtype=None: YoloTrainer(
            Yolo2DConfig(num_classes=4), hw=y_hw, lr=lr, total_steps=total, seed=seed,
            device=dev),
            data=lambda seed: cd.SyntheticTrafficLightDataset(cd.TrafficLightSceneConfig(hw=y_hw),
                                                              batch_size=8, seed=seed))}
    try:
        for k in saved_cuda:
            setattr(torch.cuda, k, Event if k == "Event" else (lambda *a, **kw: 0))
        g["time_ms"] = lambda fn, n=N_TIMING: (fn(), 0.0)[1]
        g["profile_calls"] = lambda fn, n, prefixes=(): dict(launches=0, device_busy_ms=0.0,
                                                             device_idle_share=0.0, spans={},
                                                             top_kernels=[])
        g["syncs_per_call"] = lambda fn, n=3: (0, {})
        g["training_setups"] = lambda: {
            name: dict(full[name], serve=lambda path, dev: (0.0, 0.0, 1.0), **small[name])
            for name in full}
        g["TRAIN_LOSS_DROP"] = {name: float("-inf") for name in full}
        report = run_training(torch.device("cpu"), "CPU rehearsal")
    finally:
        g.update(saved)
        for k, v in saved_cuda.items():
            setattr(torch.cuda, k, v)
    for name in full:
        log(f"rehearsal ({name}): loss drop {report[name]['learns']['drop']:.3f}, parity "
            f"{report[name]['parity']}")
    return report


# ---------------------------------------------------------------------------
# phase 12: the scoring path


def run_scoring_evaluate(dev):
    """12a: ``tools.evaluate`` over its six rows, the LIO on ``dev`` at full
    width, N_EVAL_SCANS scans each; returns the rows, each with its p2p
    launches and the finite state and weak-direction count of its run."""
    import torch
    import lsd_tpu_torch.slam as slam_pkg
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.tools import evaluate

    runs, last, weak = [], {}, []
    lio_step, run_tpu_lio = slam_pkg.lio_step, evaluate.run_tpu_lio

    def step(*args, **kwargs):
        st, info = lio_step(*args, **kwargs)
        last["st"] = st
        weak.append(info["n_weak"])
        return st, info

    def run(sim, data, warmup, wheelspeed=False, **kwargs):
        n0 = p2p_reduce.launches.read()
        weak.clear()
        out = run_tpu_lio(sim, data, warmup, wheelspeed=wheelspeed, **kwargs)
        st = last.pop("st")
        runs.append(dict(scans=len(data), launches=p2p_reduce.launches.read() - n0,
                         finite=all(bool(torch.isfinite(x).all()) for x in (*st.nav, st.P)),
                         max_weak_dirs=int(torch.stack(weak[warmup:]).max())))
        return out

    argv = ["--skip-reference", "--scans", str(N_EVAL_SCANS), "--points", str(CAP)]
    if dev.type == "cpu":                       # rehearse_scoring
        argv.append("--cpu")
    slam_pkg.lio_step, evaluate.run_tpu_lio = step, run
    try:
        rows = evaluate.main(argv)
    finally:
        slam_pkg.lio_step, evaluate.run_tpu_lio = lio_step, run_tpu_lio
    if [r["scenario"] for r in rows] != list(EVAL_ATE_BARS) or len(runs) != len(rows):
        fail(f"scoring (evaluate): rows {[r['scenario'] for r in rows]}, {len(runs)} runs")
    for row, r in zip(rows, runs):
        row.update(r)
        bar = EVAL_ATE_BARS[row["scenario"]]
        row["ate_bar_m"] = bar
        if r["launches"] != 4 * r["scans"]:
            fail(f"scoring (evaluate, {row['scenario']}): p2p_reduce launched {r['launches']} "
                 f"times over {r['scans']} scans, expected max_iters (4) x scans")
        if not r["finite"]:
            fail(f"scoring (evaluate, {row['scenario']}): the filter state is not finite")
        if bar is not None and not row["tpu_ate_m"] < bar:
            fail(f"scoring (evaluate, {row['scenario']}): ATE {row['tpu_ate_m']} m is not "
                 f"below {bar} m")
    tunnel = rows[[r["scenario"] for r in rows].index("tunnel")]
    if tunnel["max_weak_dirs"] < 1:
        fail(f"scoring (evaluate): the weak-direction gate never fired in the unaided tunnel "
             f"after the warm-up: {tunnel}")
    return rows


def loc_eval_run(map_dir, root, lio_fusion, dev):
    """One ``tools.loc_eval.run`` over the LOC_EVAL world; (report, launches,
    {stamp (us): the pose ``Localizer.process_scan`` returned, or None})."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.localization import Localizer
    from lsd_tpu_torch.tools import loc_eval
    poses, process_scan = {}, Localizer.process_scan

    def tapped(self, points, mask, stamp_us, **kwargs):
        out = process_scan(self, points, mask, stamp_us=stamp_us, **kwargs)
        pose = out.get("pose")
        poses[int(stamp_us)] = None if pose is None else np.asarray(pose, float).copy()
        return out
    n0 = p2p_reduce.launches.read()
    Localizer.process_scan = tapped
    try:
        rep = loc_eval.run(map_dir, laps=LOC_EVAL_LAPS, radius=LOC_EVAL_RADIUS,
                           points=LOC_EVAL_POINTS, dropout=None,
                           out_root=os.path.join(root, "loc"), lio_fusion=lio_fusion,
                           world="fig8", progress=log, device=dev)
    finally:
        Localizer.process_scan = process_scan
    return rep, p2p_reduce.launches.read() - n0, poses


def run_scoring_loc_eval(dev, root):
    """12b: ``tools.loc_eval.build_map`` and ``run`` through ``Perception`` on
    ``dev``; returns the report, the map, the map's recording root and the
    localizer's poses by stamp in the run with the side LIO."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.tools import loc_eval
    map_dir, map_root = os.path.join(root, "map"), os.path.join(root, "map_src")
    t0 = time.perf_counter()
    n0 = p2p_reduce.launches.read()
    built = loc_eval.build_map(map_dir, world="fig8", radius=LOC_EVAL_RADIUS, points=LOC_EVAL_POINTS,
                               out_root=map_root, progress=log, device=dev)
    built["launches"] = p2p_reduce.launches.read() - n0
    built["phase_s"] = time.perf_counter() - t0
    if built["scans"] != built["scans_total"]:
        fail(f"scoring (loc_eval map): {built['scans']} of {built['scans_total']} scans mapped")
    if not (built["keyframes"] >= LOC_EVAL_MIN_KEYFRAMES and built["loops"] >= 1):
        fail(f"scoring (loc_eval map): {built['keyframes']} keyframes, {built['loops']} loops; "
             f"expected at least {LOC_EVAL_MIN_KEYFRAMES} and 1")
    # SlamModule's max_iters (3) per scan, and 3 for run_session's one LIO
    # step on zeros before the clock starts (where the kernel is built)
    if built["launches"] != 3 * (built["scans"] + 1):
        fail(f"scoring (loc_eval map): p2p_reduce launched {built['launches']} times over "
             f"{built['scans']} scans, expected max_iters (3) x (scans + the warm-up step)")
    report = dict(map=built)
    fusion_poses = None
    for fusion in (True, False):
        t0 = time.perf_counter()
        # the side LIO's run under deterministic algorithms: phase 15d holds
        # tools.loc_diag to its poses, and the side LIO's cold start carries
        # the float atomics' run-to-run differences to millimetres
        was = deterministic() if fusion else None
        try:
            rep, launches, poses = loc_eval_run(map_dir, root, fusion, dev)
        finally:
            if fusion:
                deterministic(was)
        if fusion:
            fusion_poses = poses
        rep.update(launches=launches, phase_s=time.perf_counter() - t0)
        key = "loc" if fusion else "loc_no_fusion"
        report[key] = rep
        if rep["reloc_latency_frames"] is None or not (rep["tracking_fraction"] or 0) >= \
                LOC_EVAL_TRACKING:
            fail(f"scoring ({key}): relocalised after {rep['reloc_latency_frames']} frames, "
                 f"tracking fraction {rep['tracking_fraction']}; expected relocalised and "
                 f"at least {LOC_EVAL_TRACKING}")
        # run() stops waiting two frames short of the drive's end
        n_frames = int(LOC_EVAL_RADIUS * 4 * np.pi * LOC_EVAL_LAPS / 5.0 * 10)
        if fusion and not (launches % 3 == 0 and 3 * (n_frames - 2) <= launches <= 3 * n_frames):
            fail(f"scoring ({key}): p2p_reduce launched {launches} times over {n_frames} frames, "
                 f"expected the side LIO's max_iters (3) x frames")
        if not fusion and launches != 0:
            fail(f"scoring ({key}): p2p_reduce launched {launches} times without the side LIO")
        if fusion:
            # the side LIO starts cold at the drive's 5 m/s: both packages go
            # metres off here (ROADMAP queue C); held to the JAX package's run
            for k, want in JAX_LOC_EVAL_FUSION.items():
                if not abs(rep[k] - want) <= LOC_EVAL_FUSION_MARGIN[k]:
                    fail(f"scoring ({key}): {k} {rep[k]} is not within "
                         f"{LOC_EVAL_FUSION_MARGIN[k]} of the JAX package's {want} on this drive")
        elif not (rep["rmse_x_tracking_m"] < LOC_EVAL_RMSE_M
                  and rep["rmse_y_tracking_m"] < LOC_EVAL_RMSE_M
                  and rep["rmse_heading_tracking_deg"] < LOC_EVAL_HEADING_DEG):
            fail(f"scoring ({key}): tracked RMSE x {rep['rmse_x_tracking_m']} m, y "
                 f"{rep['rmse_y_tracking_m']} m, heading {rep['rmse_heading_tracking_deg']} deg; "
                 f"expected below {LOC_EVAL_RMSE_M} m and {LOC_EVAL_HEADING_DEG} deg")
    return report, map_dir, map_root, fusion_poses


def run_scoring_detection(dev, mot_frames):
    """12c: ``tools.eval_detection.evaluate_weights`` on the shipped 0.2 m
    checkpoint at its defaults (fp32 judged, int8 reported), and
    ``evaluate_mot`` on phase 8's drive (reported)."""
    from lsd_tpu_torch.detection.eval import evaluate_mot
    from lsd_tpu_torch.tools.eval_detection import evaluate_weights
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights", "detector_refcap.msgpack")
    report = {}
    for key, int8 in (("fp32", False), ("int8_ptq", True)):
        t0 = time.perf_counter()
        report[key] = evaluate_weights(weights, int8=int8, device=dev)
        report[key]["phase_s"] = time.perf_counter() - t0
    report["int8_mean_ap_delta_wod"] = round(
        report["int8_ptq"]["mean_ap_wod"] - report["fp32"]["mean_ap_wod"], 4)
    ap = report["fp32"]["mean_ap_wod"]
    if not abs(ap - JAX_DET_MEAN_AP_WOD) <= DET_EVAL_MARGIN:
        fail(f"scoring (eval_detection): fp32 mean_ap_wod {ap} is not within {DET_EVAL_MARGIN} "
             f"of the reference's {JAX_DET_MEAN_AP_WOD}")
    t0 = time.perf_counter()
    report["mot"] = evaluate_mot(mot_frames, device=dev)
    report["mot"].update(frames=len(mot_frames), ms=(time.perf_counter() - t0) * 1e3)
    return report


def tilted_corridor_scan(roll_deg, pitch_deg, height_m, points=CAP):
    """A ``CorridorSim`` sweep (lidar 1.5 m above the floor) seen by a lidar
    mounted ``height_m`` above the floor with the config rotation of
    ``roll_deg`` and ``pitch_deg``: (N, 4) float32 x y z i."""
    from lsd_tpu_torch.calibration.service import cfg_to_transform
    from lsd_tpu_torch.sim import CorridorSim, SimConfig
    sim = CorridorSim(SimConfig(n_scans=1, points_per_scan=points, point_noise=0.01, seed=6))
    pts, _ = sim.scan(0.0)
    R = cfg_to_transform(0, 0, 0, roll_deg, pitch_deg, 0)[:3, :3]
    body = pts.astype(float) + [0.0, 0.0, 1.5 - height_m]
    return np.concatenate([body @ R, np.zeros((len(pts), 1))], axis=1).astype(np.float32)


def rotation_deg(R):
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def run_scoring_calibration(map_dir, map_root):
    """12d: the calibration RPCs through the interface registry: ground
    leveling of a tilted corridor sweep, lidar-INS from 12b's keyframes and
    their fixes, and ``export_colmap`` of 12b's map read back."""
    import base64
    import pickle
    from lsd_tpu_torch.calibration import service
    from lsd_tpu_torch.geometry import np_so3
    from lsd_tpu_torch.runtime import call_interface, clear_interfaces, register_interface
    from lsd_tpu_torch.slam.keyframe import Keyframe
    from lsd_tpu_torch.slam.map_io import load_map
    from lsd_tpu_torch.slam.map_render import export_colmap

    clear_interfaces()
    service.register_calibration_interfaces()
    report = {}
    # ground: roll, pitch and height of the mount
    payload = base64.b64encode(tilted_corridor_scan(*CALIB_MOUNT).tobytes()).decode()
    contour = [[-15.0, -2.2], [15.0, -2.2], [15.0, 2.2], [-15.0, 2.2]]
    cfg = {"lidar": [{"extrinsic_parameters": [0, 0, 0, 0, 0, 0]}]}
    _, cfg = call_interface("calibration.calibrate_ground", cfg, payload, contour, 0)
    _, _, z, roll, pitch, _ = cfg["lidar"][0]["extrinsic_parameters"]
    report["ground"] = dict(mount_roll_pitch_height=list(CALIB_MOUNT), roll_deg=roll,
                            pitch_deg=pitch, height_m=z)
    if not (abs(roll - CALIB_MOUNT[0]) < CALIB_ANGLE_DEG and abs(pitch - CALIB_MOUNT[1])
            < CALIB_ANGLE_DEG and abs(z - CALIB_MOUNT[2]) < CALIB_HEIGHT_M):
        fail(f"scoring (calibration): ground leveling gave roll {roll}, pitch {pitch} deg, "
             f"height {z} m for the mount {CALIB_MOUNT}")

    # lidar-INS: the map's keyframes and the fixes recorded with them, pulled
    # through the live route (slam.get_pose + databank.get_latest)
    m = load_map(map_dir)
    z_rec = np.load(os.path.join(map_root, "rec_map", "gt.npz"))
    index = {int(t): k for k, t in enumerate(z_rec["ts_us"])}
    current = {}
    register_interface("slam.get_pose", lambda: current["pose"].tolist())
    register_interface("databank.get_latest", lambda: current["frame"])
    call_interface("calibration.restart_lidar_ins_calibration",
                   {"ins": {"extrinsic_parameters": [0, 0, 0, 0, 0, 0]}})
    truth = service._TrajectoryCalib()
    fed = 0
    for stamp, pose in zip(m["stamps"], m["poses"]):
        k = index[int(stamp)]
        with open(os.path.join(str(z_rec["log_dir"]), "%06d.pkl" % k), "rb") as fh:
            frame = pickle.load(fh)
        current.update(pose=np.asarray(pose, float), frame=frame)
        n = len(call_interface("calibration.lidar_ins_get_positions")["lidar"])
        if n > fed:                  # the pair passed the keyframe gate
            fed = n
            truth.feed(z_rec["gt"][k], service._fix_to_pose(truth, frame["ins_data"]))
    if not call_interface("calibration.calibrate_lidar_ins")["result"]:
        fail(f"scoring (calibration): lidar-INS calibration refused {fed} pairs")
    T = np.asarray(call_interface("calibration.get_lidar_ins_transform")).reshape(4, 4)
    T_id = truth.calibrate()           # the identity extrinsic in the calibrator's frames
    R_err = T_id[:3, :3].T @ T[:3, :3]
    yaw_err = float(np.degrees(abs(np.arctan2(R_err[1, 0], R_err[0, 0]))))
    t_err = float(np.linalg.norm(T[:3, 3] - T_id[:3, 3]))
    height_err = np.mean([abs(float(np.asarray(p)[2, 3]) - z_rec["gt"][index[int(t)]][2, 3])
                          for t, p in zip(m["stamps"], m["poses"])])
    report["lidar_ins"] = dict(pairs=fed, keyframes=len(m["poses"]), yaw_deg=yaw_err,
                               rotation_deg=rotation_deg(R_err),
                               rotation_of_identity_fit_deg=rotation_deg(T_id[:3, :3]),
                               translation_m=t_err, keyframe_height_err_m=float(height_err))
    # the drive is planar: the fit's roll and pitch come from the map's height
    # errors alone, so the bar holds the heading, which the drive determines
    if not (yaw_err < LIDAR_INS_DEG and t_err < LIDAR_INS_M):
        fail(f"scoring (calibration): lidar-INS transform {yaw_err} deg of heading and {t_err} "
             f"m from the identity extrinsic; expected within {LIDAR_INS_DEG} deg and "
             f"{LIDAR_INS_M} m")

    # COLMAP export of the map, read back
    K = np.asarray([[600.0, 0, 320], [0, 600, 240], [0, 0, 1]])
    T_cl = np.eye(4)
    T_cl[:3, 3] = [0.0, -0.3, 0.1]
    kfs = [Keyframe(id=i, stamp_us=int(s), pose=np.asarray(p, float), odom=np.asarray(p, float),
                    cloud=np.asarray(c, np.float32), images={"front": b"jpeg %d" % i})
           for i, (s, p, c) in enumerate(zip(m["stamps"], m["poses"], m["clouds"]))]
    out = os.path.join(os.path.dirname(map_dir), "colmap")
    export_colmap(out, kfs, K, T_cl, (640, 480), map_points=np.concatenate(m["clouds"])[:1000])
    lines = [ln.split() for ln in open(os.path.join(out, "images.txt"))
             if ln.strip() and not ln.startswith("#")]
    images = sorted(os.listdir(os.path.join(out, "images")))
    pose_err = 0.0
    for kf, ln in zip(kfs, lines):
        T_cw = np.eye(4)
        T_cw[:3, :3] = np_so3.quat_to_matrix(np.asarray(ln[1:5], float))
        T_cw[:3, 3] = np.asarray(ln[5:8], float)
        want = np.linalg.inv(kf.pose @ np.linalg.inv(T_cl))
        pose_err = max(pose_err, float(np.abs(T_cw - want).max()))
    report["colmap"] = dict(images=len(images), image_lines=len(lines), pose_max_err=pose_err)
    if not (len(images) == len(lines) == len(kfs) and pose_err < 1e-5):
        fail(f"scoring (calibration): export_colmap wrote {len(images)} images and {len(lines)} "
             f"poses for {len(kfs)} keyframes, largest pose error {pose_err}")
    clear_interfaces()
    return report


def run_scoring(dev, card, mot_frames, root):
    """Phase 12: the reference's scoring path on the port, each part with the
    launch counts from 0, its files under ``root``.  Returns the report and
    what phase 15 reads of 12b: its map, the recording of its drive and the
    localizer's poses by stamp in the drive with the side LIO."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    t_phase = time.perf_counter()
    report = dict(card=card, bars=dict(
        evaluate_ate_m=EVAL_ATE_BARS, evaluate_launches_per_scan=4,
        loc_eval=dict(min_keyframes=LOC_EVAL_MIN_KEYFRAMES, min_loops=1,
                      min_tracking_fraction=LOC_EVAL_TRACKING, rmse_m=LOC_EVAL_RMSE_M,
                      heading_deg=LOC_EVAL_HEADING_DEG, side_lio_jax=JAX_LOC_EVAL_FUSION,
                      side_lio_margin=LOC_EVAL_FUSION_MARGIN, launches_per_scan=3),
        eval_detection=dict(jax_mean_ap_wod=JAX_DET_MEAN_AP_WOD, margin=DET_EVAL_MARGIN),
        calibration=dict(mount=CALIB_MOUNT, angle_deg=CALIB_ANGLE_DEG, height_m=CALIB_HEIGHT_M,
                         lidar_ins_heading_deg=LIDAR_INS_DEG, lidar_ins_m=LIDAR_INS_M,
                         colmap_pose=1e-5)))
    p2p_reduce.launches.reset()
    t0 = time.perf_counter()
    report["evaluate"] = dict(rows=run_scoring_evaluate(dev), phase_s=time.perf_counter() - t0)
    report["launches_evaluate"] = p2p_reduce.launches.read()
    log(f"scoring (evaluate), {N_EVAL_SCANS} scans of {CAP} points a row on {card}: "
        + "; ".join(f"{r['scenario']} ATE {r['tpu_ate_m']} m, {r['tpu_ms']} ms/scan, degen "
                    f"{r['max_degen_dirs']}, weak {r['max_weak_dirs']}, {r['launches']} launches"
                    for r in report["evaluate"]["rows"]))
    os.makedirs(root, exist_ok=True)
    p2p_reduce.launches.reset()
    loc, map_dir, map_root, fusion_poses = run_scoring_loc_eval(dev, root)
    report["loc_eval"] = loc
    report["launches_loc_eval_map"] = loc["map"]["launches"]
    report["launches_loc_eval_loc"] = loc["loc"]["launches"]
    log(f"scoring (loc_eval): map {loc['map']}; localisation {loc['loc']}; without the side "
        f"LIO {loc['loc_no_fusion']}")
    p2p_reduce.launches.reset()
    report["eval_detection"] = run_scoring_detection(dev, mot_frames)
    report["launches_eval_detection"] = p2p_reduce.launches.read()
    log(f"scoring (eval_detection): {report['eval_detection']}")
    p2p_reduce.launches.reset()
    report["calibration"] = run_scoring_calibration(map_dir, map_root)
    report["launches_calibration"] = p2p_reduce.launches.read()
    log(f"scoring (calibration): {report['calibration']}")
    for key in ("launches_eval_detection", "launches_calibration"):
        if report[key] != 0:
            fail(f"scoring: p2p_reduce launched {report[key]} times in {key[9:]}")
    report["phase_s"] = time.perf_counter() - t_phase
    return report, dict(map_dir=map_dir, loc_rec=os.path.join(root, "loc", "rec"),
                        fusion_poses=fusion_poses)


def rehearse_scoring():
    """Phase 12 on the host's CPU at full size, to check its control flow and
    bars before a card run (nothing of the card is timed; the CPU launches no
    kernel, so the launch counts are reported, not judged; the drive for
    ``evaluate_mot`` is a made-up one, phase 8 not being run):

        python3 -c "import chip_smoke; chip_smoke.rehearse_scoring()"

    ~6 min on 4 cores."""
    import torch
    g = globals()
    strict = g["fail"]

    def lenient(msg):
        if "p2p_reduce launched" not in msg:
            strict(msg)
        log("rehearsal, not judged: " + msg)
    rng = np.random.default_rng(0)
    gt = np.concatenate([rng.uniform(-30, 30, (6, 2)), np.zeros((6, 1)), np.full((6, 3), 2.0),
                         np.zeros((6, 1))], axis=1)
    frames = [dict(gt_ids=np.arange(6), gt_boxes=gt - [k, 0, 0, 0, 0, 0, 0],
                   track_ids=np.arange(6), boxes=gt - [k - 0.1, 0, 0, 0, 0, 0, 0],
                   scores=rng.random(6)) for k in range(20)]
    g["fail"] = lenient
    try:
        with tempfile.TemporaryDirectory() as root:
            report, _ = run_scoring(torch.device("cpu"), "CPU rehearsal", frames, root)
    finally:
        g["fail"] = strict
    print(json.dumps({"scoring": report}))
    return report


# ---------------------------------------------------------------------------
# phase 13: the online system


def free_ports(n):
    """``n`` loopback UDP port numbers that nothing holds now."""
    held = free_udp_sockets(n)
    ports = [s.getsockname()[1] for s in held]
    for s in held:
        s.close()
    return ports


def custom_datagram(points, stamp_us):
    """One datagram of the reference's ``Custom`` LiDAR format
    (``native/src/lsd_native.cpp:757-759``): little-endian magic ``LDSL``,
    the point count, the stamp in microseconds, then x, y, z, intensity as
    float32."""
    import struct
    pts = np.ascontiguousarray(points, np.float32)
    return struct.pack("<IIQ", 0x4C53444C, len(pts), int(stamp_us)) + pts.tobytes()


def online_drive():
    """The online phase's world and truth: phase 4's ``CircleSim`` (the 8 m
    ring at 0.8 rad/s, seed 21) over ONLINE_SCANS scans of CAP points."""
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=ONLINE_SCANS, points_per_scan=CAP,
                              point_noise=0.01, seed=21))
    return sim, sim.generate(capacity=CAP, imu_capacity=16)


def online_traffic(sim, data, unix_us0):
    """What the sensors send, as (seconds from the start, kind, payload)
    in the order of sending: each scan's points (intensity 0) in Custom
    datagrams of at most ONLINE_DATAGRAM_POINTS points at k / 10 s, and a
    GPCHC sentence at ONLINE_INS_HZ from the truth (an RTK-fixed fix as
    ``tools/recording.py:truth_fix`` makes it, the IMU sample of the same
    instant in deg/s and g), stamped in GPS time as an INS stamps it.  Also
    returns each scan's points."""
    from lsd_tpu_torch.io.gpchc import format_gpchc
    from lsd_tpu_torch.tools.recording import fix_projector, truth_fix
    events, scans = [], []
    for k, scan in enumerate(data):
        P, M = scan[0], scan[2]
        pts = np.zeros((int(M.sum()), 4), np.float32)
        pts[:, :3] = P[M]
        scans.append(pts)
        for a in range(0, len(pts), ONLINE_DATAGRAM_POINTS):
            events.append((k / 10.0, "lidar",
                           custom_datagram(pts[a:a + ONLINE_DATAGRAM_POINTS], k * 100_000)))
    proj, p0 = fix_projector(), sim.pose(0.0)[1]
    for j in range(int(len(data) / 10.0 * ONLINE_INS_HZ)):
        t = j / ONLINE_INS_HZ
        fix = truth_fix(sim, t, unix_us0 + int(round(t * 1e6)), proj, p0)
        imu = sim.imu_sample(t)
        fix.update(zip(("gyro_x", "gyro_y", "gyro_z"), np.degrees(imu[1:4])))
        fix.update(zip(("acc_x", "acc_y", "acc_z"), imu[4:7]))
        events.append((t, "ins", format_gpchc(fix).encode()))
    events.sort(key=lambda e: e[0])
    return events, scans


def send_traffic(events, ports, t0, sent, stop):
    """Send ``events`` to the loopback at their times from ``t0`` (host
    clock, ``time.perf_counter``); counts what was sent by kind."""
    import socket
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for t, kind, payload in events:
            if stop.is_set():
                return
            wait = t0 + t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            tx.sendto(payload, ("127.0.0.1", ports[kind]))
            sent[kind] += 1
    finally:
        tx.close()


def online_config(lidar_port, ins_port, udp_port, out_dir):
    """The online system's config: one Custom LiDAR, GPCHC over UDP, the
    default pipeline's SLAM stage in mapping mode at phase 10's settings,
    the UDP sink and the recorder on."""
    from lsd_tpu_torch.runtime.config import DEFAULT_CONFIG
    import copy
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["input"] = dict(mode="online", scan_hz=10.0, data_path="")
    cfg["pipeline"] = [["Source", "SLAM", "Sink"]]
    cfg["lidar"] = [dict(name="0-Custom", decoder="Custom", port=lidar_port)]
    cfg["ins"].update(use=True, port=ins_port)
    cfg["slam"].update(mode="mapping", resolution=0.4, key_frames_interval=[1.5, 0.3])
    cfg["output"]["protocol"]["UDP"].update(use=True, dest="127.0.0.1", port=udp_port)
    cfg["system"]["record"].update(use=True, path=out_dir)
    return cfg


def write_config(cfg, path):
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def http(base, path, body=None):
    """GET (``body`` None) or POST a JSON body; returns the response bytes."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        if r.status != 200:
            fail(f"online: {path} answered {r.status}")
        return r.read()


def framing(frames, scans):
    """How the captured frames cut the sent scans: every point in order and
    bit-equal (each scan passed through the same range gate the source
    applies, ``points_postprocess`` at the reference's 0.5-150 m); per frame
    the scans it holds points of; the counts of frames that hold exactly one
    whole scan, of frames that end inside a scan (a split) and of frames
    that hold points of more than one scan."""
    from lsd_tpu_torch import native
    want = [native.points_postprocess(s, range_min=0.5, range_max=150.0) for s in scans]
    got = [f["points"]["0-Custom"] for f in frames]
    a, b = np.concatenate(got), np.concatenate(want)
    if a.shape != b.shape or a.tobytes() != b.tobytes():
        fail(f"online: the frames hold {a.shape[0]} points, the scans sent {b.shape[0]} after "
             f"the range gate; not the same points bit for bit")
    ends = np.cumsum([len(w) for w in want])
    held, start = [], 0
    for g in got:
        first = int(np.searchsorted(ends, start, side="right"))
        last = int(np.searchsorted(ends, start + len(g) - 1, side="right"))
        held.append((first, last))
        start += len(g)
    bounds = {0, *ends.tolist()}
    starts = np.cumsum([0] + [len(g) for g in got])
    whole = sum(1 for (f, l), s0, s1 in zip(held, starts[:-1], starts[1:])
                if f == l and s0 in bounds and s1 in bounds)
    split = sum(1 for s1 in starts[1:] if s1 not in bounds)
    merged = sum(1 for f, l in held if l > f)
    return held, dict(frames=len(got), whole=whole, ending_inside_a_scan=split,
                      holding_several_scans=merged, points=int(a.shape[0]))


def online_odometry(eng, done):
    """Stamp -> the LIO's own pose (before the graph's map correction, which
    the graph worker's timing decides) of each scan the engine completed."""
    return {stamp: np.asarray(out["odom"]) for (stamp, _), out in
            zip(eng.odometry, done.results)}


def replay_online(dev, rec_dir, out_dir, nav0):
    """The frames that the online SLAM stage processed, from its sink's
    recording, replayed offline through ``Perception`` on ``dev`` with the
    same SLAM config and seed: stamp -> the LIO's pose."""
    from lsd_tpu_torch.slam.lio import lio_init

    def edit(cfg):
        cfg["slam"].update(mode="mapping", resolution=0.4, key_frames_interval=[1.5, 0.3])
    p = pipeline_perception(dev, rec_dir, out_dir, [["Source", "SLAM", "Sink"]], edit)
    eng = p.module_manager.modules["SLAM"].engine
    eng.lio_state = lio_init(eng.cfg.lio, nav0)
    done = Stamps(eng, "_complete_scan", keep=True)
    n = len(recorded_frames(os.path.dirname(rec_dir)))
    try:
        drive_pipeline("online replay", p, lambda: len(eng.odometry), n)
        eng.flush()
        out = online_odometry(eng, done)
    finally:
        done.restore()
        p.release()
    return out


def run_cli(dev, root):
    """``python -m lsd_tpu_torch run --config <yaml> --port 0`` in a
    subprocess, on the online config with fresh ports and no traffic: it
    prints its port, answers ``/v1/status`` and exits 0 on SIGINT."""
    import select
    import signal
    cfg = online_config(*free_ports(3), os.path.join(root, "cli_out"))
    path = write_config(cfg, os.path.join(root, "cli.yaml"))
    cmd = [sys.executable, "-m", "lsd_tpu_torch", "run", "--config", path, "--host", "127.0.0.1",
           "--port", "0"] + (["--device", "cpu"] if dev.type == "cpu" else [])
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        while "serving on" not in line:
            if proc.poll() is not None:
                fail(f"online: the run command exited {proc.returncode} before serving: "
                     f"{proc.stderr.read()[-3000:]}")
            if time.perf_counter() - t0 > ONLINE_CLI_TIMEOUT_S:
                fail("online: the run command printed no port in time")
            if select.select([proc.stdout], [], [], 1.0)[0]:
                line = proc.stdout.readline()
        port = int(line.strip().rsplit(":", 1)[1])
        status = json.loads(http(f"http://127.0.0.1:{port}", "/v1/status", {}))
        up_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGINT)
        err = proc.communicate(timeout=60)[1]
        rc = proc.returncode
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if status.get("status") != "Running" or set(status["modules"]) != {"Source", "SLAM", "Sink"}:
        fail(f"online: the run command's /v1/status answered {status}")
    if rc != 0:
        fail(f"online: the run command exited {rc} on SIGINT: {err[-3000:]}")
    return dict(line=line.strip(), status=status["status"], seconds_to_status=up_s, exit_code=rc)


def warm_online_slam(dev, data, root):
    """One ``SlamModule`` at the online config on ``dev`` over two LiDAR-only
    frames, then discarded: the first use of the kernel, the libraries and
    the allocator on this device (17 s on the card when phase 13 runs
    alone) happens before the traffic starts, as a vehicle's system warms up
    before it drives."""
    from lsd_tpu_torch.runtime import clear_interfaces
    from lsd_tpu_torch.runtime.config import AttrDict
    from lsd_tpu_torch.runtime.modules import SlamModule
    from lsd_tpu_torch.tools.recording import points_frame_dict
    t0 = time.perf_counter()
    cfg = AttrDict(online_config(0, 0, 0, os.path.join(root, "warm_out")))
    m = SlamModule(cfg, device=dev)
    m.setup(cfg)
    for k in range(2):
        pts = np.concatenate([data[k][0], np.zeros((len(data[k][0]), 1), np.float32)], axis=1)
        m.process(points_frame_dict(pts, data[k][2], 1_000 + k * 100_000))
    m.engine.finish_pending()
    m.release()
    clear_interfaces()
    return time.perf_counter() - t0


def run_online(dev, card, keep_dir=None):
    """Phase 13: the online system, in this process through ``run``'s code
    (``lsd_tpu_torch.__main__.start_system``), fed live UDP traffic; then
    its recording replayed offline, and the CLI in a subprocess.  With
    ``keep_dir`` the sink records there and the truth of each integrated
    frame is saved beside it (``truth.npz``), for a replay through both
    packages (``python -m tests.test_torch_online_sources <keep_dir>``)."""
    import torch
    deterministic = torch.are_deterministic_algorithms_enabled()
    # the online run and its offline replay with torch's deterministic
    # algorithms: with the default ones the float atomics of the scatters
    # order the sums differently in each run, and the replay drifted 1.5e-3 m
    # from the online run over 150 frames (PERF.md §6)
    torch.use_deterministic_algorithms(True)
    try:
        return online_phase(dev, card, keep_dir)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def online_phase(dev, card, keep_dir):
    """``run_online``'s body."""
    import torch
    from lsd_tpu_torch.__main__ import start_system, stop_system
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.lio import lio_init
    from lsd_tpu_torch.tools.profile_lio import nav_at_start

    t_phase = time.perf_counter()
    sim, data = online_drive()
    unix_us0 = int(time.time() * 1e6)
    events, scans = online_traffic(sim, data, unix_us0)
    sent_n = {k: sum(1 for e in events if e[1] == k) for k in ("lidar", "ins")}
    log(f"online: {len(scans)} scans, {sent_n['lidar']} datagrams, {sent_n['ins']} GPCHC "
        f"sentences made in {time.perf_counter() - t_phase:.1f} s")
    nav0 = nav_at_start(sim, dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = keep_dir or tmp
        out_dir = os.path.join(root, "online_out")
        ports = dict(zip(("lidar", "ins", "udp"), free_ports(3)))
        cfg_path = write_config(online_config(ports["lidar"], ports["ins"], ports["udp"], out_dir),
                                os.path.join(root, "online.yaml"))
        warm_s = warm_online_slam(dev, data, root)
        from lsd_tpu_torch.runtime import clear_interfaces
        clear_interfaces()
        p, srv, upgrade, web_port = start_system(cfg_path, host="127.0.0.1", port=0, device=dev)
        base = f"http://127.0.0.1:{web_port}"
        mm = p.module_manager
        src, slam, sink = mm.modules["Source"], mm.modules["SLAM"], mm.modules["Sink"]
        eng = slam.engine
        recv = captured = done = stage = None
        stop = threading.Event()
        try:
            if src.lidar is None or src.ins is None or src.ins.port != ports["ins"]:
                fail("online: SourceManager built no LiDAR or no INS source")
            # the simulator's start, as phase 10 and the reference's replay test seed it
            eng.lio_state = lio_init(eng.cfg.lio, nav0)
            http(base, "/v1/message-meta")                 # the message server subscribes
            recv = subprocess.Popen(
                [sys.executable, "-m", "lsd_tpu_torch.tools.recv", "detection", "--host",
                 "127.0.0.1", "--port", str(ports["udp"]), "--max-frames",
                 str(ONLINE_RECV_FRAMES)], cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            captured = Stamps(src, "get_data", keep=True)
            done = Stamps(eng, "_complete_scan", keep=True)
            stage = Stamps(slam, "process")
            time.sleep(1.0)                                 # recv binds its socket
            p2p_reduce.launches.reset()
            sent = dict(lidar=0, ins=0)
            t0 = time.perf_counter() + 0.05
            sender = threading.Thread(target=send_traffic, name="OnlineSender",
                                      args=(events, ports, t0, sent, stop), daemon=True)
            sender.start()
            time.sleep(len(scans) / 20.0)
            mid = json.loads(http(base, "/v1/status", {}))
            sender.join(len(scans) / 10.0 + 60)
            t_sent = time.perf_counter() - t0
            if sender.is_alive() or sent != sent_n:
                fail(f"online: the sender sent {sent} of {sent_n}")
            # the last scan's frame, then the SLAM stage's queue
            time.sleep(0.5)
            deadline = time.perf_counter() + 120
            while not (slam.queue.empty() and len(stage.times) == src.frames - slam.drops):
                if time.perf_counter() > deadline:
                    fail(f"online: the SLAM stage did not drain: {p.get_status()}")
                time.sleep(0.05)
            eng.finish_pending()
            eng.flush()
            launches = p2p_reduce.launches.read()
            status = json.loads(http(base, "/v1/status", {}))
            rpc = json.loads(http(base, "/api", {"method": "slam.get_pose", "id": 3}))
            meta = json.loads(http(base, "/v1/message-meta"))
            index = http(base, "/")
            received, ring_dropped = src.lidar.units[0].rx.stats()
            ins_fixes = src.ins.last_fix is not None
        finally:
            stop.set()
            for wrapper in (captured, done, stage):
                if wrapper is not None:
                    wrapper.restore()
            stop_system(p, srv, upgrade)
            recv_out = ""
            if recv is not None:
                try:
                    recv_out = recv.communicate(timeout=30)[0]
                except subprocess.TimeoutExpired:
                    recv.kill()
                    recv_out = recv.communicate()[0]
        frames = [f for f in captured.results if f]
        www = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lsd_tpu_torch", "web",
                           "www", "index.html")
        with open(www, "rb") as f:
            if index != f.read():
                fail("online: / does not serve the package's index.html byte for byte")
        if received != sent_n["lidar"] or ring_dropped != 0:
            fail(f"online: the receiver counted {received} datagrams of {sent_n['lidar']} sent, "
                 f"its ring dropped {ring_dropped}")
        held, cut = framing(frames, scans)
        integrated = len(eng.odometry)
        if integrated < ONLINE_MIN_INTEGRATED:
            fail(f"online: the SLAM stage integrated {integrated} frames, fewer than "
                 f"{ONLINE_MIN_INTEGRATED}")
        if launches != eng.cfg.lio.max_iters * integrated:
            fail(f"online: p2p_reduce launched {launches} times for {integrated} integrated "
                 f"frames, expected max_iters x frames = {eng.cfg.lio.max_iters * integrated}")
        if mid.get("status") != "Running" or status.get("status") != "Running" or \
                status["modules"]["Source"]["frames"] != len(frames) or \
                status["modules"]["SLAM"]["frames"] != len(stage.times):
            fail(f"online: /v1/status answered {mid} mid-drive and {status} after it")
        if not np.array_equal(np.asarray(rpc.get("result"), float), slam.last_pose):
            fail(f"online: JSON-RPC slam.get_pose answered {rpc}, the module holds "
                 f"{slam.last_pose.tolist()}")
        if meta.get("slam.odometry") != "Odometry":
            fail(f"online: /v1/message-meta lists {meta}")
        if not ins_fixes or not all(f["ins_valid"] for f in frames[-10:]):
            fail("online: the INS source parsed no fix, or the last frames carry none")
        lines = [ln for ln in recv_out.splitlines() if ln.startswith("ts=")]
        stamps = {f["frame_timestamp_monotonic"] for f in frames}
        if len(lines) != ONLINE_RECV_FRAMES or \
                not all(int(ln.split()[0][3:]) in stamps for ln in lines):
            fail(f"online: tools/recv.py decoded {len(lines)} UDP sink frames of "
                 f"{ONLINE_RECV_FRAMES}: {recv_out[-2000:]}")
        # the truth of each integrated frame: the end of the last scan it holds
        index_of = {f["frame_start_timestamp"]: j for j, f in enumerate(frames)}
        odom = online_odometry(eng, done)
        pose = dict(eng.odometry)
        truth = {s: data[held[index_of[s]][1]][5] for s in odom}
        lio_init_pose = np.eye(4)
        lio_init_pose[:3, 3] = sim.pose(0.0)[1]
        err = lambda poses: float(np.sqrt(np.mean(
            [np.sum((poses[s][:3, 3] - truth[s][:3, 3]) ** 2) for s in odom])))
        rmse_odom, rmse_pose = err(odom), err(pose)
        rmse_held = err({s: lio_init_pose for s in odom})
        if not all(np.isfinite(T).all() for T in odom.values()):
            fail("online: a pose of the SLAM stage is not finite")
        if not rmse_odom < ONLINE_RMSE_BAR_M:
            fail(f"online: the LIO's RMSE against the truth is {rmse_odom} m, not below "
                 f"{ONLINE_RMSE_BAR_M} m")
        if keep_dir:
            stamps_int = sorted(odom)
            np.savez(os.path.join(keep_dir, "truth.npz"), stamps=np.asarray(stamps_int),
                     truth=np.stack([truth[s] for s in stamps_int]),
                     odom=np.stack([odom[s] for s in stamps_int]),
                     R0=sim.pose(0.0)[0], p0=sim.pose(0.0)[1], v0=sim.velocity(0.0))
        t_replay = time.perf_counter()
        rec_dirs = sorted(os.listdir(out_dir))
        replay = replay_online(dev, os.path.join(out_dir, rec_dirs[0]),
                               os.path.join(root, "replay_out"), nav0)
        t_replay = time.perf_counter() - t_replay
        if sorted(replay) != sorted(odom):
            fail(f"online: the replay integrated {len(replay)} frames, the online run {len(odom)}")
        replay_err = max(float(np.linalg.norm(replay[s][:3, 3] - odom[s][:3, 3])) for s in odom)
        if not replay_err <= ONLINE_REPLAY_ATOL_M:
            fail(f"online: the offline replay's poses lie up to {replay_err} m from the online "
                 f"run's (bar {ONLINE_REPLAY_ATOL_M} m)")
        cli = run_cli(dev, root)
    drops = status["modules"]["SLAM"]["drops"]
    imu_rows = [len(np.asarray(f.get("imu_data", np.zeros((0, 7))))) for f in frames]
    report = dict(
        card=card, scans_sent=len(scans), points_per_scan=CAP, datagrams_sent=sent_n["lidar"],
        gpchc_sent=sent_n["ins"], seconds_sending=t_sent, warm_up_s=warm_s,
        datagrams_received=received, ring_dropped=ring_dropped,
        packets_per_s=received / t_sent, frames_captured=len(frames),
        frames_per_s=len(frames) / t_sent, framing=cut,
        slam_frames_in=len(stage.times), slam_drops=drops,
        drop_share=drops / max(len(frames), 1), frames_integrated=integrated,
        slam_ms_per_frame_median=float(np.median(stage.ms)),
        slam_ms_per_frame_mean=float(np.mean(stage.ms)), p2p_launches=launches,
        imu_rows_per_frame=dict(min=min(imu_rows), max=max(imu_rows),
                                mean=float(np.mean(imu_rows))),
        rmse_lio_m=rmse_odom, rmse_published_m=rmse_pose, rmse_bar_m=ONLINE_RMSE_BAR_M,
        rmse_if_held_at_seed_m=rmse_held,
        keyframes=len(eng.store), loops=len(eng.loops),
        replay_max_err_m=replay_err, replay_bar_m=ONLINE_REPLAY_ATOL_M, replay_s=t_replay,
        recv_frames=len(lines), http=dict(status=status["status"], message_meta=meta,
                                          index_html_bytes=len(index)),
        cli=cli, phase_s=time.perf_counter() - t_phase)
    if dev.type == "cuda":
        report["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"online on {card}: {report}")
    return report


def rehearse_online(keep_dir=None):
    """Phase 13 on the host's CPU at full size, to check its control flow and
    bars before a card run (the CPU launches no kernel, so the launch count is
    reported, not judged; the SLAM stage integrates fewer frames here, so the
    count bar is reported too):

        python3 -c "import chip_smoke; chip_smoke.rehearse_online('<dir>')"

    With a directory, the sink's recording and the truth stay there for
    ``python -m tests.test_torch_online_sources <dir>``, which replays the
    frames through both packages' SLAM stage on the CPU."""
    import torch
    g = globals()
    strict = g["fail"]

    def lenient(msg):
        if "p2p_reduce launched" not in msg and \
                not msg.startswith("online: the SLAM stage integrated"):
            strict(msg)
        log("rehearsal, not judged: " + msg)
    g["fail"] = lenient
    try:
        if keep_dir:
            os.makedirs(keep_dir, exist_ok=True)
        report = run_online(torch.device("cpu"), "CPU rehearsal", keep_dir)
    finally:
        g["fail"] = strict
    print(json.dumps({"online": report}))
    return report


# ---------------------------------------------------------------------------
# phase 14: multi-device code


def deterministic(on=True):
    """Turn torch's deterministic algorithms on or off; returns the old setting."""
    import torch
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on)
    return was


def run_sharded_map_world1(mesh, card, cfg, nav0, scans, gt):
    """Phase 14a: the map-sharded step at world size 1 against ``lio_step``
    on the same scans.  Returns (report, lio_step's state, the p2p kernel's
    max error on this path's inputs)."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.parallel import make_sharded_lio_step, sharded_lio_init
    from lsd_tpu_torch.slam.lio import lio_init, lio_step
    from lsd_tpu_torch.utils.metrics import ate_rmse

    cfg = cfg._replace(research_thresh=0.0)
    step = make_sharded_lio_step(cfg, mesh)
    runs = {}
    for name in ("sharded", "lio_step"):
        st = sharded_lio_init(cfg, mesh, nav0) if name == "sharded" else lio_init(cfg, nav0)
        poses, prev = [], None
        p2p_reduce.launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for scan in scans:
            prev = st
            if name == "sharded":
                st, pose = step(st, *scan)
            else:
                st, info = lio_step(cfg, st, *scan)
                pose = info["pose"]
            poses.append(pose)
        torch.cuda.synchronize()
        runs[name] = dict(ms=(time.perf_counter() - t0) / len(scans) * 1e3,
                          launches=p2p_reduce.launches.read(), st=st, prev=prev,
                          poses=torch.stack(poses).cpu().numpy().astype(float))
    sh, one = runs["sharded"], runs["lio_step"]
    if sh["launches"] != cfg.max_iters * len(scans):
        fail(f"multi-device (a): p2p_reduce launched {sh['launches']} times over {len(scans)} "
             f"scans of the sharded step, expected max_iters x scans")
    gaps = np.linalg.norm(sh["poses"][:, :3, 3] - one["poses"][:, :3, 3], axis=1)
    ate = ate_rmse(sh["poses"], gt[:len(scans)], warmup=0)
    if not gaps.max() <= MD_POS_ATOL_M:
        fail(f"multi-device (a): the sharded step lies {gaps.max():.3e} m from lio_step "
             f"(bar {MD_POS_ATOL_M}), per scan {gaps.tolist()}")
    if not (ate < ATE_LIMIT_M and np.isfinite(sh["poses"]).all()):
        fail(f"multi-device (a): ATE {ate} m of the sharded step is not below {ATE_LIMIT_M} m")
    # the kernel against its plain version on this path's first-iteration
    # inputs (world size 1: the whole point range, planes from the summed
    # moments, which are the whole map's)
    max_err = compare_p2p(p2p_inputs(cfg, sh["prev"], scans[-1]), cfg.max_resid)
    report = dict(card=card, world_size=mesh.size, backend="nccl", scans=len(scans),
                  points_per_scan=CAP, ds_capacity=cfg.ds_capacity,
                  map_capacity=cfg.map_capacity, ms_per_scan_sharded=sh["ms"],
                  ms_per_scan_lio_step=one["ms"], max_pos_gap_m=float(gaps.max()),
                  ate_m=float(ate), p2p_launches=sh["launches"], p2p_max_abs_err=max_err,
                  deterministic_algorithms=True)
    log(f"multi-device (a), make_sharded_lio_step at world size 1 (NCCL) over {len(scans)} "
        f"scans of {CAP} points on {card}: {sh['ms']:.2f} ms/scan against lio_step's "
        f"{one['ms']:.2f}, largest position gap {gaps.max():.3e} m, ATE {ate:.5f} m, "
        f"p2p_reduce launches {sh['launches']}, kernel against plain {max_err:.3e}")
    return report, one["st"]


def check_sharded_update(mesh, cfg, st, scan):
    """Phase 14b: ``sharded_lio_update`` on one scan against ``lio_step``."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.parallel import sharded_lio_update
    from lsd_tpu_torch.slam.lio import lio_step, scan_front
    front = scan_front(cfg, st, *scan)
    p2p_reduce.launches.reset()
    nav = sharded_lio_update(cfg, mesh, front.nav_prop, front.P_prop, st.map, front.ds_pts,
                             front.ds_mask)
    launches = p2p_reduce.launches.read()
    st2, _ = lio_step(cfg, st, *scan)
    dp = float((nav.pos - st2.nav.pos).norm())
    dq = abs(float(nav.quat @ st2.nav.quat))
    moved = float((nav.pos - front.nav_prop.pos).norm())
    report = dict(pos_gap_m=dp, quat_dot=dq, moved_m=moved, p2p_launches=launches)
    log(f"multi-device (b), sharded_lio_update at world size 1 against lio_step: {report}")
    if not (dp < 5e-3 and dq > 1 - 1e-5):
        fail(f"multi-device (b): sharded_lio_update is {dp} m and |q.q'| {dq} from lio_step")
    if launches != cfg.max_iters:
        fail(f"multi-device (b): p2p_reduce launched {launches} times, expected {cfg.max_iters}")
    return report


def graph_from_map(map_dir, dev, seed=0):
    """Phase 4's saved graph (nodes, odometry and loop edges), each free
    pose perturbed by seeded noise (2 cm, 0.3 deg) so the solvers have work."""
    from lsd_tpu_torch.geometry import np_so3
    from lsd_tpu_torch.slam.graph_builder import PoseGraphBuilder
    from lsd_tpu_torch.slam.map_io import load_map
    d = load_map(map_dir)
    rng = np.random.default_rng(seed)
    b = PoseGraphBuilder()
    fixed = set(d["fixed"]) or {0}
    for k, T in enumerate(d["poses"]):
        T = np.asarray(T, float).copy()
        if k not in fixed:
            T[:3, :3] = T[:3, :3] @ np_so3.exp_so3(rng.normal(0, np.radians(0.3), 3))
            T[:3, 3] += rng.normal(0, 0.02, 3)
        b.add_node(T, fixed=k in fixed)
    for i, j, T, info in d["edges"]:
        info = np.asarray(info, float)
        b.add_se3_edge(i, j, np.asarray(T, float), rot_info=info[:3], trans_info=info[3:6])
    return b.to_data(device=dev), len(d["poses"]), len(d["edges"])


def check_sharded_pgo(mesh, map_dir):
    """Phase 14c: the sharded and Schur solvers against ``optimize``."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.parallel import optimize_schur, optimize_sharded
    from lsd_tpu_torch.slam.posegraph import PgoConfig, optimize
    graph, n_nodes, n_edges = graph_from_map(map_dir, mesh.device)
    cfg = PgoConfig(outer_iters=6, cg_iters=120)
    p2p_reduce.launches.reset()
    out, ms, infos = {}, {}, {}

    def schur():
        g, infos["schur"] = optimize_schur(graph, mesh, cfg)
        return g
    for name, fn in (("optimize", lambda: optimize(graph, cfg)[0]),
                     ("sharded", lambda: optimize_sharded(graph, mesh, cfg)),
                     ("schur", schur)):
        fn()                                            # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out[name] = fn()
        b.record()
        b.synchronize()
        ms[name] = a.elapsed_time(b) / cfg.outer_iters
    pos = {k: g.nodes.pos[:n_nodes].cpu().numpy() for k, g in out.items()}
    start = graph.nodes.pos[:n_nodes].cpu().numpy()
    gap_sh = float(np.abs(pos["sharded"] - pos["optimize"]).max())
    gap_sc = float(np.abs(pos["schur"] - pos["optimize"]).max())
    moved = float(np.abs(pos["optimize"] - start).max())
    report = dict(nodes=n_nodes, edges=n_edges, outer_iters=cfg.outer_iters,
                  cg_iters=cfg.cg_iters, ms_per_round=ms, max_gap_sharded_m=gap_sh,
                  max_gap_schur_m=gap_sc, moved_m=moved, p2p_launches=p2p_reduce.launches.read(),
                  schur_info={k: (float(v) if torch.is_tensor(v) else v)
                              for k, v in infos["schur"].items()})
    log(f"multi-device (c), PGO on phase 4's graph ({n_nodes} nodes, {n_edges} edges) at "
        f"world size 1: ms per GN round {ms}; sharded {gap_sh:.2e} m and Schur {gap_sc:.2e} m "
        f"from optimize, which moved the nodes up to {moved:.3f} m")
    if not (gap_sh <= MD_PGO_ATOL_M and gap_sc <= MD_SCHUR_ATOL_M and moved > 1e-3):
        fail(f"multi-device (c): sharded PGO {gap_sh} m (bar {MD_PGO_ATOL_M}), Schur {gap_sc} m "
             f"(bar {MD_SCHUR_ATOL_M}) from optimize; optimize moved the nodes {moved} m")
    return report


def start_cpu_merge(map_a, map_b, out_dir, out_json):
    """``tools/campaign_merge.py`` in a subprocess on 8 gloo ranks of the CPU,
    what ``campaign.main`` runs on a one-card host; returns the process."""
    root = os.path.dirname(os.path.abspath(__file__))
    log_path = out_json + ".log"
    with open(log_path, "w") as fh:
        return subprocess.Popen([sys.executable, "-m", "lsd_tpu_torch.tools.campaign_merge",
                                 map_a, map_b, out_dir, out_json], cwd=root, stdout=fh,
                                stderr=subprocess.STDOUT), log_path


def check_merge(mesh, card, map_a, map_b, root, cpu_merge):
    """Phase 14d: the campaign's distributed merge on the card at world size
    1, then the 8-rank CPU merge against it."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.slam.map_io import load_map
    from lsd_tpu_torch.tools.campaign import merge_distributed
    card_dir = os.path.join(root, "merged_card")
    p2p_reduce.launches.reset()
    t0 = time.perf_counter()
    m = merge_distributed(mesh, map_a, map_b, card_dir, progress=log)
    wall = time.perf_counter() - t0
    rep = {k: v for k, v in m.items() if k not in ("builder", "info")}
    rep.update(wall_s=wall, p2p_launches=p2p_reduce.launches.read())
    if rep["cross_edges"] < 1 or rep["single_host_fallback"]:
        fail(f"multi-device (d): the card's merge found {rep['cross_edges']} cross edges, "
             f"single_host_fallback {rep['single_host_fallback']}")
    proc, log_path = cpu_merge
    try:
        rc = proc.wait(timeout=MD_MERGE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"multi-device (d): the 8-rank CPU merge did not end within {MD_MERGE_TIMEOUT_S} s")
    tail = open(log_path).read()[-4000:]
    if rc != 0:
        fail(f"multi-device (d): the 8-rank CPU merge exited {rc}:\n{tail}")
    with open(log_path[:-len(".log")]) as fh:
        cpu = json.load(fh)
    cpu_dir = os.path.join(root, "merged_cpu")
    a = np.stack(load_map(card_dir)["poses"])[:, :3, 3]
    b = np.stack(load_map(cpu_dir)["poses"])[:, :3, 3]
    gap = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    rep.update(cpu_merge=cpu, cpu_vs_card_max_gap_m=gap)
    log(f"multi-device (d), merge_distributed of phase 4's and phase 10a's maps on {card} "
        f"(world size 1): {rep}")
    if not (cpu["schur_devices"] == 8 and cpu["cross_edges"] == rep["cross_edges"]
            and not cpu["single_host_fallback"] and gap <= MD_MERGE_ATOL_M):
        fail(f"multi-device (d): the 8-rank CPU merge ({cpu}) against the card's: node "
             f"positions {gap} m apart (bar {MD_MERGE_ATOL_M})")
    return rep


def sharded_map_rank_on_card(mesh, cfg, scans, nav0):
    """Phase 14e's rank: the map-sharded step with its tensors on card 0,
    its collectives through gloo."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.parallel import make_sharded_lio_step, sharded_lio_init
    from lsd_tpu_torch.slam.state import NavState
    from lsd_tpu_torch.utils.precision import set_slam_precision
    set_slam_precision()
    deterministic()
    dev = torch.device("cuda", 0)
    mesh = mesh._replace(device=dev)
    nav = NavState(*[torch.as_tensor(nav0[f], device=dev) for f in NavState._fields])
    step = make_sharded_lio_step(cfg, mesh)
    st = sharded_lio_init(cfg, mesh, nav)
    poses = []
    p2p_reduce.launches.reset()
    t0 = time.perf_counter()
    for scan in scans:
        st, pose = step(st, *[torch.as_tensor(a, device=dev) for a in scan])
        poses.append(pose)
    torch.cuda.synchronize()
    return dict(poses=torch.stack(poses).cpu().numpy(), capacity=st.map.capacity,
                occupied=int((st.map.keys >= 0).sum()), launches=p2p_reduce.launches.read(),
                device=str(st.P.device), ms_per_scan=(time.perf_counter() - t0) / len(scans) * 1e3)


def check_gloo_on_card(card, cfg, nav0, scans):
    """Phase 14e: the map-sharded step on 2 gloo ranks, both on this card."""
    from lsd_tpu_torch.parallel import run_ranks
    from lsd_tpu_torch.slam.state import NavState
    cfg = cfg._replace(research_thresh=0.0)
    nav = {f: getattr(nav0, f).cpu().numpy() for f in NavState._fields}
    host = [tuple(a.cpu().numpy() for a in scan) for scan in scans]
    t0 = time.perf_counter()
    outs = run_ranks(sharded_map_rank_on_card, 2, args=(cfg, host, nav), backend="gloo",
                     init_timeout_s=MD_INIT_TIMEOUT_S, timeout_s=300)
    wall = time.perf_counter() - t0
    occ = np.asarray([o["occupied"] for o in outs])
    equal = all(np.array_equal(o["poses"], outs[0]["poses"]) for o in outs)
    rep = dict(ranks=2, backend="gloo", devices=[o["device"] for o in outs],
               capacity_per_rank=[o["capacity"] for o in outs], occupied=occ.tolist(),
               launches=[o["launches"] for o in outs],
               ms_per_scan=[o["ms_per_scan"] for o in outs], poses_bitwise_equal=equal,
               wall_s=wall, scans=len(scans))
    log(f"multi-device (e), make_sharded_lio_step on 2 gloo ranks on {card}: {rep}")
    if not equal:
        fail("multi-device (e): the two ranks' poses differ")
    # the reference's uniformity bar for the owner hash (every rank above
    # 0.8 of the mean share, tests/test_sharded_map.py), at 2 ranks 40-60 %
    if not occ.min() > 0.8 * occ.mean():
        fail(f"multi-device (e): the ranks own {occ.tolist()} of the occupied slots")
    if any(n != cfg.max_iters * len(scans) for n in rep["launches"]):
        fail(f"multi-device (e): p2p_reduce launches per rank {rep['launches']}, expected "
             f"max_iters x scans = {cfg.max_iters * len(scans)}")
    if rep["devices"] != ["cuda:0", "cuda:0"] or rep["capacity_per_rank"] != [
            cfg.map_capacity // 2] * 2:
        fail(f"multi-device (e): ranks on {rep['devices']}, capacities {rep['capacity_per_rank']}")
    return rep


def check_trainer_mesh(mesh, dev):
    """Phase 14f: ``Trainer(mesh=...)`` at world size 1 against the one-card
    ``Trainer`` of phase 11's detector setup, from the shipped checkpoint."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.training.trainer import Trainer
    setup = training_setups()["detector"]
    batch = next(setup["data"](1).batches(1))
    p2p_reduce.launches.reset()
    runs = {}
    for key in ("one", "mesh"):
        tr = setup["make"](dev, 0, 1e-3, 1, 1000, torch.float32)
        if key == "mesh":
            tr = Trainer(tr.det_cfg, tr.cfg, mesh=mesh, dtype=torch.float32)
        tr.load(setup["weights"])
        grads = {}
        step = tr.opt.step
        # the gradients the optimizer would see (after the mean over the
        # ranks), read in place of a step
        tr.opt.step = lambda: grads.update({n: p.grad.detach().clone()
                                            for n, p in tr.model.named_parameters()})
        loss, _ = tr.train_step(tr.upload(batch))
        tr.opt.step = step
        runs[key] = (tr, float(loss), grads)
    (one, l1, g1), (trm, lm, gm) = runs["one"], runs["mesh"]
    share = leaf_share(gm, {n: g.cpu() for n, g in g1.items()})
    # each trainer's update from its own gradient, per leaf by cosine and
    # relative norm gap (Adam divides a gradient of rounding noise by its
    # own RMS: such an element moves by up to lr either way, so an
    # element-wise bar would judge the noise)
    want = {n: u.cpu() for n, u in optimizer_update(one, g1).items()}
    own = leaf_cos_gap(optimizer_update(trm, gm), want)
    loss, _ = trm.train_step(trm.upload(batch))
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(p).all())
                                                 for p in trm.model.parameters())
    rep = dict(loss_one=l1, loss_mesh=lm, grad_max_share=max(share.values()),
               grad_worst_leaf=max(share, key=share.get),
               update_min_cos=min(c for c, _ in own.values()),
               update_max_gap=max(g for _, g in own.values()),
               update_worst_leaf=max(own, key=lambda n: own[n][1]),
               step_finite=finite, p2p_launches=p2p_reduce.launches.read())
    log(f"multi-device (f), Trainer(mesh) at world size 1 against the one-card Trainer: {rep}")
    if not (abs(lm - l1) <= 1e-4 * abs(l1) and rep["grad_max_share"] <= TRAIN_GRAD_RTOL
            and rep["update_min_cos"] >= MD_UPDATE_COS and rep["update_max_gap"] <= MD_UPDATE_GAP
            and finite):
        fail(f"multi-device (f): Trainer(mesh) differs from the one-card Trainer: {rep}")
    return rep


def run_multi_device(dev, card, map_a, map_b, root):
    """Phase 14: the multi-device programs (see the docstring)."""
    import torch
    from lsd_tpu_torch.parallel import single_rank
    report = dict(card=card)
    t_phase = time.perf_counter()
    cpu_merge = start_cpu_merge(map_a, map_b, os.path.join(root, "merged_cpu"),
                                os.path.join(root, "merge_cpu.json"))
    try:
        cfg, nav0, scans, gt = make_run(dev, MD_SCANS + 1)
        with single_rank("nccl", timeout_s=MD_INIT_TIMEOUT_S) as mesh:
            was = deterministic()
            try:
                report["sharded_map"], st = run_sharded_map_world1(
                    mesh, card, cfg, nav0, scans[:MD_SCANS], gt)
                report["sharded_update"] = check_sharded_update(mesh, cfg, st, scans[MD_SCANS])
            finally:
                deterministic(was)
            report["pgo"] = check_sharded_pgo(mesh, map_a)
            report["merge"] = check_merge(mesh, card, map_a, map_b, root, cpu_merge)
            report["trainer"] = check_trainer_mesh(mesh, dev)
        report["gloo_on_card"] = check_gloo_on_card(card, cfg, nav0, scans[:MD_GLOO_SCANS])
    finally:
        if cpu_merge[0].poll() is None:
            cpu_merge[0].kill()
            cpu_merge[0].wait()
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"multi-device: phase 14 took {report['phase_s']:.1f} s")
    return report


# ---------------------------------------------------------------------------
# phase 15: the last tools of lsd_tpu/tools


def run_format_chains(dev, root):
    """15a: ``tools.eval_formats`` at full width: the simulator written as a
    rosbag and as NCLT files, converted by ``tools.rosbag`` and
    ``tools.nclt``, each replayed through ``Perception`` on ``dev``; the
    kernel held against its plain version on the inputs of one of the
    rosbag replay's calls.  Returns the report and the rosbag recording."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.sim import CircleSim, SimConfig
    from lsd_tpu_torch.slam import lio as lio_mod
    from lsd_tpu_torch.tools import eval_formats, nclt, rosbag

    sim = CircleSim(SimConfig(radius=8.0, omega=0.8, n_scans=N_FMT_SCANS, points_per_scan=CAP,
                              seed=33, point_noise=0.01, rest_time=1.5, ramp_time=1.0))
    data = sim.generate(capacity=CAP, imu_capacity=IMU_CAP)
    gts = [d[5] for d in data]
    gt_ts = [1_700_000_000 * 1_000_000 + k * 100_000 for k in range(N_FMT_SCANS)]
    t0 = time.perf_counter()
    bag = eval_formats.export_rosbag(sim, data, os.path.join(root, "seq.bag"))
    recs = dict(rosbag=rosbag.rosbag_to_pkl(bag, os.path.join(root, "rec_bag")))
    hits, ms25 = eval_formats.export_nclt(sim, data, os.path.join(root, "nclt"))
    recs["nclt"] = nclt.convert_nclt(hits, os.path.join(root, "rec_nclt"), ms25_csv=ms25)
    report = dict(scans=N_FMT_SCANS, points=CAP, write_and_convert_s=time.perf_counter() - t0,
                  bag_bytes=os.path.getsize(bag), hits_bytes=os.path.getsize(hits),
                  bars=dict(jax_ate_m=JAX_FMT_ATE, margin_m=FMT_ATE_MARGIN_M,
                            min_frames=FMT_MIN_FRAMES * N_FMT_SCANS))
    for name, rec in recs.items():
        timer = CallTimer(lio_mod, "p2p_reduce")
        p2p_reduce.launches.reset()
        try:
            r = eval_formats.replay_and_score(rec, sim, gts, gt_ts_us=gt_ts, device=dev)
        finally:
            timer.restore()
        r.update(launches=p2p_reduce.launches.read(),
                 ms_per_frame=r["busy_s"] / max(r["integrated"], 1) * 1e3)
        report[name] = r
        log(f"tools (eval_formats, {name}): {r}")
        if not abs(r["ate"] - JAX_FMT_ATE[name]) <= FMT_ATE_MARGIN_M:
            fail(f"tools (eval_formats, {name}): ATE {r['ate']} m is not within "
                 f"{FMT_ATE_MARGIN_M} m of the JAX package's {JAX_FMT_ATE[name]} m")
        if not r["frames"] >= FMT_MIN_FRAMES * N_FMT_SCANS:
            fail(f"tools (eval_formats, {name}): {r['frames']} of {N_FMT_SCANS} scans paired "
                 f"with the truth, expected at least {FMT_MIN_FRAMES:.0%}")
        if r["launches"] != 3 * r["integrated"]:
            fail(f"tools (eval_formats, {name}): p2p_reduce launched {r['launches']} times over "
                 f"{r['integrated']} integrated scans, expected max_iters (3) x scans")
        if name == "rosbag":
            args = timer.args[len(timer.args) // 2]
            report["p2p_max_abs_err"] = compare_p2p(args[:8], args[8])
    return report, recs["rosbag"]


def run_export(dev):
    """15b: ``tools.export`` of the shipped 0.2 m checkpoint at EXPORT_POINTS
    on ``dev``, loaded back and held against the eager module on a scene."""
    import torch
    from lsd_tpu_torch.convert import detector_params_from_flax
    from lsd_tpu_torch.detection.post import PostProcessConfig
    from lsd_tpu_torch.models import CenterPointDetector, DetectorConfig
    from lsd_tpu_torch.models.params_io import load_params
    from lsd_tpu_torch.runtime.modules import shipped_detector_weights
    from lsd_tpu_torch.tools import export
    from lsd_tpu_torch.tools.profile_detector import eval_scenes

    cfg = DetectorConfig.reference_capacity()
    state = detector_params_from_flax(load_params(shipped_detector_weights(cfg)))
    scene = eval_scenes(n_batches=1)[0]
    n = len(scene["points"])
    pts = np.zeros((EXPORT_POINTS, 4), np.float32)
    mask = np.zeros(EXPORT_POINTS, bool)
    pts[:n], mask[:n] = scene["points"][:, :4], scene["mask"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        path = export.export_detector(state, cfg, point_capacity=EXPORT_POINTS,
                                      out_path=os.path.join(root, "det.pt2"), device=dev)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        det = export.ExportedDetector(path)
        load_s = time.perf_counter() - t0
        artifact_bytes = os.path.getsize(path)
    model = CenterPointDetector(cfg)
    model.load_state_dict(state)
    eager = export.DetectorInference(model, PostProcessConfig()).to(dev).eval()
    p, m = torch.as_tensor(pts, device=dev), torch.as_tensor(mask, device=dev)
    with torch.no_grad():
        got, want = det(p, m), eager(p, m)
        max_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        ms = time_ms(lambda: det(p, m), n=20)
        eager_ms = time_ms(lambda: eager(p, m), n=20)
    kept = int(got[3].sum())
    report = dict(points=EXPORT_POINTS, scene_points=int(mask.sum()), export_s=export_s,
                  load_s=load_s, artifact_bytes=artifact_bytes, meta=det.meta, kept=kept,
                  max_abs_err=max_err, ms_per_call=ms, eager_ms_per_call=eager_ms)
    log(f"tools (export): {report}")
    if det.meta["device"] != "cuda" or det.device.type != "cuda":
        fail(f"tools (export): the artifact runs on {det.meta['device']}, expected the card")
    if not (max_err <= EXPORT_ATOL and torch.equal(got[3], want[3]) and kept >= 1):
        fail(f"tools (export): the artifact's outputs lie {max_err} from the eager module's "
             f"(bar {EXPORT_ATOL}), kept {kept} boxes, keep masks equal "
             f"{bool(torch.equal(got[3], want[3]))}")
    return report


def run_profile_replay(dev, rec_bag):
    """15c: ``tools.profile.profile_lio_replay`` over (a)'s rosbag recording,
    with a trace in a temporary directory."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.tools.profile import profile_lio_replay
    p2p_reduce.launches.reset()
    with tempfile.TemporaryDirectory() as trace:
        rep = profile_lio_replay(rec_bag, trace, max_frames=N_PROFILE_FRAMES, device=dev)
        rep["trace_bytes"] = os.path.getsize(os.path.join(trace, "trace.json"))
    rep["launches"] = p2p_reduce.launches.read()
    log(f"tools (profile): {rep}")
    if rep["frames"] != N_PROFILE_FRAMES or rep["launches"] != 4 * rep["frames"]:
        fail(f"tools (profile): {rep['frames']} frames, p2p_reduce launched {rep['launches']} "
             f"times; expected {N_PROFILE_FRAMES} and max_iters (4) x frames")
    return rep


def loc_diag_rmse(rec_root, poses, n):
    """RMSE x and y (m) and the scored count of the poses by stamp over the
    first ``n`` frames of the recording at ``rec_root``, scored as
    ``tools/loc_diag.py`` scores them (errors rounded to mm)."""
    z = np.load(os.path.join(rec_root, "gt.npz"))
    ex, ey = [], []
    for ts, g in list(zip(z["ts_us"], z["gt"]))[:n]:
        T = poses.get(int(ts))
        if T is not None:
            ex.append(round(float(T[0, 3] - g[0, 3]), 3))
            ey.append(round(float(T[1, 3] - g[1, 3]), 3))
    rmse = lambda e: round(float(np.sqrt(np.mean(np.square(e)))), 3) if e else None
    return rmse(ex), rmse(ey), len(ex)


def run_loc_diag(dev, scoring):
    """15d: ``tools.loc_diag`` with the side LIO over the first N_LOC_DIAG
    frames of 12b's drive, on 12b's map, against 12b's own run."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.tools import loc_diag
    p2p_reduce.launches.reset()
    was = deterministic()           # as 12b's run with the side LIO
    try:
        rows, summ = loc_diag.run(scoring["map_dir"], scoring["loc_rec"], lio_fusion=True,
                                  max_frames=N_LOC_DIAG, progress=log, device=dev)
    finally:
        deterministic(was)
    launches = p2p_reduce.launches.read()
    rx, ry, scored = loc_diag_rmse(scoring["loc_rec"], scoring["fusion_poses"], N_LOC_DIAG)
    report = dict(summary=summ, launches=launches, phase12b=dict(rmse_x=rx, rmse_y=ry,
                                                                 scored=scored))
    log(f"tools (loc_diag): {report}")
    if summ["frames"] != N_LOC_DIAG or summ["scored"] != scored:
        fail(f"tools (loc_diag): {summ['frames']} frames, {summ['scored']} scored; 12b's run "
             f"scored {scored} of the first {N_LOC_DIAG}")
    if scored and not (abs(summ["rmse_x"] - rx) <= LOC_DIAG_ATOL_M
                       and abs(summ["rmse_y"] - ry) <= LOC_DIAG_ATOL_M):
        fail(f"tools (loc_diag): RMSE x {summ['rmse_x']} m, y {summ['rmse_y']} m; 12b's own run "
             f"over the same frames {rx} m, {ry} m (bar {LOC_DIAG_ATOL_M} m)")
    if launches != 3 * N_LOC_DIAG:
        fail(f"tools (loc_diag): p2p_reduce launched {launches} times over {N_LOC_DIAG} frames, "
             f"expected the side LIO's max_iters (3) x frames")
    return report


def run_campaign_diag(dev, map_dir):
    """15e: ``tools.campaign_diag`` on 12b's map, its world's parameters, on
    the card and on the CPU."""
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.tools import campaign_diag
    kw = dict(laps=LOC_EVAL_MAP_LAPS, radius=LOC_EVAL_RADIUS, speed=5.0, points=LOC_EVAL_POINTS)
    p2p_reduce.launches.reset()
    t0 = time.perf_counter()
    card = campaign_diag.diagnose(map_dir, device=dev, **kw)
    card_s = time.perf_counter() - t0
    launches = p2p_reduce.launches.read()
    cpu = campaign_diag.diagnose(map_dir, device="cpu", **kw)
    tags = [k for k, v in cpu.items() if isinstance(v, dict) and "ate_after_m" in v]
    worst = max(abs(card[t][k] - cpu[t][k]) for t in tags for k in ("ate_before_m", "ate_after_m"))
    report = dict(card=card, cpu=cpu, worst_ate_gap_m=worst, card_s=card_s, launches=launches)
    log(f"tools (campaign_diag): {report}")
    if len(tags) != 5 or not worst <= CAMPAIGN_DIAG_ATOL_M:
        fail(f"tools (campaign_diag): {len(tags)} ablations, ATEs on the card up to {worst} m "
             f"from the CPU's (bar {CAMPAIGN_DIAG_ATOL_M} m)")
    return report


def run_tools(dev, card, scoring):
    """Phase 15: the tools of ``lsd_tpu_torch/tools`` that phases 1-14 do not
    run (see the docstring), each with the launch counts from 0."""
    import torch
    from lsd_tpu_torch.ops.p2p import p2p_reduce
    from lsd_tpu_torch.tools import bench_p2p, roofline, scaling, schur_chip_bench
    t_phase = time.perf_counter()
    report = dict(card=card, seconds={})

    def part(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        p2p_reduce.launches.reset()
        report[name] = out = fn(*args, **kwargs)
        report["launches"][name] = p2p_reduce.launches.read()
        report["seconds"][name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        report["eval_formats"], rec_bag = run_format_chains(dev, root)
        report["seconds"]["eval_formats"] = time.perf_counter() - t0
        report["launches"] = {f"eval_formats_{k}": report["eval_formats"][k]["launches"]
                              for k in ("rosbag", "nclt")}
        part("profile", run_profile_replay, dev, rec_bag)
    part("export", run_export, dev)
    part("loc_diag", run_loc_diag, dev, scoring)
    part("campaign_diag", run_campaign_diag, dev, scoring["map_dir"])
    part("roofline", roofline.report, dev, n_rep=ROOFLINE_REPS)
    log(f"tools (roofline): {report['roofline']}")
    bench = part("bench_p2p", bench_p2p.bench, scans=N_BENCH_P2P_SCANS, device=dev)
    log(f"tools (bench_p2p): {bench}")
    if not bench["lio_step"]["finite"]:
        fail(f"tools (bench_p2p): the filter state is not finite after {N_BENCH_P2P_SCANS} scans")
    if bench["lio_step"]["p2p_launches"] != 4 * N_BENCH_P2P_SCANS:
        fail(f"tools (bench_p2p): p2p_reduce launched {bench['lio_step']['p2p_launches']} times "
             f"over {N_BENCH_P2P_SCANS} scans, expected max_iters (4) x scans")
    schur = part("schur_chip_bench", schur_chip_bench.bench,
                 schur_chip_bench.build_merge_shaped_graph(1192, 432, 1173), device=dev)
    log(f"tools (schur_chip_bench): {schur}")
    sc = part("scaling", scaling.scaling_report, reps=SCALING_REPS, virtual=False, device=dev)
    log(f"tools (scaling): {sc}")
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"tools: phase 15 took {report['phase_s']:.1f} s; by part {report['seconds']}")
    return report


def rehearse_tools():
    """Phase 15 on the host's CPU at full size, to check its control flow and
    bars before a card run, after 12b's map and drive (``run_scoring_loc_eval``,
    its bars judged too).  The CPU launches no kernel, so the launch counts are reported, not judged,
    and the kernel is not compared; the export runs on the CPU, which the
    card run refuses; CUDA events, synchronizes and ``time_ms`` get
    stand-ins, and ``measure_peaks`` runs at a small size:

        python3 -c "import chip_smoke; chip_smoke.rehearse_tools()"

    ~5 min on 4 cores."""
    import torch
    from lsd_tpu_torch.tools import roofline
    g = globals()
    saved = {k: g[k] for k in ("fail", "time_ms", "compare_p2p")}

    class Event:
        def __init__(self, **kw):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    def lenient(msg):
        if "p2p_reduce launched" not in msg and "the artifact runs on cpu" not in msg:
            saved["fail"](msg)
        log("rehearsal, not judged: " + msg)

    def host_ms(fn, n=N_TIMING):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    cuda = {k: getattr(torch.cuda, k) for k in ("Event", "synchronize", "empty_cache")}
    peaks = roofline.measure_peaks
    g.update(fail=lenient, time_ms=host_ms, compare_p2p=lambda args, max_resid: 0.0)
    torch.cuda.Event, torch.cuda.synchronize = Event, lambda *a: None
    torch.cuda.empty_cache = lambda: None
    roofline.measure_peaks = lambda device=None: peaks(size_mm=256, size_copy_mb=4, inner=2,
                                                       device=device)
    dev = torch.device("cpu")
    try:
        with tempfile.TemporaryDirectory() as root:
            _, map_dir, _, poses = run_scoring_loc_eval(dev, root)
            report = run_tools(dev, "CPU rehearsal", dict(
                map_dir=map_dir, loc_rec=os.path.join(root, "loc", "rec"), fusion_poses=poses))
    finally:
        g.update(saved)
        for k, v in cuda.items():
            setattr(torch.cuda, k, v)
        roofline.measure_peaks = peaks
    print(json.dumps({"tools": report}))
    return report


def main() -> None:
    # a fatal signal prints the stack of every Python thread, the one that
    # took it marked "Current thread" (a thread without Python frames, such
    # as one of CUDA's or the profiler's, shows none of its own)
    faulthandler.enable(all_threads=True)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script runs only on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from lsd_tpu_torch.ops.p2p import p2p_reduce
        from lsd_tpu_torch.slam import lio_graph
        from lsd_tpu_torch.slam.imu import propagate
        from lsd_tpu_torch.slam.lio import _gate_degenerate, _lio_step_eager, lio_step
        from lsd_tpu_torch.utils import cuda_build
        from lsd_tpu_torch.utils.metrics import ate_rmse
        from lsd_tpu_torch.utils.precision import set_slam_precision
    except ImportError as exc:
        fail(f"the lsd_tpu_torch package is not beside this script ({exc})")

    card = card_line()
    dev = torch.device("cuda", 0)
    # phase 14 merges the maps of phases 4 and 10a, and phase 15 reads phase
    # 12b's map and drive: they are kept here
    keep = tempfile.mkdtemp(prefix="chip_smoke_")
    t_start = time.perf_counter()
    phase_s = {}

    def phase_done(name):
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, card {card}")
    set_slam_precision()

    # ---- 1. build -------------------------------------------------------
    for name in ("p2p_reduce", "imu_propagate", "lio_gate", "dsvt_set_attn"):
        t0 = time.perf_counter()
        lib = cuda_build.build(name)
        log(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")
        ptxas = lib.parent / "ptxas.log"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("ptxas: " + line.strip())

    # ---- 2. warm-up, then kernels against their plain versions ----------
    t0 = time.perf_counter()
    cfg, nav0, scans, gt = make_run(dev)
    log(f"made {len(scans)} scans of {CAP} points in {time.perf_counter() - t0:.1f} s")
    from lsd_tpu_torch.slam.lio import lio_init
    st = lio_init(cfg, nav0)
    poses = []
    for scan in scans[:N_WARM]:
        st, _ = lio_step(cfg, st, *scan)
        poses.append(st.nav.pos)
    torch.cuda.synchronize()
    p2p_report = {}
    check_p2p(p2p_inputs(cfg, st, scans[N_WARM]), cfg.max_resid, p2p_report)
    imu_report = {}
    check_imu(cfg, st, scans[N_WARM], imu_report)
    gate_report = {}
    p2p_args = p2p_inputs(cfg, st, scans[N_WARM])
    check_gate(cfg, p2p_reduce(*p2p_args, cfg.max_resid)[0], gate_report)
    dsvt_report = {}
    check_dsvt(dev, dsvt_report)
    from lsd_tpu_torch.tools.profile_lio import sync_sites
    sites = sync_sites(lambda: lio_step(cfg, st, *scans[N_WARM]))[1]
    syncs = sum(sites.values())
    log(f"host syncs in one lio_step: {syncs}; by site {sites}")

    # ---- 3. the main path ------------------------------------------------
    st_start = st
    p2p_reduce.launches.reset()
    propagate.launches.reset()
    _gate_degenerate.launches.reset()
    graph_counts = dict(lio_graph.counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in scans[N_WARM:]:
        st, info = lio_step(cfg, st, *scan)
        poses.append(st.nav.pos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    graph_counts = {k: lio_graph.counters[k] - graph_counts[k] for k in graph_counts}
    # counted where the kernels run: the replayed graphs' launches
    graph_launches = (p2p_reduce.launches.read(), propagate.launches.read(),
                      _gate_degenerate.launches.read())
    launches, imu_launches, gate_launches = graph_launches
    if launches != cfg.max_iters * N_BENCH:
        fail(f"p2p_reduce launched {launches} times over {N_BENCH} scans, "
             f"expected max_iters x scans = {cfg.max_iters * N_BENCH}")
    if imu_launches != N_BENCH:
        fail(f"imu_propagate launched {imu_launches} times over {N_BENCH} scans, "
             f"expected one a scan")
    if gate_launches != cfg.max_iters * N_BENCH:
        fail(f"lio_gate launched {gate_launches} times over {N_BENCH} scans, "
             f"expected max_iters x scans = {cfg.max_iters * N_BENCH}")
    if graph_counts["replays"] != N_BENCH or graph_counts["eager"]:
        fail(f"the LIO step's graphs: {graph_counts} over {N_BENCH} scans, expected a "
             f"replay a scan and no eager step")
    imu_report["launches"] = imu_launches
    gate_report["launches"] = gate_launches
    # the same scans from the same state through the eager body
    st_e = st_start
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scan in scans[N_WARM:]:
        st_e, info_e = _lio_step_eager(cfg, st_e, *scan)
    torch.cuda.synchronize()
    dt_eager = time.perf_counter() - t0
    gap_m = float((st_e.nav.pos - st.nav.pos).norm())
    log(f"lio_step, {N_BENCH} scans from one state: graphs {N_BENCH / dt:.2f} scans/s "
        f"({dt / N_BENCH * 1e3:.3f} ms/scan), eager body {N_BENCH / dt_eager:.2f} scans/s "
        f"({dt_eager / N_BENCH * 1e3:.3f} ms/scan), final positions "
        f"{gap_m:.2e} m apart; graph runner counters {dict(lio_graph.counters)}")
    if not gap_m < 1e-3:
        fail(f"the eager body ends {gap_m} m from the graphs over the same scans")
    del st_e, info_e
    finite = all(bool(torch.isfinite(x).all()) for x in (*st.nav, st.P))
    if not finite:
        fail("the filter state is not finite after the main path")
    est = np.tile(np.eye(4), (len(poses), 1, 1))
    est[:, :3, 3] = torch.stack(poses).cpu().numpy()
    # warm-up 22 of the timed scans, as bench.py scores its trajectory
    ate = ate_rmse(est[N_WARM:], gt[N_WARM:], warmup=22)
    if not ate < ATE_LIMIT_M:
        fail(f"ATE {ate} m is not below {ATE_LIMIT_M} m")
    log(f"lio_step, {N_BENCH} scans of {CAP} points on {card}: "
        f"{N_BENCH / dt:.2f} scans/s, {dt / N_BENCH * 1e3:.3f} ms/scan, "
        f"ATE {ate:.5f} m, num_valid {int(info['num_valid'])}, launches (p2p_reduce, "
        f"imu_propagate, lio_gate) {graph_launches}")

    phase_done("1-3 build and lio_step")
    lio_report = {"card": card, "scans": N_BENCH, "points_per_scan": CAP,
                  "scans_per_s": N_BENCH / dt, "ms_per_scan": dt / N_BENCH * 1e3,
                  "eager_scans_per_s": N_BENCH / dt_eager,
                  "eager_ms_per_scan": dt_eager / N_BENCH * 1e3,
                  "ate_m": ate, "host_syncs_per_scan": syncs,
                  "graph_counters": dict(lio_graph.counters)}
    p2p_report["launches"] = launches
    del st, st_start

    # ---- 4. the mapping path, 5. the raw-point LIO path --------------------
    with tempfile.TemporaryDirectory() as map_dir:
        mapping_report, map_sim, map_data = run_mapping(dev, card, cfg, map_dir)
        map_phase4 = shutil.copytree(map_dir, os.path.join(keep, "map_phase4"))
        p2p_report["launches_mapping"] = mapping_report["p2p_launches"]
        points_report = run_points(dev, card, cfg, nav0, scans, gt)
        p2p_report["launches_points"] = points_report["p2p_launches"]
        del scans
        phase_done("4-5 mapping and raw points")

        # ---- 6. the localization path on that map --------------------------
        loc_report = run_localization(dev, card, map_dir, map_sim, map_data)
        p2p_report["launches_localization"] = loc_report["p2p_launches"]
        side = loc_report["p2p_at_side_lio_shape"]
        p2p_report["max_abs_err"] = max(p2p_report["max_abs_err"], side["max_abs_err"])
        p2p_report["ms_at_side_lio_shape"] = side["ms"]
        p2p_report["call_ms_at_side_lio_shape"] = side["call_ms"]
        phase_done("6 localization")

    # ---- 7. RTK mapping and LiDAR-only odometry ---------------------------
    rtkm_report = run_rtkm(dev, card, map_sim, map_data,
                           dict(lio=cfg, keyframe_delta_trans=1.5, optimize_every=8))
    icp_odom_report = run_icp_odometry(dev, card)
    phase_done("7 rtkm and icp odometry")

    # ---- 8. detection -------------------------------------------------------
    drive_frames = []
    det_report = run_detection(dev, card, drive_frames)
    p2p_report["launches_detection"] = det_report["p2p_launches"]
    phase_done("8 detection")

    # ---- 9. the camera models ------------------------------------------------
    cam_report = run_camera(dev, card)
    p2p_report["launches_camera"] = cam_report["p2p_launches"]
    phase_done("9 camera")

    # ---- 10. the runtime's default pipeline ---------------------------------
    map_phase10a = os.path.join(keep, "map_phase10a")
    pipe_report = run_pipeline(dev, card, map_sim, map_data, mapping_report, loc_report,
                               det_report, map_phase10a)
    for where in ("mapping", "localization", "detection"):
        p2p_report[f"launches_pipeline_{where}"] = pipe_report[where]["p2p_launches"]
    phase_done("10 pipeline")

    # ---- 11. training ---------------------------------------------------------
    train_report = run_training(dev, card)
    p2p_report["launches_training"] = train_report["p2p_launches"]
    phase_done("11 training")

    # ---- 12. the scoring path -------------------------------------------------
    scoring_report, scoring_files = run_scoring(dev, card, drive_frames,
                                                os.path.join(keep, "scoring"))
    for key in ("evaluate", "loc_eval_map", "loc_eval_loc", "eval_detection", "calibration"):
        p2p_report[f"launches_{key}"] = scoring_report[f"launches_{key}"]
    phase_done("12 scoring")

    # ---- 13. the online system --------------------------------------------------
    online_report = run_online(dev, card)
    p2p_report["launches_online"] = online_report["p2p_launches"]
    phase_done("13 online")

    # ---- 14. multi-device code --------------------------------------------------
    md_report = run_multi_device(dev, card, map_phase4, map_phase10a, keep)
    p2p_report["max_abs_err"] = max(p2p_report["max_abs_err"],
                                    md_report["sharded_map"]["p2p_max_abs_err"])
    p2p_report["launches_parallel_sharded_map"] = md_report["sharded_map"]["p2p_launches"]
    p2p_report["launches_parallel_sharded_lio_update"] = \
        md_report["sharded_update"]["p2p_launches"]
    p2p_report["launches_parallel_sharded_map_2_gloo_ranks"] = \
        md_report["gloo_on_card"]["launches"]
    for key in ("pgo", "merge", "trainer"):
        p2p_report[f"launches_parallel_{key}"] = md_report[key]["p2p_launches"]
    phase_done("14 multi-device")

    # ---- 15. the last tools -------------------------------------------------------
    tools_report = run_tools(dev, card, scoring_files)
    shutil.rmtree(keep, ignore_errors=True)
    p2p_report["max_abs_err"] = max(p2p_report["max_abs_err"],
                                    tools_report["eval_formats"]["p2p_max_abs_err"])
    for key, n in tools_report["launches"].items():
        p2p_report[f"launches_tools_{key}"] = n
    phase_done("15 tools")
    log(f"seconds by phase: {phase_s}; {sum(phase_s.values()):.1f} s in all")

    print(json.dumps({"lio_step": lio_report}))
    print(json.dumps({"mapping": mapping_report}))
    print(json.dumps({"lio_step_points": points_report}))
    print(json.dumps({"localization": loc_report}))
    print(json.dumps({"rtkm": rtkm_report}))
    print(json.dumps({"icp_odometry": icp_odom_report}))
    print(json.dumps({"detection": det_report}))
    print(json.dumps({"camera": cam_report}))
    print(json.dumps({"pipeline": pipe_report}))
    print(json.dumps({"training": train_report}))
    print(json.dumps({"scoring": scoring_report}))
    print(json.dumps({"phase_seconds": phase_s}))
    print(json.dumps({"online": online_report}))
    print(json.dumps({"multi_device": md_report}))
    print(json.dumps({"tools": tools_report}))
    print(card)
    print(json.dumps({"kernels": [p2p_report, imu_report, gate_report, dsvt_report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
