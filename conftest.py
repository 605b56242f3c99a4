"""One torch intra-op thread for every test process, set once, before any
test runs.

The suite runs in several processes at once (``-n 6`` under xdist) on a
machine with few more cores than that.  At torch's default each process
starts one intra-op thread per core, and their OpenMP threads spin against
each other: on an 8-CPU host, six concurrent copies of
``tests/test_torch_dsvt.py::test_forward_matches_plain_at_d192`` took
100.7-101.9 s each at the default against 10.7 s for one copy alone, and
1.10-1.49 s each with this file (all six together: 235 s of wall clock at
the default, 16 s with this file).  Six one-thread processes together beat
one eight-thread process alone, so one thread is the budget of every test
process; ``parallel.run_ranks`` splits it between the ranks it spawns.
Three parity tests ask for torch's default instead (``default_torch_threads``).

OpenCV's own pool gets one thread too: ``cv2.calibrateCamera`` sums in the
order its threads finish, so two calls on the same points differ by up to
5.2e-8 (6 of 20 on an idle 8-CPU host), where the calibration tests compare
both packages' calls to 1e-9.  Only these two pools are set:
``OMP_NUM_THREADS`` would also reach numpy's BLAS and every subprocess, and
JAX's thread pools are left as they are.
"""
import pytest
import torch

try:
    import cv2
    cv2.setNumThreads(1)
except ImportError:   # OpenCV is optional; the camera paths work without it
    pass

# torch's default, one thread a core, taken before the budget replaces it
DEFAULT_THREADS = torch.get_num_threads()
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def default_torch_threads():
    """torch's default thread count for the rest of the module, for the
    three parity tests whose float32 trajectories were measured there.

    The thread count sets the order of torch's CPU reductions, and these
    tests let the rounding grow through several steps before they compare
    with the reference: at one thread the detector trainer's fifth loss lies
    1.86e-4 from the JAX trainer's (bound 1e-4), though each lies 0.9-1.0e-4
    from the float64 twin at 1, 2, 4 and 8 threads; the data-parallel
    ranks' third loss 4.7e-4 (bound 1e-4); and a map built at one thread
    moves the reference's own localizer by up to 1.0 m on the cruise drive,
    where the two packages must agree to 0.1 m.  Requested by
    ``tests/test_torch_training.py::test_float32_trainer_steps_match_jax``
    and the module fixtures of ``tests/test_torch_training_dp.py`` and
    ``tests/test_torch_localization_cruise.py``."""
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(1)
