"""lsd_tpu_torch — the PyTorch/CUDA port of lsd_tpu for NVIDIA Hopper.

The layout and names follow ``lsd_tpu`` (``geometry/so3.py``,
``slam/lio.py``, ``ops/surfel.py``, ...) so each module's counterpart is
easy to find.  The package imports torch and numpy only: never jax and
nothing from ``lsd_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request they raise (``utils/device.py``).
"""
