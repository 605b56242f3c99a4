"""The plain reference the benchmark's output check holds the program to.

Plain PyTorch and numpy, importing nothing of ``lsd_tpu_torch``: frozen
copies of the port's plain twins of the LIO step (``lio.py`` with the
plain point-to-plane reduction ``p2p.py`` in place of the CUDA kernel B1,
``imu.py``, ``state.py``, ``so3.py``, ``se3.py``, ``voxelize.py``,
``hashmap.py``, ``surfel.py``, ``planefit.py``) and of the detection path
(``detector.py``, ``vfe.py``, ``bev_backbone.py``, ``center_head.py``,
``iou3d.py``, ``post.py``, ``params_io.py``, ``tracker.py``,
``accumulate.py``, ``object_filter.py``, ``freespace.py``), with
``lio_ref.py`` and ``detect_ref.py`` driving them as the program's entry
points are driven.  They work out again, from the inputs the benchmark
made, what the program derived: the reference reads the program's outputs
only to judge them.
"""
