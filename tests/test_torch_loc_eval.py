"""``tools/loc_eval.py`` on the port, on the CPU: ``build_map`` (the mapping
pipeline over 1.15 laps of the figure-eight world) and ``run`` (a new drive
through the localization pipeline on that map), at the smallest size whose
map closes a loop and whose drive relocalises: radius 8 m (``chip_smoke.py``
phase 12b's world), 3,072 points a scan (2,048 closes no loop), 0.4 laps.

``run`` goes without the side LIO (``lio_fusion=False``, the reference
CLI's ``--no-lio-fusion``): with it, both packages start the side LIO cold at
the drive's 5 m/s and go metres off on this world (ROADMAP queue C).  Bars,
those of phase 12b: at least 10 keyframes and one accepted loop; relocalised;
at least 0.9 of the scored frames tracking; tracked RMSE x and y < 0.3 m,
heading < 1.0 deg.  Port only: the reference runs the same tool
(``tests/test_torch_eval_tools.py`` holds its parts to the reference's).
"""

from lsd_tpu_torch.tools import loc_eval as tloc


def test_loc_eval_builds_a_map_and_relocalises(tmp_path):
    kw = dict(radius=8.0, speed=5.0, points=3072, device="cpu")
    built = tloc.build_map(str(tmp_path / "map"), world="fig8",
                           out_root=str(tmp_path / "map_src"), progress=lambda m: None, **kw)
    assert built["scans"] == built["scans_total"], built
    assert built["keyframes"] >= 10 and built["loops"] >= 1, built
    rep = tloc.run(str(tmp_path / "map"), laps=0.4, dropout=None, world="fig8",
                   lio_fusion=False, out_root=str(tmp_path / "loc"), progress=lambda m: None,
                   **kw)
    assert rep["reloc_latency_frames"] is not None and rep["tracking_fraction"] >= 0.9, rep
    assert rep["rmse_x_tracking_m"] < 0.3 and rep["rmse_y_tracking_m"] < 0.3, rep
    assert rep["rmse_heading_tracking_deg"] < 1.0, rep
