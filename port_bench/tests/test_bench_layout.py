"""The harness finds every cell's files by name, and loads neither JAX nor
the JAX package; the reference loads nothing of the program."""
import json
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.harness import BENCH_DIR, ROOT, Cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = Cell(workload)
    assert (BENCH_DIR / "drivers" / f"{cell.traffic['kind']}.py").exists()
    assert cell.config["name"] == cell.entry["config"]
    entry = {c["name"]: c for c in BENCH["configs"]}[cell.entry["config"]]
    assert cell.config["reduced"] == entry["reduced"]
    assert all(k in cell.config for k in entry["reduced"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert all(n == "setup_s" or n in harness.END_TO_END for n in names)
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in names
    assert f"traced_{'scans' if cell.traffic['kind'] == 'lio_replay' else 'frames'}" in cell.traffic


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("port_bench/")
    for m in BENCH["end_to_end"]:
        assert m["bound"] <= 0.25


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return {m.split(".", 1)[0] for m in out.stdout.split()}


def test_harness_loads_no_jax():
    mods = _modules_after("import port_bench.harness, port_bench.trace, port_bench.compare, "
                          "port_bench.drivers.lio_replay, port_bench.drivers.detect_drive, "
                          "port_bench.reference.lio_ref, port_bench.reference.detect_ref")
    assert not mods & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import port_bench.reference.lio_ref, port_bench.reference.detect_ref")
    assert "lsd_tpu_torch" not in mods and not mods & set(harness.FORBIDDEN)
