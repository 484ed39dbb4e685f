"""The harness is driven by files found by name, and loads neither JAX
nor the JAX package nor the repository's JAX-era scripts."""

import json
import shutil
import subprocess
import sys
import textwrap

from vobench import run


def test_new_files_are_found_without_edits(tmp_path):
    """A configuration, a traffic mix and a per-layer metric dropped as new
    files into a copy of vobench/, and a cell naming them, are found by
    name; no file that was there is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "vobench").rglob("*") if p.is_file()}
    cfg = json.loads((run.HERE / "configs" / "kitti_stereo_vo.json").read_text())
    cfg["name"] = "new_config"
    (root / "vobench" / "configs" / "new_config.json").write_text(json.dumps(cfg))
    tr = json.loads((run.HERE / "traffic" / "drive_stereo.json").read_text())
    tr.update(name="new_traffic", step_m=1.6, period_frames=80)
    (root / "vobench" / "traffic" / "new_traffic.json").write_text(json.dumps(tr))
    (root / "vobench" / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0 if run.keyframes else None\n")
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new.cell", "config": "new_config",
                               "traffic": "new_traffic", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "x", "better": "higher",
                               "source": "host_clock", "layer": "engine", "moves": "fps",
                               "workloads": ["new.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import importlib, json
        from vobench import run
        cell = run.cell_of("new.cell")
        tr = run.Trace(cell, keyframes=[True])
        vals = {m["name"]: importlib.import_module("vobench.metrics." + m["name"]).read(tr)
                for m in cell.per_layer}
        print(json.dumps([cell.config["name"], cell.traffic["step_m"], vals["new_metric"],
                          sorted(m["name"] for m in cell.end_to_end)]))
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    name, step, value, e2e = json.loads(p.stdout.strip().splitlines()[-1])
    assert (name, step, value) == ("new_config", 1.6, 42.0)
    assert e2e == ["fps", "setup_s"]
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_imports_load_no_jax():
    """Every module of the benchmark imported in one process: no module
    whose top-level name is jax, jaxlib, flax or viso_tpu (the part before
    the first dot, compared whole), nor bench or chip_smoke; and the plain
    reference loads nothing of the port."""
    code = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        import vobench
        names = [m.name for m in pkgutil.walk_packages(vobench.__path__, "vobench.")
                 if not m.name.startswith("vobench.tests")]
        for name in sorted(n for n in names if n.startswith("vobench.reference")):
            importlib.import_module(name)
        port_by_reference = sorted(m for m in sys.modules if m.split(".")[0] == "viso_tpu_torch")
        for name in names:
            importlib.import_module(name)
        print(json.dumps([len(names), sorted({m.split(".")[0] for m in sys.modules}),
                          port_by_reference]))
    """)
    p = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    n, tops, port_by_reference = json.loads(p.stdout.strip().splitlines()[-1])
    assert n > 30
    assert not set(tops) & {"jax", "jaxlib", "flax", "viso_tpu", "bench", "chip_smoke"}
    assert port_by_reference == []
