"""A configuration, a traffic mix, a per-layer metric and a cell are added
as new files and new entries only: no file the benchmark has is edited."""
import json
import shutil

from _util import ROOT, run_cell


def test_new_cell_from_new_files_only(tmp_path):
    shutil.copytree(ROOT / "cambench", tmp_path / "cambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "cambench").rglob("*") if p.is_file()}

    cfg = json.loads((ROOT / "cambench/configs/cam-pgm-books20m.json")
                     .read_text())
    cfg.update(name="cam-pgm-small", knob_grid=[64, 256, 1024])
    (tmp_path / "cambench/configs/cam-pgm-small.json").write_text(
        json.dumps(cfg))
    mix = json.loads((ROOT / "cambench/traffic/tune-w4.json").read_text())
    mix.update(mixture="w3", queries=200_000)
    (tmp_path / "cambench/traffic/tune-w3.json").write_text(json.dumps(mix))
    (tmp_path / "cambench/metrics/tune_other_ms.tune.py").write_text(
        "def read(r):\n    return r.span_ms('tune', per='request')\n")
    limits = json.loads((ROOT / "cambench/limits/pgm.tune-w4.json")
                        .read_text())
    (tmp_path / "cambench/limits/small.tune-w3.json").write_text(
        json.dumps(limits))

    bench["configs"].append({"name": "cam-pgm-small", "source": "test",
                             "file": "cambench/configs/cam-pgm-small.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small.tune-w3",
                               "config": "cam-pgm-small",
                               "traffic": "tune-w3", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("small.tune-w3")
    bench["per_layer"].append({"name": "tune_other_ms.tune", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "test", "moves": "tune_s",
                               "workloads": ["small.tune-w3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "cambench").rglob("*")
             if p.is_file() and p.relative_to(tmp_path) in before}
    assert after == before
    rc, line, err = run_cell("small.tune-w3", seed=8, trace=0, root=tmp_path)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    assert {"tune_s", "setup_s"} == set(line["metrics"])
    rc, line, err = run_cell("small.tune-w3", seed=8, trace=1, root=tmp_path,
                             seconds=8.0)
    assert rc == 0, err[-3000:]
    assert "tune_other_ms.tune" in line["metrics"]


def test_directory_of_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "cambench", tmp_path / "cambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    rc, line, _ = run_cell("pgm.tune-policy-10k", seed=1, trace=0,
                           root=tmp_path)
    assert rc != 0 and line is None
