"""Every configuration, cell and metric of BENCHMARK.json is found by name
in files of its own, and a cell added as files alone is found too."""

import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_config_and_metric_loads_by_name():
    bench = harness.spec()
    for cell in bench["workloads"]:
        assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
        c, config, traffic = harness.load_cell(cell["name"], bench)
        assert traffic["loop"] == "closed" and traffic["warmup"] >= 1 and traffic["queue_per_second"] > 0
        inputs = importlib.import_module(f"benchmark.inputs.{config['air']}")
        assert callable(inputs.statements) and callable(inputs.port_air)
        air = importlib.import_module(f"benchmark.reference.airs.{config['air']}")
        assert air.WIDTH == config["width"] and air.NUM_PUBLIC == config["num_public_values"]
    for entry in bench["configs"]:
        assert entry["file"].startswith("benchmark/configs/") and (ROOT / entry["file"]).is_file()
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and callable(harness.load_metric(m["name"]).read)
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s", "prove_s", "peak_mem_gib"}


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", ".out"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/fib_air.json").read_text())
    cfg["log_n"] = 20
    (tmp_path / "benchmark/configs/fib_air_small.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/throwaway.json").write_text(
        json.dumps({"loop": "closed", "clients": 1, "warmup": 1, "queue_per_second": 3.0}))
    (tmp_path / "benchmark/metrics/throwaway.count.py").write_text("def read(ctx):\n    return 7.0\n")
    bench["configs"].append({"name": "fib_air_small", "source": "x", "file": "benchmark/configs/fib_air_small.json",
                             "reduced": ["log_n"], "why": "x"})
    bench["workloads"].append({"name": "fib_air_small.2e20", "config": "fib_air_small", "traffic": "throwaway",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "throwaway.count", "unit": "n", "better": "lower", "source": "program_counter",
                               "layer": "device", "moves": "prove_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from benchmark import harness as h; "
            "c, cfg, t = h.load_cell('fib_air_small.2e20'); "
            "print(cfg['log_n'], t['queue_per_second'], h.load_metric('throwaway.count').read(None), h.ROOT)")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, check=True)
    log_n, rate, value, root = out.stdout.split()
    assert (int(log_n), float(rate), float(value), Path(root)) == (20, 3.0, 7.0, tmp_path)


def test_the_command_fails_without_a_card_or_without_the_program(tmp_path):
    run = [sys.executable, "benchmark/run.py", "--workload", "fib_air.2e22", "--seed", str(2**31 + 5),
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(run, cwd=ROOT, capture_output=True, text=True)
    if out.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert out.stdout == ""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(run, cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
