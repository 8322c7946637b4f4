"""The command: no result without a card or without the program, and a
cell added by a traffic file and an entry, with no code edited."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT


def run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def no_result(out: str) -> bool:
    return not any(line.startswith("{") for line in out.splitlines())


def test_refuses_without_a_card(card_absent):
    p = run(ROOT, "--workload", "flagship.train_xe", "--seed", "2147483999",
            "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and no_result(p.stdout)


def copy_of_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(tmp_path)


def test_fails_in_a_folder_with_the_benchmark_alone(tmp_path):
    d = copy_of_the_benchmark(tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    p = run(d, "--workload", "flagship.train_xe", "--seed", "1",
            "--seconds", "1", "--trace", "0", env=env)
    assert p.returncode != 0 and no_result(p.stdout)


def test_a_traffic_file_adds_a_cell(tmp_path):
    d = copy_of_the_benchmark(tmp_path)
    mix = {"driver": "train_xe", "metric": "train_images_per_s",
           "batch": 4, "images": 8, "captions_per_image": 2,
           "trace_units": 2, "why": "a tiny XE mix"}
    with open(os.path.join(d, "benchmark", "traffic", "xe_b4.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(d, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "flagship.xe_b4", "config":
                              "flagship", "traffic": "xe_b4", "chips": 1,
                              "why": "tiny"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("flagship.xe_b4")
    with open(os.path.join(d, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "from benchmark import harness\n"
            "assert harness.ROOT == %r\n"
            "line = harness.execute(harness.resolve('flagship.xe_b4'), 7, "
            "0.5, False, device='cpu')\n"
            "print(json.dumps(line))" % (d, ROOT, d))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] and "train_images_per_s" in line["metrics"]
