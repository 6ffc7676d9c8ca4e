"""The harness on the CPU: traffic is a function of the seed with the stated
distribution, parts are found by name, the result line has the contract's
keys, a fault in what the timed path produces makes ``correct`` false,
and a run that needs the card says so without a result."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import run  # noqa: E402
from benchmark.harness import spec, traffic  # noqa: E402
from benchmark.tests import small  # noqa: E402

ROOT = spec.ROOT
BIG_SEED = 2 ** 31 + 12345


def _mixes():
    d = os.path.join(ROOT, "benchmark", "traffic")
    return sorted(f[:-5] for f in os.listdir(d) if f.endswith(".json"))


@pytest.mark.parametrize("mix", _mixes())
def test_traffic_is_a_function_of_the_seed(mix):
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{mix}.json")) as f:
        dist = json.load(f)["frames"]
    a = traffic.sizes(dist, 500, BIG_SEED, 2)
    assert np.array_equal(a, traffic.sizes(dist, 500, BIG_SEED, 2))
    b = traffic.sizes(dist, 500, 7, 2)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))          # the same work in another order


@pytest.mark.parametrize("mix", _mixes())
def test_traffic_follows_its_length_distribution(mix):
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{mix}.json")) as f:
        dist = json.load(f)["frames"]
    q = traffic.quantiles(dist, 2001)
    assert q.min() >= dist["min"] and q.max() <= dist["max"]
    assert np.median(q) == dist["median"]
    z = (np.log(q[(q > dist["min"]) & (q < dist["max"])]) - np.log(dist["median"]))
    assert abs(np.percentile(z, 84.13) - dist["sigma"]) < 0.1 * dist["sigma"] + 0.05


def test_poisson_arrivals():
    due = traffic.poisson_arrivals(2000.0, 20000, BIG_SEED, 1)
    gaps = np.diff(due)
    assert abs(gaps.mean() * 2000.0 - 1.0) < 0.02
    assert np.all(gaps >= 0)
    assert np.array_equal(due, traffic.poisson_arrivals(2000.0, 20000, BIG_SEED, 1))
    other = np.diff(traffic.poisson_arrivals(2000.0, 20000, 5, 1))
    assert abs(np.sort(other)[1:].sum() - np.sort(gaps)[1:].sum()) < 0.01 * gaps.sum()


def test_new_parts_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell, its limits and a per-layer
    metric added as new files, with entries in BENCHMARK.json, need no edit
    to any file that is there."""
    root = tmp_path
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    before = {p: open(os.path.join(ROOT, p), "rb").read()
              for p in ["BENCHMARK.json"] + [
                  os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "benchmark"))
                  for f in fs if not f.endswith(".pyc")]}
    conf = json.load(open(os.path.join(ROOT, bench["configs"][0]["file"])))
    (root / "benchmark" / "configs" / "new-config.json").write_text(
        json.dumps(dict(conf, name="new-config", vocab_size=123)))
    (root / "benchmark" / "traffic" / "new-mix.json").write_text(json.dumps(
        {"runner": "offline", "clips": 7, "frames": {"dist": "fixed", "value": 5}}))
    (root / "benchmark" / "limits" / "new-cell.json").write_text('{"n": 1.5}')
    (root / "benchmark" / "metrics" / "new_metric.x.py").write_text(
        "def read(ctx, outcome):\n    return 41 + outcome\n")
    bench["configs"].append({"name": "new-config", "source": "https://example.org/x",
                             "file": "benchmark/configs/new-config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new-cell", "config": "new-config",
                               "traffic": "new-mix", "chips": 1, "why": "a test"})
    moves = bench["end_to_end"][0]["name"]
    bench["end_to_end"][0].setdefault("workloads", []).append("new-cell")
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "a test",
                               "moves": moves, "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("new-cell", root=str(root))
    assert cell.config["vocab_size"] == 123
    assert cell.mix["clips"] == 7 and cell.limits == {"n": 1.5}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert spec.reader("new_metric.x", root=str(root))(None, 1) == 42
    assert spec.runner(cell.mix).__name__ == "benchmark.harness.offline"
    for p, data in before.items():
        assert open(os.path.join(ROOT, p), "rb").read() == data, p


def test_every_cell_finds_its_parts():
    for name in small.workloads():
        cell = spec.cell(name)
        assert cell.limits, f"{name} has no limits file"
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.reader(m["name"]))


class _Summary:
    busy_s, window_s = 0.25, 1.0
    device_ops = [["decode", 0.2]]
    idle_gaps = [["host idle @0.5s", 0.1]]
    kernels = []
    idle_pct = 75.0


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line_has_the_contracts_keys(traced):
    cell, ctx, out = small.run_small(small.workloads()[0], trace=traced)
    record = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    if traced:
        out.summary = _Summary()
    line = json.loads(json.dumps(run._finite(run.result(cell, ctx, out, record))))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown", "check"] if traced else ["check"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())


def _fault_token(out, mask):
    out = out.clone()
    out[:, 3] = (out[:, 3] + 1) % 64
    return out


def _fault_half(out, mask):
    out = out.clone()
    n = int(mask.any(dim=1).sum())
    if n >= 2:
        out[n // 2:n] = out[:n - n // 2]
    return out


def _fault_frozen(out, mask):
    out = out.clone()
    out[:, 2:] = out[:, 1:2]
    return out


FAULTS = {"token_altered": _fault_token, "half_the_batch_from_the_other_half": _fault_half,
          "state_unchanged": _fault_frozen}


@pytest.mark.parametrize("name", small.workloads())
def test_a_sound_small_run_is_correct(name):
    _, _, out = small.run_small(name)
    assert out.correct, out.checks


@pytest.mark.parametrize("name,fault", [(w, f) for w in small.workloads() for f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault):
    _, _, out = small.run_small(name, fault=FAULTS[fault], seconds=0.8)
    assert not out.correct, out.checks


def test_without_a_card_the_run_prints_no_result(tmp_path):
    """A card-only run: here it must fail with no result; on a card, it runs."""
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
           small.workloads()[0], "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="" if not torch.cuda.is_available()
               else os.environ.get("CUDA_VISIBLE_DEVICES", "0"))
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(tmp_path))
    if not torch.cuda.is_available():
        assert p.returncode != 0 and p.stdout.strip() == ""
        return
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["correct"]


def test_a_run_on_the_card():
    """Skipped inside the test where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
           small.workloads()[0], "--seed", str(BIG_SEED), "--seconds", "2", "--trace", "1"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
