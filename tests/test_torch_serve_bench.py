"""The port's serving load harness, ``benchmarks/serve_bench.py``, on the CPU.

``SERVE_SMOKE=1 python -m rho_diffusion_tpu_torch.benchmarks.serve_bench -d cpu``
prints the JAX script's result keys (read from its source), finite samples,
a mean occupancy in (0, 1] and at least ceil(n_load / largest bucket)
launches for the load phase, with and without ``SERVE_QUANT=int8``; without
CUDA the entry raises unless asked for the CPU.
"""
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from chip_smoke import Int8Sites
from rho_diffusion_tpu_torch.benchmarks import serve_bench
from rho_diffusion_tpu_torch.ops import quant

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def jax_result_keys() -> list:
    """The keys of the dict JAX's serve_bench.py prints."""
    tree = ast.parse((ROOT / "benchmarks" / "serve_bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in benchmarks/serve_bench.py")


def test_smoke_prints_jax_keys(monkeypatch, capsys):
    monkeypatch.setenv("SERVE_SMOKE", "1")
    result = serve_bench.main(["-d", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1]) == result
    assert "device=cpu" in lines[-2] and "busy_share=not measured" in lines[-2]
    assert list(result) == jax_result_keys()
    s = serve_bench.settings()
    assert result["workload"] == "8^3 ddim-4 (bf16, mc=16)"
    assert result["all_finite"] is True
    assert 0 < result["mean_batch_occupancy"] <= 1
    assert result["concurrent_requests"] == s["n_load"] == 6
    assert result["load_phase_launches"] >= math.ceil(s["n_load"] / max(s["buckets"]))
    assert result["single_request_latency_p50_s"] > 0
    assert result["throughput_volumes_per_s"] > 0


def test_int8_smoke_serves_the_load(monkeypatch):
    """SERVE_SMOKE=1 SERVE_QUANT=int8: the int8 service runs the latency and
    load phases (finite samples, its workload named), and the mode is off
    again once the service closed."""
    monkeypatch.setenv("SERVE_SMOKE", "1")
    monkeypatch.setenv("SERVE_QUANT", "int8")
    with Int8Sites() as sites:
        result = serve_bench.main(["-d", "cpu"])
    assert result["workload"] == "8^3 ddim-4 (bf16, mc=16) quant=int8"
    assert result["all_finite"] is True and 0 < result["mean_batch_occupancy"] <= 1
    assert result["load_phase_launches"] >= math.ceil(6 / 2)
    assert sites.kinds().get("conv_int8")
    assert quant.get_conv_quant() == "off"


def test_defaults_are_the_flagship_workload(monkeypatch):
    for knob in ("SERVE_SMOKE", "SERVE_GRID", "SERVE_STEPS", "SERVE_BUCKETS", "SERVE_NLAT",
                 "SERVE_NLOAD"):
        monkeypatch.delenv(knob, raising=False)
    s = serve_bench.settings()
    assert (s["grid"], s["mc"], s["steps"], s["sampler"], s["buckets"], s["n_lat"],
            s["n_load"]) == (32, 64, 50, "ddim", (1, 8), 8, 32)
    assert serve_bench.workload_name(s) == "32^3 ddim-50 (bf16, mc=64)"


def test_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    monkeypatch.setenv("SERVE_SMOKE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_bench.main([])
