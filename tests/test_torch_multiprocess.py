"""Two processes training as one, on the CPU (tests/parallel/
test_two_process_distributed.py's check, for the port).

Two worker processes (tests/torch_multiprocess_worker.py) join a gloo group
and each drives 4 CPU ranks of the global data-8 mesh, taking its rows of
every batch from the port's loader. From JAX's state carried across and
JAX's draws, two steps each:

* both processes report the same losses (rtol 1e-6): the gradients and
  metrics are averaged over the processes;
* those losses equal a one-process 8-rank run's and JAX's 8-device run's
  within atol 2e-5;
* each process's rows are those JAX's loader gives the same
  ``process_index``.

The workers have a time limit of their own: a hung rendezvous fails the
test instead of hanging the suite.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.data.loader import DataLoader as JaxDataLoader
from rho_diffusion_tpu.parallel import active_mesh as jax_active_mesh
from rho_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from rho_diffusion_tpu.parallel import replicate_state as jax_replicate_state
from rho_diffusion_tpu.parallel import shard_batch as jax_shard_batch
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.parallel.mesh import make_mesh
from test_torch_fsdp import jax_start, port_state_from
from test_torch_mesh_training import step_draws
from torch_multiprocess_worker import Fields, run

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_multiprocess_worker.py")
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(work: Path) -> list:
    """Start the two workers on the state and draws under ``work``."""
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    return [subprocess.Popen([sys.executable, str(WORKER), str(i), "2", str(port), str(work)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env) for i in range(2)]


def results_of(procs: list) -> list[dict]:
    """Each worker's RESULT line, within the time limit (else every worker
    is killed and the test fails)."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the two workers did not finish within {TIMEOUT_S} s")
    results = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        assert line, out[-4000:]
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def test_two_processes_train_as_one(tmp_path):
    jmesh = jax_make_mesh(data=8, context=1)
    jpipe, js = jax_start()
    _, start = port_state_from(js)
    torch.save(start.state_dict(), tmp_path / "state.pt")
    loader = JaxDataLoader(Fields(), batch_size=8, seed=0, num_workers=0, process_index=0,
                           num_processes=1)
    loader.set_epoch(0)
    batches = list(loader)
    # JAX's draws of each step from the state's key, which each step
    # advances to its split's first half (held against the steps below),
    # so that the workers run while JAX compiles its step
    draws, rng = [], js.rng
    for b in batches:
        draws.append(step_draws(SimpleNamespace(rng=rng), b["data"].shape))
        rng = jax.random.split(rng)[0]
    torch.save(draws, tmp_path / "draws.pt")
    procs = spawn(tmp_path)
    try:
        step = jpipe.make_train_step(donate=False)
        jax_losses = []
        with jax_active_mesh(jmesh):
            jstate = jax_replicate_state(js, jmesh)
            for b, d in zip(batches, draws):
                want = step_draws(jstate, b["data"].shape)
                assert all(torch.equal(want[k], d[k]) for k in d)
                jstate, m = step(jstate, jax_shard_batch(dict(b), jmesh))
                jax_losses.append(float(m["train_loss"]))
        assert len(jax_losses) == 2
        pipe, state = port_state_from(js)
        one, _ = run(pipe, state, make_mesh(8, 1, devices=["cpu"] * 8),
                     DataLoader(Fields(), batch_size=8, seed=0, num_workers=0, process_index=0,
                                num_processes=1), draws)
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    results = results_of(procs)
    np.testing.assert_allclose(results[0]["losses"], results[1]["losses"], rtol=1e-6)
    np.testing.assert_allclose(results[0]["losses"], one, rtol=0, atol=2e-5)
    np.testing.assert_allclose(results[0]["losses"], jax_losses, rtol=0, atol=2e-5)

    for index, got in enumerate(results):
        rows = JaxDataLoader(Fields(), batch_size=8, seed=0, num_workers=0,
                             process_index=index, num_processes=2)
        rows.set_epoch(0)
        want = [b["data"].reshape(len(b["data"]), -1).sum(axis=1) for b in rows]
        assert len(got["rows"]) == len(want) == 2
        for g, w in zip(got["rows"], want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
