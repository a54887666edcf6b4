"""The port's sampling service on the CPU: the contract tests/test_serving.py
holds the JAX package's service to, the per-row noise keys, guided DDPM
sampling against the JAX package, a context-parallel service against a
single-rank one, and the serve CLI end to end.

The models are small 2-D and 3-D UNetv2s with seeded, nonzero weights
(chip_smoke.random_state_dict): the zero-initialised heads would otherwise
make the output blind to the weights and conditions.
"""
import http.client
import json
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import Int8Sites, random_state_dict
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.diffusion.sampling_rng import (
    keys_at_step,
    keys_from_seeds,
    normal_like,
    per_sample_keys,
)
from rho_diffusion_tpu_torch.diffusion.schedule import LinearSchedule
from rho_diffusion_tpu_torch.ops.kernels import launch_counts
from rho_diffusion_tpu_torch.ops.quant import get_conv_quant, set_conv_quant
from rho_diffusion_tpu_torch.parallel import make_mesh
from rho_diffusion_tpu_torch.serve import build_server
from rho_diffusion_tpu_torch.serving import SamplingService, make_http_handler
from rho_diffusion_tpu_torch.training.checkpoint import save_model_weights

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def backbone_kwargs(num_classes=None, **over):
    kw = dict(data_shape=(8, 8), dims=2, in_channels=1, out_channels=1, model_channels=8,
              num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=[], num_heads=1)
    if num_classes is not None:
        kw["num_classes"] = num_classes
    return {**kw, **over}


def ddpm(num_classes=None, steps=20, seed=0, **over):
    pipe = DDPM("UNetv2", backbone_kwargs(num_classes, **over), LinearSchedule(steps, 2e-4, 1e-2),
                device="cpu")
    pipe.load_state_dict(random_state_dict(pipe.backbone, seed))
    return pipe


@pytest.fixture(scope="module")
def service():
    svc = SamplingService(ddpm(), batch_buckets=(1, 2, 4), max_delay_s=0.05)
    yield svc
    svc.close()


# ---------------------------------------------------------------------------
# Per-row noise keys
# ---------------------------------------------------------------------------

def test_row_noise_is_independent_of_position_bucket_and_split():
    shape = (4, 3, 5)
    keys = keys_from_seeds([9, 9, 1, 0], [2, 3, 0, 0])
    assert keys[:2] == per_sample_keys(9, 2, start=2) and keys[2] == per_sample_keys(1, 1)[0]
    batch = normal_like(keys_at_step(keys, 7), shape, "cpu")
    alone = normal_like(keys_at_step(per_sample_keys(9, 1, start=3), 7), (1, 3, 5), "cpu")
    np.testing.assert_array_equal(batch[1], alone[0])
    # another step, another seed and another row each give another stream
    other = normal_like(keys_at_step(keys, 6), shape, "cpu")
    assert (batch[1] != other[1]).all() and (batch[0] != batch[1]).all()
    assert len(set(per_sample_keys(0, 64)) | set(per_sample_keys(1, 64))) == 128


def test_reverse_process_rows_do_not_depend_on_their_batch():
    pipe = ddpm()
    keys = per_sample_keys(5, 3)
    together = pipe.reverse_process((3, 8, 8, 1), row_keys=keys)["denoised"]
    for i in range(3):
        # the same noise; the CPU library picks its algorithm by batch size,
        # so the UNet's rounding may differ, here by ~1e-5 after 20 steps, as
        # in the slice's comparison with JAX (atol 1e-4); the service runs
        # rows alone on the CPU for its bitwise contract
        alone = pipe.reverse_process((1, 8, 8, 1), row_keys=keys[i:i + 1])["denoised"]
        np.testing.assert_allclose(together[i:i + 1].numpy(), alone.numpy(), rtol=0, atol=1e-4)
        other = pipe.reverse_process((1, 8, 8, 1), row_keys=[keys[(i + 1) % 3]])
        assert np.abs(other["denoised"].numpy() - alone.numpy()).max() > 0.1


# ---------------------------------------------------------------------------
# The service contract (tests/test_serving.py)
# ---------------------------------------------------------------------------

def test_single_request_roundtrip(service):
    res = service.generate(n=3, seed=7)
    assert res.samples.shape == (3, 8, 8, 1) and res.samples.dtype == np.float32
    assert np.isfinite(res.samples).all()
    assert res.bucket == 4 and res.latency_s > 0


def test_oversized_request_split_and_reassembled(service):
    res = service.generate(n=6, seed=1)
    assert res.samples.shape == (6, 8, 8, 1) and np.isfinite(res.samples).all()
    np.testing.assert_array_equal(res.samples, service.generate(n=6, seed=1).samples)
    # rows 4..5 rode the second launch; they equal the same rows of a request of 6 on
    # a service whose one bucket takes them all
    with SamplingService(service.pipeline, batch_buckets=(8,), max_delay_s=0.0) as whole:
        np.testing.assert_array_equal(res.samples, whole.generate(n=6, seed=1).samples)


def test_determinism_under_batching(service):
    """Ancestral DDPM noise is per row: a request is bitwise the same alone
    and coalesced with strangers, and different seeds differ."""
    alone = service.generate(n=1, seed=42).samples
    futs = [service.submit(n=1, seed=s) for s in (42, 999, 1000)]
    results = [f.result(timeout=120) for f in futs]
    np.testing.assert_array_equal(alone, results[0].samples)
    assert max(r.bucket for r in results) > 1  # they shared a launch
    assert np.abs(alone - results[1].samples).max() > 0


def test_concurrent_submissions_all_fulfilled(service):
    futs = [service.submit(n=1, seed=s) for s in range(7)]
    outs = [f.result(timeout=120) for f in futs]
    assert all(o.samples.shape == (1, 8, 8, 1) for o in outs)
    stats = service.stats()
    assert stats["requests"] >= 7 and stats["samples"] >= 7 and stats["launches"] >= 1
    assert 0 < stats["mean_occupancy"] <= 1 and stats["latency_p50_s"] > 0
    assert set(stats["compiled_buckets"]) <= {1, 2, 4}


def test_argument_validation(service):
    with pytest.raises(ValueError):
        service.submit(conditions=np.zeros((1, 3)))  # unconditional service
    with pytest.raises(ValueError):
        service.submit(n=0)
    with pytest.raises(ValueError, match="ascending"):
        SamplingService(service.pipeline, batch_buckets=(4, 2))
    with pytest.raises(ValueError, match="full schedule"):
        SamplingService(service.pipeline, spacing="trailing")
    with pytest.raises(ValueError, match="conditional"):
        SamplingService(service.pipeline, guidance_scale=2.0)


def test_conditional_service_and_validation():
    with SamplingService(ddpm(num_classes=20), cond_dim=32, batch_buckets=(2,),
                         max_delay_s=0.0) as svc:
        conds = np.random.default_rng(0).normal(size=(2, 32)).astype(np.float32)
        res = svc.generate(conditions=conds, seed=3)
        assert res.samples.shape == (2, 8, 8, 1) and np.isfinite(res.samples).all()
        np.testing.assert_array_equal(res.samples, svc.generate(conditions=conds, seed=3).samples)
        assert np.abs(res.samples - svc.generate(conditions=conds + 1, seed=3).samples).max() > 0
        with pytest.raises(ValueError):
            svc.submit(conditions=np.zeros((2, 5), np.float32))
        with pytest.raises(ValueError):
            svc.submit(n=2)  # a conditional service needs rows


def test_transfer_dtype_narrows_pull_widens_on_host():
    pipe = ddpm()
    with SamplingService(pipe, batch_buckets=(2,), max_delay_s=0.0) as exact:
        ref = exact.generate(n=2, seed=5).samples
    with SamplingService(pipe, batch_buckets=(2,), max_delay_s=0.0,
                         transfer_dtype="bfloat16") as narrowed:
        out = narrowed.generate(n=2, seed=5).samples
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert not np.array_equal(out, ref)
    np.testing.assert_allclose(out, ref, atol=2 ** -8 * np.abs(ref).max())
    with pytest.raises(ValueError):
        SamplingService(pipe, transfer_dtype="int8")


def test_guided_ddpm_service_and_reverse_process_match_jax():
    """Classifier-free guidance: one batched forward over [x; x] with a
    per-row condition mask, held against the JAX package's guided reverse
    process from a shared x_T (noise_factor 0); and served."""
    from test_torch_ddpm import SPACE, pipelines

    jpipe, params, tpipe = pipelines()
    cond = tpipe.conditions_from_parameter_space(
        SPACE, 2, random=False, as_hash_embeddings=True,
        embedding_dim=tpipe.condition_embedding_dim())
    x_T = np.random.default_rng(3).normal(size=(2, 4, 8, 8, 1)).astype(np.float32)
    want = jax.jit(lambda p, c, x: jpipe.reverse_process(
        p, jax.random.PRNGKey(0), x_T.shape, c, x_T=x, guidance_scale=2.5))(
        params, jnp.asarray(cond.numpy()), jnp.asarray(x_T))["denoised"]
    got = tpipe.reverse_process(x_T.shape, cond, x_T=torch.from_numpy(x_T),
                                guidance_scale=2.5)["denoised"].numpy()
    w = np.asarray(want)
    assert np.mean((got - w) ** 2) / np.mean(w ** 2) < 1e-9
    np.testing.assert_allclose(got, w, atol=1e-4)
    unguided = tpipe.reverse_process(x_T.shape, cond, x_T=torch.from_numpy(x_T))["denoised"]
    assert np.abs(unguided.numpy() - got).max() > 1e-3
    with SamplingService(tpipe, cond_dim=cond.shape[1], guidance_scale=2.5, batch_buckets=(2,),
                         max_delay_s=0.0) as svc:
        res = svc.generate(conditions=cond.numpy(), seed=1)
        assert res.samples.shape == (2, 4, 8, 8, 1) and np.isfinite(res.samples).all()


def test_http_surface(service):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_http_handler(service))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        headers = {"Content-Type": "application/json"}
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read()) == {"ok": True}
        conn.request("POST", "/generate", body=json.dumps({"n": 2, "seed": 5}), headers=headers)
        reply = json.loads(conn.getresponse().read())
        assert reply["shape"] == [2, 8, 8, 1]
        arr = np.asarray(reply["samples"], np.float32)
        np.testing.assert_array_equal(arr, service.generate(n=2, seed=5).samples)
        conn.request("POST", "/generate", body=json.dumps({"n": 1, "return": "stats"}),
                     headers=headers)
        reply = json.loads(conn.getresponse().read())
        assert "samples" not in reply and reply["shape"] == [1, 8, 8, 1]
        conn.request("GET", "/stats")
        assert json.loads(conn.getresponse().read())["requests"] >= 3
        conn.request("POST", "/generate", body=json.dumps({"conditions": [[1, 2, 3]]}),
                     headers=headers)
        resp = conn.getresponse()
        assert resp.status == 400 and "error" in json.loads(resp.read())
        conn.request("POST", "/reload", body="{}", headers=headers)
        resp = conn.getresponse()
        assert resp.status == 400 and "from_config" in json.loads(resp.read())["error"]
        conn.request("GET", "/nowhere")
        resp = conn.getresponse()
        assert resp.status == 404 and "error" in json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def small_config(tmp_path, **model_over):
    kwargs = dict(dims=2, in_channels=1, out_channels=1, model_channels=8, num_res_blocks=1,
                  data_shape=[8, 8], channel_mult=[1, 2], attention_resolutions=[])
    kwargs.update(model_over)
    config = {
        "experiment": "serve-small",
        "model": {"name": "UNetv2", "kwargs": kwargs},
        "dataset": {"name": "SphericalHarmonicDataset", "kwargs": {"max_l": 2, "grid_el": 8}},
        "optimizer": {"name": "AdamW", "kwargs": {"lr": 1e-3}},
        "noise_schedule": {"name": "LinearSchedule",
                           "kwargs": {"num_steps": 20, "beta_1": 2e-4, "beta_T": 1e-2}},
        "pipeline": {"name": "DDPM", "kwargs": {}},
        "training": {"batch_size": 4, "max_epochs": 1, "loss_fn": "MSELoss",
                     "checkpoint_dir": str(tmp_path / "none")},
        "inference": {"num_samples": 2, "device": "cpu"},
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config))
    return path


def seeded_pth(tmp_path, seed=1, **model_over) -> Path:
    """A .pth of seeded nonzero weights for ``small_config``'s model."""
    path = tmp_path / f"seeded-{seed}.pth"
    torch.save(random_state_dict(ddpm(**model_over).backbone, seed), path)
    return path


def test_hot_reload_swaps_weights(tmp_path):
    """A from_config service picks up new weights from a port checkpoint
    (a .pth) without building a new sampler; a service not built by
    from_config refuses checkpoint reloads but takes update_params."""
    service = SamplingService.from_config(small_config(tmp_path), seeded_pth(tmp_path),
                                          log=lambda m: None, device="cpu", batch_buckets=(1,),
                                          max_delay_s=0.0)
    try:
        before = service.generate(n=1, seed=0).samples
        launches = service.stats()["launches"]
        new = random_state_dict(service.pipeline.backbone, seed=2)
        service.pipeline.backbone.load_state_dict(new)
        ckpt = tmp_path / "model.pth"
        save_model_weights(service.pipeline.backbone, ckpt)
        service.update_params(random_state_dict(service.pipeline.backbone, seed=3))
        messages = service.reload_from_checkpoint(str(ckpt))
        assert any("loaded weights" in m for m in messages), messages
        after = service.generate(n=1, seed=0).samples
        assert np.abs(before - after).max() > 0
        assert sorted(service._compiled) == [1]
        assert service.stats()["launches"] == launches + 1
        for k, v in service.pipeline.backbone.state_dict().items():
            torch.testing.assert_close(v, new[k], rtol=0, atol=0)
    finally:
        service.close()
    with SamplingService(service.pipeline, batch_buckets=(1,), max_delay_s=0.0) as direct:
        with pytest.raises(RuntimeError, match="from_config"):
            direct.reload_from_checkpoint(str(ckpt))
        direct.update_params(random_state_dict(service.pipeline.backbone, seed=4))
        assert np.abs(direct.generate(n=1, seed=0).samples - after).max() > 0


def test_warmup_fails_fast_on_broken_service():
    """A class-conditional model served without cond_dim fails in the
    constructor (the UNet needs its labels), not on a request."""
    with pytest.raises(AssertionError, match="requires y"):
        SamplingService(ddpm(num_classes=20), cond_dim=None, batch_buckets=(1,), warmup=True)


def test_close_fails_pending_requests():
    svc = SamplingService(ddpm(), batch_buckets=(1,), max_delay_s=0.0)
    svc.submit(n=1, seed=0).result(timeout=120)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(n=1)
    svc.close()  # idempotent


def test_delivery_exception_does_not_kill_pull_thread():
    svc = SamplingService(ddpm(), batch_buckets=(1,), max_delay_s=0.0)
    try:
        svc.generate(n=1, seed=0)
        real = svc._deliver

        def exploding(*a, **k):
            raise RuntimeError("simulated delivery bug")

        svc._deliver = exploding
        with pytest.raises(RuntimeError, match="simulated delivery bug"):
            svc.submit(n=1, seed=1).result(timeout=120)
        svc._deliver = real
        assert np.isfinite(svc.generate(n=1, seed=2).samples).all()
        assert svc._puller.is_alive()
    finally:
        svc.close()


@pytest.mark.parametrize("cond_fn,want", [(None, 32), ("MultiEmbeddings", 2)],
                         ids=["hash-rows", "parameter-rows"])
def test_from_config_derives_cond_dim_and_warns(tmp_path, cond_fn, want):
    over = {"num_classes": 20}
    if cond_fn:
        over["cond_fn"] = cond_fn
    logged = []
    svc = SamplingService.from_config(small_config(tmp_path, **over),
                                      checkpoint=str(tmp_path / "missing.pth"),
                                      log=logged.append, device="cpu", batch_buckets=(2,),
                                      max_delay_s=0.0)
    try:
        assert svc.cond_dim == want
        assert any("WARNING" in m and "missing.pth" in m for m in logged), logged
        svc.update_params(random_state_dict(svc.pipeline.backbone, seed=1))
        res = svc.generate(conditions=np.ones((2, want), np.float32), seed=0)
        assert res.samples.shape == (2, 8, 8, 1) and np.isfinite(res.samples).all()
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# Context-parallel serving and the CLI
# ---------------------------------------------------------------------------

def test_context_parallel_service_matches_single_rank(monkeypatch):
    """A context=2 mesh of CPU ranks with impl="rdma": each rank samples its
    depth slab, every attention call runs K6's ring over the slabs' tokens
    (its plain step), and the samples match a single-rank service's
    (test_serving.py:427-460's bar)."""
    monkeypatch.setenv("RHO_RING_ATTN_IMPL", "rdma")
    pipe = ddpm(data_shape=(4, 8, 8), dims=3, model_channels=16, attention_resolutions=[2],
                num_heads=2)
    from rho_diffusion_tpu_torch.ops import attention as attn_mod

    rings = []
    real = attn_mod.ring_attention_rdma_shards
    monkeypatch.setattr(attn_mod, "ring_attention_rdma_shards",
                        lambda qs, *a, **kw: rings.append(qs[0].shape) or real(qs, *a, **kw))
    mesh = make_mesh(data=1, context=2, devices=["cpu", "cpu"])
    with SamplingService(pipe, batch_buckets=(2,), max_delay_s=0.0, mesh=mesh) as cp, \
            SamplingService(pipe, batch_buckets=(2,), max_delay_s=0.0) as single:
        a = cp.generate(n=2, seed=9).samples
        assert rings and cp.stats()["mesh"] == {"data": 1, "context": 2}
        n_rings = len(rings)
        b = single.generate(n=2, seed=9).samples
        assert len(rings) == n_rings  # the single-rank service runs no ring
    assert a.shape == (2, 4, 8, 8, 1)
    np.testing.assert_allclose(a, b, atol=5e-5)


def test_service_mesh_rules():
    """JAX's rule (serving.py:207-216): every bucket divides by the data
    axis, else ``ValueError``; a data axis of 2 (ported) serves the data-1
    service's rows, one model replica per data rank."""
    pipe = ddpm()
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        SamplingService(pipe, batch_buckets=(1, 2), mesh=make_mesh(2, 1, devices=["cpu"] * 2))
    with SamplingService(pipe, batch_buckets=(2,), max_delay_s=0.0,
                         mesh=make_mesh(2, 1, devices=["cpu"] * 2)) as dp, \
            SamplingService(pipe, batch_buckets=(2,), max_delay_s=0.0) as one:
        np.testing.assert_array_equal(dp.generate(n=2, seed=4).samples,
                                      one.generate(n=2, seed=4).samples)
        assert dp.stats()["mesh"] == {"data": 2, "context": 1}


def test_quantized_service():
    """JAX's contract (tests/test_serving.py test_quantized_service):
    quantize='int8' serves finite samples from the unchanged weights, the
    mode is on while the service runs and close() restores it; an unknown
    mode is a ValueError. A row is the same alone and co-batched (per-sample
    activation scales)."""
    pipe = ddpm(model_channels=16)
    try:
        with SamplingService(pipe, batch_buckets=(1, 2), max_delay_s=0.0,
                             quantize="int8") as service:
            assert get_conv_quant() == "int8"
            with Int8Sites() as sites:
                res = service.generate(n=2, seed=0)
            assert sites.kinds().get("conv_int8")
            assert res.samples.shape == (2, 8, 8, 1)
            assert np.isfinite(res.samples).all()
            alone = service.generate(n=1, seed=0).samples
            np.testing.assert_array_equal(alone[0], res.samples[0])
        assert get_conv_quant() == "off"
        with SamplingService(pipe, batch_buckets=(2,), max_delay_s=0.0) as plain:
            assert np.abs(plain.generate(n=2, seed=0).samples - res.samples).max() > 1e-4
        with pytest.raises(ValueError, match="conv quant mode"):
            SamplingService(pipe, quantize="int4")
    finally:
        set_conv_quant("off")


def test_quantized_service_that_fails_to_build_restores_the_mode():
    """A constructor that raises after it set int8 (here on its buckets)
    gives the mode back, since no close() follows."""
    pipe = ddpm(model_channels=16)
    with pytest.raises(ValueError, match="batch_buckets"):
        SamplingService(pipe, batch_buckets=(2, 1), quantize="int8")
    assert get_conv_quant() == "off"


def test_build_server_on_cpu_with_context_ranks(tmp_path, monkeypatch):
    """serve.build_server: -d cpu --context-parallel 2 puts two ranks on the
    CPU; the served samples match the Python API's."""
    monkeypatch.setenv("RHO_RING_ATTN_IMPL", "rdma")
    model = dict(data_shape=[4, 8, 8], dims=3, attention_resolutions=[2], num_heads=2,
                 model_channels=16)
    cfg, pth = small_config(tmp_path, **model), seeded_pth(tmp_path, **model)
    launch_counts.clear()
    server, svc = build_server([str(cfg), "-p", str(pth), "-d", "cpu", "--port", "0",
                                "--buckets", "1,2", "--context-parallel", "2", "--warmup"],
                               log=lambda m: None)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert svc.mesh.shape == {"data": 1, "context": 2}
        assert sorted(svc._compiled) == [1, 2]  # warmed up
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)
        conn.request("POST", "/generate", body=json.dumps({"n": 3, "seed": 4}),
                     headers={"Content-Type": "application/json"})
        reply = json.loads(conn.getresponse().read())
        conn.close()
        assert reply["shape"] == [3, 4, 8, 8, 1]
        np.testing.assert_array_equal(np.asarray(reply["samples"], np.float32),
                                      svc.generate(n=3, seed=4).samples)
        assert sum(launch_counts.values()) == 0  # CPU ranks launch no kernel
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        t.join(timeout=10)


def test_serve_cli_end_to_end(tmp_path):
    """python -m rho_diffusion_tpu_torch.serve CONFIG -d cpu --context-parallel 2:
    config -> HTTP service -> finite samples."""
    model = dict(data_shape=[4, 8, 8], dims=3, attention_resolutions=[2], num_heads=2,
                 model_channels=16)
    cfg, pth = small_config(tmp_path, **model), seeded_pth(tmp_path, **model)
    err_path = tmp_path / "server_stderr.log"
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "RHO_RING_ATTN_IMPL": "rdma",
           "OMP_NUM_THREADS": "1"}
    with open(err_path, "w") as err_f:  # a file: nobody drains a pipe while we wait
        proc = subprocess.Popen(
            [sys.executable, "-m", "rho_diffusion_tpu_torch.serve", str(cfg), "-p", str(pth),
             "-d", "cpu", "--port", "0", "--buckets", "1,2", "--context-parallel", "2"],
            stdout=subprocess.PIPE, stderr=err_f, text=True, env=env, cwd=tmp_path)
    try:
        line = ""
        for _ in range(20):
            line = proc.stdout.readline()
            if "serving on http://" in line or not line:
                break
        assert "serving on http://" in line, (line, err_path.read_text())
        assert "'context': 2" in line
        port = int(line.split("http://")[1].split(":")[1].split(" ")[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/generate", body=json.dumps({"n": 2, "seed": 11}),
                     headers={"Content-Type": "application/json"})
        reply = json.loads(conn.getresponse().read())
        conn.close()
        assert reply["shape"] == [2, 4, 8, 8, 1]
        assert np.isfinite(np.asarray(reply["samples"], np.float32)).all()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
