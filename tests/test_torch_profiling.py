"""The port's profiling utilities and op table, on the CPU.

* ``StepTimer``, ``find_nonfinite`` and ``check_finite`` give the JAX
  package's results on the same inputs (the paths written as
  ``jax.tree_util.keystr`` writes them);
* ``compiled_cost`` counts the FLOPs XLA's cost analysis counts for a
  matmul and for a 3-D conv, SAME (XLA counts only the products inside the
  unpadded input) and VALID;
* ``trace`` writes a chrome trace;
* the op table's grouping puts each of a fixed list of kernel names (the
  port's kernels as PERF.md's table names them, and PyTorch's, cuBLAS's
  and cuDNN's as torch.profiler names them on the card) into its one group,
  and the groups of a CPU profile of a small UNet's training step sum to
  the profile's total, with GroupNorm32's forward and backward found.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rho_diffusion_tpu.training import profiling as jax_profiling
from rho_diffusion_tpu_torch.benchmarks import op_table
from rho_diffusion_tpu_torch.benchmarks._timing import device_events
from rho_diffusion_tpu_torch.diffusion import DDPM, LinearSchedule
from rho_diffusion_tpu_torch.training import profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("times,skip", [([0.5, 0.2, 0.3, 0.25, 0.9], 1), ([0.1], 1), ([], 0),
                                        ([0.3, 0.1, 0.2], 0)])
def test_step_timer_matches_jax(times, skip):
    got, want = profiling.StepTimer(), jax_profiling.StepTimer()
    got.times, want.times = list(times), list(times)
    assert got.stats(skip) == want.stats(skip)
    timer = profiling.StepTimer()
    for _ in range(3):
        timer.tick()
    assert len(timer.times) == 2 and all(t >= 0 for t in timer.times)


def nested(nan=float("nan"), inf=float("inf")):
    """The same nesting in numpy (for JAX) and torch: dicts (a state_dict's
    dotted keys among them), lists, tuples, scalars, None."""
    return (
        {"params": {"input_blocks.0.0.weight": np.ones((2, 2), np.float32),
                    "out.2.bias": np.array([inf], np.float32)},
         "opt": [np.zeros(3, np.float32), (np.array([1.0, nan]), 2.0)],
         "steps": np.arange(3), "none": None, "loss": nan},
        {"params": {"input_blocks.0.0.weight": torch.ones(2, 2),
                    "out.2.bias": torch.tensor([inf])},
         "opt": [torch.zeros(3), (torch.tensor([1.0, nan], dtype=torch.float64), 2.0)],
         "steps": torch.arange(3), "none": None, "loss": nan},
    )


def test_find_nonfinite_matches_jax():
    jax_tree, torch_tree = nested()
    want = jax_profiling.find_nonfinite(jax_tree)
    assert want == ["['loss']", "['opt'][1][0]", "['params']['out.2.bias']"]
    assert profiling.find_nonfinite(torch_tree) == want
    clean_jax, clean_torch = nested(nan=0.0, inf=1.0)
    assert profiling.find_nonfinite(clean_torch) == jax_profiling.find_nonfinite(clean_jax) == []
    assert profiling.find_nonfinite(torch.tensor([float("nan")])) == \
        jax_profiling.find_nonfinite(np.array([np.nan])) == [""]
    profiling.check_finite(clean_torch)
    with pytest.raises(FloatingPointError, match=r"in step 7: \[\"\['loss'\]\""):
        profiling.check_finite(torch_tree, "step 7")


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_compiled_cost_counts_conv_flops_as_xla(padding):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 8, 8, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4, 6)).astype(np.float32)
    want = jax_profiling.compiled_cost(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (1, 1, 1), padding, dimension_numbers=("NDHWC", "DHWIO", "NDHWC")),
        jnp.asarray(x), jnp.asarray(w))
    got = profiling.compiled_cost(
        lambda a, b: torch.nn.functional.conv3d(a, b, padding=1 if padding == "SAME" else 0),
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(w).permute(4, 3, 0, 1, 2))
    assert got["flops"] == want["flops"] > 0
    assert np.isnan(got["bytes_accessed"])


def test_compiled_cost_counts_matmul_flops_as_xla():
    a, b = np.ones((64, 96), np.float32), np.ones((96, 48), np.float32)
    want = jax_profiling.compiled_cost(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = profiling.compiled_cost(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 2 * 64 * 96 * 48


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


GROUP_OF = {
    "void conv3d_igemm_wgmma_kernel<128, 4>(CUtensorMap, CUtensorMap, ConvArgs)":
        "K5 implicit GEMM (bf16 and 3xTF32, forward and dgrad; K7-K9)",
    "void conv3d_tf32_kernel<192, 4>(CUtensorMap, CUtensorMap, CUtensorMap, ConvArgs)":
        "K5 implicit GEMM (bf16 and 3xTF32, forward and dgrad; K7-K9)",
    "tf32_split_kernel": "K5 implicit GEMM (bf16 and 3xTF32, forward and dgrad; K7-K9)",
    "void conv3d_variant_full_kernel<128>(CUtensorMap, CUtensorMap, ConvArgs)":
        "K5 implicit GEMM (bf16 and 3xTF32, forward and dgrad; K7-K9)",
    "conv3d_bigdot_im2col_kernel": "K5 implicit GEMM (bf16 and 3xTF32, forward and dgrad; K7-K9)",
    "void conv3d_direct_kernel<__nv_bfloat16, 1, 64, 16>(DirectArgs)":
        "direct conv (input conv, head, head dgrad)",
    "void conv3d_direct_kernel<float, 8, 16, 4>(DirectArgs)":
        "direct conv (input conv, head, head dgrad)",
    "void flash_fwd_wgmma_kernel<128, 2, 128>(CUtensorMap, CUtensorMap, CUtensorMap, FwdArgs)":
        "flash forward (K1/K2; K6 ring)",
    "void flash_fwd_tf32_split_kernel<128>(Tf32Problem)": "flash forward (K1/K2; K6 ring)",
    "void ring_attention_bf16_kernel(RingArgs)": "flash forward (K1/K2; K6 ring)",
    "void kv_split_kernel<64>(Tf32Problem)": "flash forward (K1/K2; K6 ring)",
    "void flash_bwd_wgmma_kernel<128>(BwdArgs)": "flash backward and its pre-passes (K3/K4)",
    "flash_bwd_delta_kernel": "flash backward and its pre-passes (K3/K4)",
    "void flash_bwd_tf32_split_kernel<128>(BwdArgs)": "flash backward and its pre-passes (K3/K4)",
    "void flash_bwd_dkv_bf16_kernel<32>(BwdArgs)": "flash backward and its pre-passes (K3/K4)",
    "sm90_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_ndhwc_kernel":
        "cuDNN weight gradients",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc_kernel":
        "other cuDNN convs (the strided Downsample)",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc_kernel":
        "other cuDNN convs (the strided Downsample)",
    "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(long, float)":
        "GroupNorm (PyTorch's own kernels)",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
    "(anonymous namespace)::TensorListMetadata<4>, at::native::(anonymous namespace)::"
    "FusedAdamMathFunctor<float, 4> >(...)": "optimizer and EMA (foreach, multi-tensor)",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas":
        "cuBLAS GEMMs",
    "nvjet_tst_128x64_64x8_2x1_v_bz_coopB_TNT": "cuBLAS GEMMs",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float>(...)": "cuBLAS GEMMs",
    "void at::native::vectorized_elementwise_kernel<4, at::native::bfloat16_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, ...)":
        "casts and copies",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda()#3}>(int, ...)": "casts and copies",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>(...)": "casts and copies",
    "Memcpy DtoD (Device -> Device)": "casts and copies",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<"
    "float, float, float, float>, unsigned int, float, 4, 4> >(...)": "reductions",
    "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
    "silu_kernel(at::TensorIteratorBase&)::{lambda(c10::BFloat16)#1}, ...>(int, ...)":
        "SiLU and other elementwise",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, ...)": "SiLU and other elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
    "BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor<float> > >"
    "(...)>(int, ...)": "SiLU and other elementwise",
    "Memset (Device)": "other",
}


def test_each_kernel_name_falls_into_its_one_group():
    names = {g for g, _ in op_table.GROUPS} | {op_table.OTHER}
    assert set(GROUP_OF.values()) == names  # every group is reached
    for name, group in GROUP_OF.items():
        assert op_table.group_of(name) == group, name


def test_cpu_profile_groups_sum_to_the_total():
    kw = dict(data_shape=(8, 8, 8), dims=3, in_channels=1, out_channels=1, model_channels=16,
              num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=[2], num_heads=2,
              num_classes=20, use_scale_shift_norm=True)
    pipe = DDPM("UNetv2", kw, LinearSchedule(50), optimizer="AdamW", ema_decay=0.99,
                device="cpu", seed=0)
    state = pipe.create_state(0)
    rng = np.random.default_rng(0)
    batch = {"data": torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 8, 1)).astype(np.float32)),
             "labels": torch.from_numpy(rng.uniform(0, 1, (2, 64)).astype(np.float32))}
    pipe.training_step(state, batch)
    with op_table.traced_scope(), profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.training_step(state, batch)
    table = op_table.op_table(prof.profiler.kineto_results.events())
    assert table["clock"] == "host" and table["window_ms"] > 0
    assert sum(g["ms"] for g in table["groups"]) == pytest.approx(table["window_ms"], rel=1e-9)
    assert sum(g["launches"] for g in table["groups"]) == table["launches"]
    assert sum(r["ms"] for r in table["top_ops"]) <= table["window_ms"] * (1 + 1e-9)
    scope = table["scopes"][op_table.SCOPE_NAME]
    assert 0 < scope["ms"] < table["window_ms"]
    # the statistics' reductions run in the forward; the backward's nodes
    # of its ops are found through autograd's sequence numbers
    assert {r["name"] for r in scope["by_group"]} >= {"reductions",
                                                      "SiLU and other elementwise"}
    assert sum(r["ms"] for r in scope["by_group"]) == pytest.approx(scope["ms"], rel=1e-9)


class FakeEvent:
    def __init__(self, name, device, annotation=False, ns=1000):
        self._name, self._device, self._annotation, self._ns = name, device, annotation, ns

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation

    def duration_ns(self):
        return self._ns


def test_device_time_leaves_out_annotation_spans():
    """A record_function range (the optimizer's step) also has a span on the
    device's timeline, over kernels already counted: the device time, and
    the op table's window, leave it out (and the table reports it)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [FakeEvent("Optimizer.step#AdamW.step", cuda, annotation=True, ns=5000),
              FakeEvent("multi_tensor_apply_kernel", cuda, ns=3000),
              FakeEvent("Memcpy DtoD (Device -> Device)", cuda, ns=1000),
              FakeEvent("aten::add_", cpu)]
    assert [e.name() for e in device_events(events)] == ["multi_tensor_apply_kernel",
                                                         "Memcpy DtoD (Device -> Device)"]


def test_op_table_entry_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        op_table.main([])
