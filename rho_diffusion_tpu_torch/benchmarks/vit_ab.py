"""ViT against UNet on the 16^3 Y_lm harness at matched wall clock.

The port's counterpart of ``benchmarks/vit_ab.py``. Both backbones are
trained conditionally (sha512 rows of width 256: the UNet's 4 x width and
the ViT's condition input) as DDPMs (AdamW at 1e-4, EMA 0.9999, seed 777)
for the same wall-clock budget, timed from the end of each one's first
step; then each samples the condition-matched batch from its EMA weights by
DDIM-50 and dpm++-10, scored by matched-condition MSE and the Sinkhorn
divergence against the true fields. The report gives the steps each
backbone reached in the budget, beside its quality: a launch-bound step
favours the backbone that launches less.

The ViT is the JAX script's: patch 4 over 16^3 (64 tokens), embedding 256
over 8 heads (head dim 32: the port's narrow forward and small backward
kernels), hidden 512, depth 8, bf16.

    python -m rho_diffusion_tpu_torch.benchmarks.vit_ab [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``VIT_AB_GRID`` (16), ``VIT_AB_BATCH`` (8), ``VIT_AB_WALL`` (420
seconds a backbone; 1 with ``VIT_AB_SMOKE=1``), and ``_ylm``'s
``VIT_AB_SMOKE`` (the ViT cut to patch 2, embedding 64, hidden 128, depth
2, 4 heads, fp32) and ``YLM_MAX_STEPS``. Writes ``<work-dir>/vit_ab.json``.
"""
from __future__ import annotations

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader
from rho_diffusion_tpu_torch.diffusion import DDPM

NAME = "vit_ab"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "batch", "wall_budget_s", "backbones", "noise_matched_mse")
EMB = 256  # sha512 row width == the UNet's 4 x width == the ViT's condition input
SAMPLERS = (("ddim", 50), ("dpm++", 10))
VIT = dict(patch_size=4, num_channels=1, embedding_dim=256, hidden_dim=512,
           transformer_depth=8, num_heads=8, dropout=0.0, num_classes=20, dtype="bfloat16")
VIT_SMOKE_CUT = dict(patch_size=2, embedding_dim=64, hidden_dim=128, transformer_depth=2,
                     num_heads=4, dtype="float32")


def settings() -> dict:
    smoke = _ylm.is_smoke("VIT_AB")
    return {"smoke": smoke,
            "grid": _ylm.knob("VIT_AB_GRID", _ylm.SMOKE_GRID if smoke else 16),
            "batch": _ylm.knob("VIT_AB_BATCH", 8),
            "wall": _ylm.knob("VIT_AB_WALL", 1.0 if smoke else 420.0)}


def backbones(grid: int, smoke: bool) -> dict:
    vit = dict(VIT, input_shapes=(grid,) * 3, **(VIT_SMOKE_CUT if smoke else {}))
    return {"unet": ("UNetv2", _ylm.backbone_kwargs(grid, smoke)),
            "vit": ("VisionTransformer", vit)}


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    device, grid, batch = args.device, s["grid"], s["batch"]
    dset = _ylm.dataset(grid, 1_000_000, cache_fields=True)
    pairs = _ylm.physical_pairs(batch)
    conds = _ylm.condition_rows(pairs, EMB)
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, pairs))

    report = {"grid": grid, "batch": batch, "wall_budget_s": s["wall"], "backbones": {},
              "device": args.device_line, "train_steps_per_s": {}}
    for name, (bb, kwargs) in backbones(grid, s["smoke"]).items():
        pipe = DDPM(backbone=bb, backbone_kwargs=kwargs, schedule=_ylm.schedule(s["smoke"]),
                    optimizer="AdamW", opt_kwargs={"lr": 1e-4}, ema_decay=0.9999,
                    device=device, seed=_ylm.INIT_SEED)
        state = pipe.create_state(_ylm.INIT_SEED)
        trained = _ylm.train_for_wall(pipe, state,
                                      DataLoader(dset, batch_size=batch, num_workers=2),
                                      s["wall"])
        steps, wall, sps = trained["steps"], trained["wall_s"], trained["steps_per_s"]
        report["train_steps_per_s"][name] = sps
        print(f"{name}: {steps} steps in {wall:.0f}s ({sps:.2f} steps/s), "
              f"final loss {trained['final_loss']:.4f}", flush=True)

        sampler_pipe = _ylm.sampling_pipeline(bb, kwargs, _ylm.ema_weights(state), device,
                                              smoke=s["smoke"])
        rows = {}
        for sampler, nfe in SAMPLERS:
            nfe = _ylm.max_steps(nfe)
            gen = _ylm.sample(sampler_pipe, batch, conds, sampler=sampler, num_steps=nfe)
            rows[f"{sampler}_{nfe}"] = scorer(gen)
            print(f"  {name} {sampler}-{nfe}: {rows[f'{sampler}_{nfe}']}", flush=True)
        report["backbones"][name] = {
            "steps": steps, "wall_s": round(wall, 1),
            "steps_per_sec": round(sps, 2), "final_train_loss": trained["final_loss"],
            "params_m": round(sum(p.numel() for p in state.model.parameters()) / 1e6, 2),
            "samplers": rows,
        }
        del pipe, state, sampler_pipe

    report["noise_matched_mse"] = scorer.noise()["matched_mse"]
    return _ylm.write_report(args.work_dir, f"{NAME}.json", report)


if __name__ == "__main__":
    main()
