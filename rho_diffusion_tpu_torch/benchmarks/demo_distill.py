"""Progressive distillation of a trained teacher on the Y_lm harness.

The port's counterpart of ``benchmarks/demo_distill.py``. It trains the
conditional 3-D Y_lm GaussianDiffusion pipeline (epsilon, fixed_small,
AdamW at 2e-4, EMA 0.9999), then distills its EMA weights DEMO_FROM ->
... -> DEMO_TO sampling steps (``diffusion.distill.ProgressiveDistiller``,
Salimans & Ho, arXiv:2202.00512; each stage DEMO_UPDATES updates over
cycled epochs of the dataset, its draws from one generator seeded 99) and
scores each student at its budget against the teacher DDIM-strided to the
same budget: matched-condition MSE and the Sinkhorn divergence against the
true fields (distillation must beat plain striding at equal model calls).
Each sample is timed on its second run. With ``DEMO_SERVE`` (default 1) it
then serves the final student (its trailing grid) and the teacher's
dpm++-10 and DDIM-50 through ``serving.SamplingService`` at one bucket of
BATCH rows (per-row noise from the request's seed), each request's wall
and quality. The teacher's and the student's weights are saved in the
work dir.

    python -m rho_diffusion_tpu_torch.benchmarks.demo_distill [-d cuda|cpu]
        [--work-dir DIR]

Knobs: ``DEMO_GRID`` (16), ``DEMO_BATCH`` (16), ``DEMO_STEPS`` (1200; 2
with ``DEMO_SMOKE=1``), ``DEMO_FROM`` (32; 8 with ``DEMO_SMOKE=1``, whose
schedule has 20 steps), ``DEMO_TO`` (2),
``DEMO_UPDATES`` (300 a stage; 2 with ``DEMO_SMOKE=1``),
``DEMO_DISTILL_LR`` (3e-5), ``DEMO_SERVE`` (1), and ``_ylm``'s
``DEMO_SMOKE`` and ``YLM_MAX_STEPS`` (over the teacher's DDIM-50). Writes
``<work-dir>/demo_distill_metrics.json`` (``demo_distill_<GRID>_metrics.json``
off 16^3).
"""
from __future__ import annotations

import copy
import os
import time

import torch

from rho_diffusion_tpu_torch.benchmarks import _ylm
from rho_diffusion_tpu_torch.data.loader import DataLoader, prefetch_to_device
from rho_diffusion_tpu_torch.diffusion import GaussianDiffusionPipeline, ProgressiveDistiller
from rho_diffusion_tpu_torch.serving import SamplingService

NAME = "demo_distill"
# the JAX script's report keys (the port's report adds its own beside them)
REPORT_KEYS = ("grid", "batch", "teacher_steps", "from_steps", "to_steps", "updates_per_stage",
               "distill_lr", "train_wall_s", "teacher_ddim", "student",
               "stage_losses", "noise_baseline", "serving", "weights")
DISTILL_SEED = 99
DDIM_STEPS = 50


def settings() -> dict:
    smoke = _ylm.is_smoke("DEMO")
    return {"smoke": smoke, "grid": _ylm.knob("DEMO_GRID", _ylm.SMOKE_GRID if smoke else 16),
            "batch": _ylm.knob("DEMO_BATCH", 16),
            "steps": _ylm.knob("DEMO_STEPS", 2 if smoke else 1200),
            "from": _ylm.knob("DEMO_FROM", 8 if smoke else 32), "to": _ylm.knob("DEMO_TO", 2),
            "updates": _ylm.knob("DEMO_UPDATES", 2 if smoke else 300),
            "lr": _ylm.knob("DEMO_DISTILL_LR", 3e-5),
            "serve": bool(int(os.environ.get("DEMO_SERVE", "1")))}


def main(argv=None) -> dict:
    args = _ylm.parse(NAME, __doc__, argv)
    s = settings()
    device, grid, batch = args.device, s["grid"], s["batch"]
    kwargs = _ylm.backbone_kwargs(grid, s["smoke"])
    pipe = GaussianDiffusionPipeline(
        backbone="UNetv2", backbone_kwargs=kwargs, schedule=_ylm.schedule(s["smoke"]),
        model_mean_type="epsilon", model_var_type="fixed_small", optimizer="AdamW",
        opt_kwargs={"lr": 2e-4}, ema_decay=0.9999, device=device, seed=_ylm.INIT_SEED)
    state = pipe.create_state(_ylm.INIT_SEED)
    dset = _ylm.dataset(grid, max(batch * (s["steps"] + 8), 256))
    print(f"== teacher train: {s['steps']} steps, {grid}^3, b{batch}", flush=True)
    trained = _ylm.train(pipe, state, DataLoader(dset, batch_size=batch, num_workers=0),
                         s["steps"], log_every=200, tag="  ")
    # the teacher is the EMA weights; the pipeline's backbone carries them
    pipe.load_state_dict(_ylm.full_state_dict(pipe.backbone, _ylm.ema_weights(state)))
    teacher = copy.deepcopy(pipe.backbone).eval()
    del state

    # eval targets: the true fields of the first BATCH (l, m) pairs
    pairs = _ylm.physical_pairs(batch)
    conds = _ylm.condition_rows(pairs)
    scorer = _ylm.Scorer(_ylm.exact_fields(dset, pairs))
    shape = pipe.sample_shape(batch)
    cond_t = torch.as_tensor(conds, device=device)

    def twice(fn) -> dict:
        """fn's quality and the wall of its second run (the first builds
        and loads the kernels)."""
        fn()
        out, wall = _ylm.timed(fn, device)
        return {**scorer(out), "wall_s": round(wall, 3)}

    def eval_teacher_ddim(n: int) -> dict:
        return twice(lambda: _ylm.sample(pipe, batch, conds, sampler="ddim", num_steps=n))

    report = {
        "grid": grid, "batch": batch, "teacher_steps": s["steps"],
        "from_steps": s["from"], "to_steps": s["to"], "updates_per_stage": s["updates"],
        "distill_lr": s["lr"],
        "train_wall_s": round(trained["wall_s"], 1),
        "teacher_ddim": {}, "student": {}, "stage_losses": {},
        "device": args.device_line, "train_steps_per_s": trained["steps_per_s"],
    }
    print("== teacher DDIM striding baselines", flush=True)
    budgets = {_ylm.max_steps(DDIM_STEPS), s["from"]} | {
        n for n in (16, 8, 4, 2) if s["to"] <= n <= s["from"]}
    for n in sorted(budgets):
        report["teacher_ddim"][str(n)] = eval_teacher_ddim(n)
        print(f"  ddim-{n}: {report['teacher_ddim'][str(n)]}", flush=True)

    # the cascade; every student evaluated on its own trailing grid
    d = ProgressiveDistiller(pipe, opt_kwargs={"lr": s["lr"]})

    def epochs():
        while True:  # the cascade consumes stages x UPDATES batches: cycle epochs
            yield from prefetch_to_device(iter(DataLoader(dset, batch_size=batch,
                                                          num_workers=0)), device)

    data_iter = epochs()
    gen = torch.Generator(device=device).manual_seed(DISTILL_SEED)
    student, n = teacher, s["from"]
    while n > s["to"]:
        t1 = time.perf_counter()
        student, losses = d.distill_stage(student, lambda _i: next(data_iter), n, s["updates"],
                                          generator=gen)
        stage_wall = time.perf_counter() - t1
        n //= 2
        report["stage_losses"][f"{n * 2}->{n}"] = {
            "first": losses[0], "last": losses[-1], "min": min(losses),
            "wall_s": round(stage_wall, 1),
        }
        report["student"][str(n)] = twice(lambda: d.sample(
            student, shape, n_steps=n, conditions=cond_t,
            generator=torch.Generator(device=device).manual_seed(_ylm.SAMPLE_SEED)))
        print(f"== student {n}-step: {report['student'][str(n)]} "
              f"(stage {stage_wall:.0f}s, loss {losses[0]:.4f}->{losses[-1]:.4f})", flush=True)
    report["noise_baseline"] = scorer(_ylm.noise_like(scorer.real.shape))

    if s["serve"]:
        # the trailing grid is what the cascade trained on: the service's
        # spacing makes the student a serving config of its own
        def serve_row(label: str, module, **service_kw) -> dict:
            with SamplingService(pipe, module.state_dict(), batch_buckets=(batch,),
                                 max_delay_s=0.0, cond_dim=4 * _ylm.MC, warmup=True,
                                 **service_kw) as svc:
                svc.generate(conditions=conds, seed=_ylm.SAMPLE_SEED)  # warm
                t1 = time.perf_counter()
                res = svc.generate(conditions=conds, seed=_ylm.SAMPLE_SEED)
                wall = time.perf_counter() - t1
            row = {"s_per_request": round(wall, 3), "volumes_per_s": round(batch / wall, 2),
                   **scorer(res.samples)}
            print(f"  serve[{label}]: {row}", flush=True)
            return row

        ddim = _ylm.max_steps(DDIM_STEPS)
        print(f"== serving latency (batch bucket = {batch})", flush=True)
        report["serving"] = {
            f"student-ddim-{s['to']}-trailing": serve_row(
                f"student-{s['to']}", student, sampler="ddim", num_steps=s["to"],
                spacing="trailing"),
            "teacher-dpm++-10": serve_row("dpm++-10", teacher, sampler="dpm++", num_steps=10),
            f"teacher-ddim-{ddim}": serve_row(f"ddim-{ddim}", teacher, sampler="ddim",
                                              num_steps=ddim),
        }

    # the weights, servable from disk
    work = args.work_dir
    work.mkdir(parents=True, exist_ok=True)
    paths = {"teacher": work / f"distill_{grid}_teacher.pth",
             "student": work / f"distill_{grid}_student{s['to']}.pth"}
    torch.save(teacher.state_dict(), paths["teacher"])
    torch.save(student.state_dict(), paths["student"])
    report["weights"] = {k: str(v) for k, v in paths.items()}
    suffix = f"_{grid}" if grid != 16 else ""
    return _ylm.write_report(work, f"{NAME}{suffix}_metrics.json", report)


if __name__ == "__main__":
    main()
