"""Serve a diffusion model over HTTP with the PyTorch port.

    python -m rho_diffusion_tpu_torch.serve CONFIG.json [-p WEIGHTS] [-d cuda|cpu]
        [--port 8000] [--buckets 1,2,4,8] [--cond-dim W] [--warmup]
        [--sampler ddim] [--steps 50] [--spacing GRID]
        [--transfer-dtype bfloat16|float16] [--guidance S]
        [--data-parallel N] [--context-parallel M] [--mesh-devices LIST]

Port of ``scripts/serve.py`` (:25-138): the model is loaded and each
bucket's sampler built once, then concurrent requests are micro-batched
onto the card (``rho_diffusion_tpu_torch.serving``). Endpoints: GET
/healthz, GET /stats, POST /generate ``{"conditions": [[...]] | null, "n":
4, "seed": 7}``, POST /reload.

It runs on CUDA unless ``-d cpu`` is given, and raises without CUDA.
``--context-parallel M`` builds a ("data", "context") mesh of M context
ranks and the UNet's attention runs as ring attention over them
(``RHO_RING_ATTN_IMPL=rdma`` selects the kernel K6, default "xla"). The
ranks are every CUDA card, one each, unless ``--mesh-devices`` lists them
(one device per rank, repeats allowed: ``cuda:0,cuda:0,cuda:0,cuda:0`` puts
four ranks on one card); with ``-d cpu`` they are M ranks on the CPU. A
data axis > 1 and ``--quant`` raise (ROADMAP Queue 1 items 13 and 11).
``--sampler``, ``--steps`` and ``--spacing`` set the GaussianDiffusion
family's sampler, respaced step count and grid (over the config's
``inference.sampler``, ``inference.ddim_steps`` and ``inference.spacing``);
the DDPM pipeline ignores the first two and rejects ``--spacing``, as in
JAX.
"""
from __future__ import annotations

import argparse
from http.server import ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Sequence

from rho_diffusion_tpu_torch.parallel.mesh import make_mesh
from rho_diffusion_tpu_torch.serving import SamplingService, make_http_handler


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("json_config", type=Path)
    parser.add_argument("-p", dest="checkpoint", type=Path, default=None)
    parser.add_argument("-d", "--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--work-dir", type=Path, default=Path("."),
                        help="where <work-dir>/checkpoints is looked for without -p")
    parser.add_argument("--sampler", default=None, choices=["ddpm", "ddim", "dpm++", "unipc"],
                        help="GaussianDiffusion family only; the DDPM pipeline ignores it")
    parser.add_argument("--steps", type=int, default=None,
                        help="respaced sampling steps, GaussianDiffusion family only; the DDPM "
                             "pipeline ignores it")
    parser.add_argument("--spacing", default=None,
                        choices=["uniform-t", "uniform-lambda", "trailing", "karras"])
    parser.add_argument("--guidance", type=float, default=None,
                        help="classifier-free guidance scale (1.0 = off; needs a model "
                             "trained with cond_dropout > 0)")
    parser.add_argument("--buckets", default="1,2,4,8",
                        help="comma-separated batch sizes (ascending)")
    parser.add_argument("--cond-dim", type=int, default=None,
                        help="condition-row width; derived from the config when omitted")
    parser.add_argument("--warmup", action="store_true",
                        help="run every bucket once before accepting requests")
    parser.add_argument("--transfer-dtype", default=None, choices=["bfloat16", "float16"],
                        help="narrow the device->host sample transfer (the host widens back "
                             "to float32)")
    parser.add_argument("--quant", default=None, choices=["int8"],
                        help="int8 W8A8 convs (not ported yet: raises)")
    parser.add_argument("--data-parallel", type=int, default=0, metavar="N",
                        help="data axis of the mesh (only 1 is ported)")
    parser.add_argument("--context-parallel", type=int, default=1, metavar="M",
                        help="context ranks: the UNet's attention runs as ring attention "
                             "over M ranks")
    parser.add_argument("--mesh-devices", default=None,
                        help="comma-separated device of each mesh rank (default: every "
                             "CUDA card, or the CPU with -d cpu)")
    return parser.parse_args(argv)


def build_server(argv: Optional[Sequence[str]] = None, log=print):
    """Parse ``argv``, build the service and bind (not start) its HTTP
    server. Returns ``(server, service)``; the caller serves and, at the
    end, shuts both down."""
    args = parse_args(argv)
    kwargs: dict = {"batch_buckets": tuple(int(b) for b in args.buckets.split(",")),
                    "warmup": args.warmup}
    for key, value in (("sampler", args.sampler), ("num_steps", args.steps),
                       ("spacing", args.spacing), ("guidance_scale", args.guidance),
                       ("cond_dim", args.cond_dim), ("transfer_dtype", args.transfer_dtype),
                       ("quantize", args.quant)):
        if value is not None:
            kwargs[key] = value
    if args.data_parallel or args.context_parallel > 1:
        if args.mesh_devices:
            devices = args.mesh_devices.split(",")
        elif args.device == "cpu":
            devices = ["cpu"] * (max(args.data_parallel, 1) * args.context_parallel)
        else:
            devices = None  # every CUDA card
        kwargs["mesh"] = make_mesh(data=args.data_parallel or -1, context=args.context_parallel,
                                   devices=devices)
    service = SamplingService.from_config(args.json_config, checkpoint=args.checkpoint, log=log,
                                          device=args.device, work_dir=args.work_dir, **kwargs)
    try:
        server = ThreadingHTTPServer((args.host, args.port), make_http_handler(service))
    except Exception:
        service.close()
        raise
    stats = service.stats()
    log(f"serving on http://{args.host}:{server.server_address[1]} "
        f"(buckets={service.buckets}, sampler={stats['sampler']}, steps={stats['num_steps']}, "
        f"device={service.device}, mesh={stats['mesh']})")
    return server, service


def main(argv: Optional[Sequence[str]] = None) -> None:
    server, service = build_server(argv, log=lambda m: print(m, flush=True))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
