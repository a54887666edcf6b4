"""Sampling service: per-bucket samplers, request batching, pipelined pulls.

Port of ``rho_diffusion_tpu/serving.py`` (``GenerationResult``, ``_Chunk``,
``_Assembly``, ``SamplingService`` :57-729 and ``make_http_handler``
:732-817):

* **Buckets** — requests are quantised onto a small ladder of batch sizes
  (``batch_buckets``, the tail padded). The JAX package jits one program per
  bucket; PyTorch runs eagerly, so a bucket's sampler is a closure, built
  once. ``warmup=True`` runs every bucket once in the constructor, so a
  broken service fails there and not on its first request.
* **Micro-batching** — a worker thread coalesces concurrent requests (for
  up to ``max_delay_s``) into one launch; an oversized request is split
  across launches and reassembled.
* **Pipelined pulls** — on the card the worker enqueues each launch on a
  CUDA stream of its own and records an event after it; a pull thread waits
  on that event and copies the samples to pinned host memory, while the
  worker coalesces and enqueues the next launch. At most 2 launches are in
  flight. ``transfer_dtype`` narrows only the pulled output.
* **Request-deterministic noise** — x_T and every step's noise come from
  per-row streams keyed by (request seed, row index)
  (``diffusion.sampling_rng``): a request's samples do not depend on its
  co-batched neighbours, its padding or its split. On the CPU, where each
  row of a launch samples on its own, the results are bitwise the same
  alone and batched; on the card the UNet's cuBLAS
  matmuls may pick another algorithm at another batch size, so a row may
  differ by rounding (chip_smoke.py reports the difference).
* **A context mesh** — under a ``("data", "context")`` mesh with
  context > 1 every launch runs under ``active_mesh``, so the UNet's
  attention runs as ring attention over the context ranks (with
  ``RHO_RING_ATTN_IMPL=rdma``, the kernel K6). The UNet itself runs on the
  mesh's first device: only attention is sharded. The JAX package also
  shards the volume depth of every conv over the context axis (GSPMD halo
  convs, :568-586): the numbers are the same, the memory per card is not.
  Depth-sharded convs, and a data axis > 1 (one model replica per card),
  raise until ROADMAP Queue 1 item 13; int8 serving (``quantize``) until
  item 11.

Typical use::

    service = SamplingService.from_config("config.json", checkpoint="model.pth")
    fut = service.submit(conditions=rows, seed=123)
    volumes = fut.result().samples            # np.ndarray [n, *grid, C]

or over HTTP via ``python -m rho_diffusion_tpu_torch.serve``.
"""
from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from rho_diffusion_tpu_torch.diffusion.sampling_rng import keys_from_seeds
from rho_diffusion_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS,
    DATA_AXIS,
    active_mesh,
    canonical_device,
)

_NARROW = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass
class GenerationResult:
    """One fulfilled request."""

    samples: np.ndarray  # [n, *data_shape, out_channels]
    latency_s: float  # enqueue -> fulfilment wall-clock
    bucket: int  # batch size of the launch the request rode in
    batch_occupancy: float  # real samples / bucket for that launch


@dataclass
class _Chunk:
    """A request (or a split piece of one) awaiting a launch."""

    conditions: Optional[np.ndarray]  # [n, cond_dim] or None
    seed: int  # request seed; row i's noise streams are (seed, offset + i)
    n: int
    enqueued_at: float
    assembly: "_Assembly"
    offset: int  # row offset of this chunk inside its request


class _Assembly:
    """Collects chunk outputs back into one request-ordered result."""

    def __init__(self, total: int, future: Future) -> None:
        self.total = total
        self.future = future
        self.parts: list[tuple[int, np.ndarray, int, float]] = []
        self.lock = threading.Lock()

    def deliver(self, offset: int, samples: np.ndarray, bucket: int, occupancy: float,
                enqueued_at: float) -> None:
        with self.lock:
            self.parts.append((offset, samples, bucket, occupancy))
            done = sum(p[1].shape[0] for p in self.parts) >= self.total
        if done and not self.future.done():
            self.parts.sort(key=lambda p: p[0])
            self.future.set_result(GenerationResult(
                samples=np.concatenate([p[1] for p in self.parts], axis=0),
                latency_s=time.perf_counter() - enqueued_at,
                bucket=max(p[2] for p in self.parts),
                batch_occupancy=min(p[3] for p in self.parts),
            ))

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)


class _WeightsOnly:
    """Catches the state_dict that ``resolve_inference_params`` loads; the
    served backbone is the template it checks the weights against."""

    state_dict = None

    def __init__(self, backbone) -> None:
        self.backbone = backbone

    def load_state_dict(self, state_dict: dict, strict: bool = True) -> None:
        self.state_dict = state_dict


class SamplingService:
    """Always-on generation service around one diffusion pipeline.

    ``pipeline`` is a constructed port pipeline (``DDPM`` or
    ``GaussianDiffusionPipeline``) on its device; ``params`` an optional
    state_dict to serve (else the pipeline's current weights). A
    GaussianDiffusion pipeline samples with ``sampler`` ('ddim' by default,
    'ddpm' or a registered solver) over ``num_steps`` respaced steps on the
    grid ``spacing`` (None: the pipeline's sampler-aware default), DDIM
    with ``eta``. The DDPM pipeline always samples ancestrally over its full
    schedule, as in JAX: it ignores ``sampler``, ``num_steps`` and ``eta``,
    and rejects ``spacing``. ``cond_dim`` is the width of the condition
    rows, None for an unconditional service. ``mesh`` is a
    ``parallel.mesh.Mesh`` whose first device is the pipeline's (see the
    module docstring). The other arguments are the JAX package's.
    """

    def __init__(
        self,
        pipeline,
        params: Optional[dict] = None,
        *,
        sampler: str = "ddim",
        num_steps: Optional[int] = 50,
        spacing: Optional[str] = None,
        eta: float = 0.0,
        guidance_scale: Optional[float] = None,
        cond_dim: Optional[int] = None,
        batch_buckets: Sequence[int] = (1, 2, 4, 8),
        max_delay_s: float = 0.002,
        warmup: bool = False,
        mesh=None,
        transfer_dtype: Optional[str] = None,
        quantize: Optional[str] = None,
    ) -> None:
        if quantize is not None:
            raise NotImplementedError(
                f"quantize={quantize!r}: int8 W8A8 serving is not ported yet "
                "(ROADMAP Queue 1 item 11)",
            )
        if transfer_dtype is not None and str(transfer_dtype) not in _NARROW:
            raise ValueError(
                f"transfer_dtype must be 'bfloat16' or 'float16' (or None for exact "
                f"float32 transfers), got {transfer_dtype!r}",
            )
        self.transfer_dtype = None if transfer_dtype is None else str(transfer_dtype)
        if not batch_buckets or list(batch_buckets) != sorted(set(batch_buckets)):
            raise ValueError(f"batch_buckets must be ascending and unique, got {batch_buckets!r}")
        self.device = pipeline.device
        if mesh is not None:
            if mesh.shape[DATA_AXIS] > 1:
                raise NotImplementedError(
                    f"mesh {mesh.shape}: a data axis > 1 (one model replica per card) is not "
                    "ported yet (ROADMAP Queue 1 item 13); serve with data=1",
                )
            first = mesh.devices[0][0]
            if first != canonical_device(self.device):
                raise ValueError(f"the pipeline runs on {self.device}, but the mesh's first "
                                 f"device is {first}: the UNet runs on the mesh's first device")
        self.mesh = mesh
        if spacing is not None and not hasattr(pipeline, "coeffs"):
            raise ValueError(
                "spacing is a GaussianDiffusion-family respacing control; "
                "the DDPM pipeline always samples its full schedule",
            )
        if guidance_scale is not None and float(guidance_scale) != 1.0 and cond_dim is None:
            raise ValueError(
                f"guidance_scale={guidance_scale} requires a conditional service (cond_dim is None)",
            )
        self.pipeline = pipeline
        self.sampler = sampler
        self.num_steps = num_steps
        self.spacing = spacing
        self.eta = eta
        self.guidance_scale = guidance_scale
        self.cond_dim = cond_dim
        self.buckets = tuple(int(b) for b in batch_buckets)
        self.max_delay_s = float(max_delay_s)
        cuda = self.device.type == "cuda"
        # the worker's launches, and the pulls' copies, each on a stream of its own
        self._stream = torch.cuda.Stream(device=self.device) if cuda else None
        self._pull_stream = torch.cuda.Stream(device=self.device) if cuda else None
        # held while a launch is enqueued and while weights are swapped
        self._launch_lock = threading.Lock()
        if params is not None:
            self.update_params(params)
        self._compiled: dict[int, object] = {}
        self._queue: queue.Queue[Optional[_Chunk]] = queue.Queue()
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "samples": 0, "launches": 0, "occupancy_sum": 0.0,
                       "latencies_s": []}
        self._closed = False
        self._lifecycle_lock = threading.Lock()
        self._pull_queue: queue.Queue = queue.Queue(maxsize=2)
        if warmup:
            # run every bucket once, so a broken sampler (shape error, OOM,
            # missing conditioning) fails the constructor
            for b in self.buckets:
                conds = np.zeros((b, cond_dim), np.float32) if cond_dim else None
                out, event = self._run(self._get_compiled(b), [0] * b, list(range(b)), conds)
                if event is not None:
                    event.synchronize()
        self._worker = threading.Thread(target=self._worker_loop, name="sampling-service",
                                        daemon=True)
        self._worker.start()
        self._puller = threading.Thread(target=self._pull_loop, name="sampling-service-pull",
                                        daemon=True)
        self._puller.start()

    # -- construction helpers -----------------------------------------
    @classmethod
    def from_config(
        cls,
        config_path: str | Path,
        checkpoint: str | Path | None = None,
        log=print,
        device=None,
        work_dir: str | Path = ".",
        **service_kwargs,
    ) -> "SamplingService":
        """Build the pipeline and its weights as the inference CLI does
        (``inference.build_inference_session``), on ``device`` (default:
        the mesh's first device, else the config's inference device, which
        means CUDA). ``cond_dim`` is derived from the model config when not
        given: the parameter-row width for a MultiEmbeddings cond_fn, the
        hash-embedding width (4 * model_channels) otherwise."""
        from rho_diffusion_tpu_torch.config import ExperimentConfig
        from rho_diffusion_tpu_torch.inference import build_inference_session
        from rho_diffusion_tpu_torch.utils import resolve_device

        config = ExperimentConfig.from_json(config_path)
        mesh = service_kwargs.get("mesh")
        if device is None and mesh is not None:
            device = mesh.devices[0][0]
        device = resolve_device(device or config.inference.device)
        pipeline, dataset, messages = build_inference_session(
            config, checkpoint=checkpoint or config.inference.checkpoint, work_dir=work_dir,
            device=device,
        )
        for m in messages:
            log(m)
        if "cond_dim" not in service_kwargs:
            mk = dict(config.model.kwargs)
            if mk.get("num_classes"):
                space = getattr(dataset, "parameter_space", None)
                if space is not None and isinstance(mk.get("cond_fn"), str):
                    service_kwargs["cond_dim"] = len(space)  # raw rows through MultiEmbeddings
                else:
                    service_kwargs["cond_dim"] = 4 * mk.get("model_channels", 64)
        service_kwargs.setdefault("sampler", config.inference.sampler)
        service_kwargs.setdefault("num_steps", config.inference.ddim_steps or None)
        service_kwargs.setdefault("spacing", config.inference.spacing)
        service_kwargs.setdefault("guidance_scale", config.inference.guidance_scale)
        service = cls(pipeline, **service_kwargs)
        service._config = config  # enables reload_from_checkpoint
        service._work_dir = work_dir
        return service

    # -- public API ----------------------------------------------------
    def submit(self, conditions: Optional[np.ndarray] = None, n: Optional[int] = None,
               seed: int = 0) -> Future:
        """Enqueue a generation request; returns a Future[GenerationResult].

        ``conditions`` is [n, cond_dim] (or None for an unconditional
        service); ``n`` defaults to ``len(conditions)`` (or 1). The request
        is deterministic in ``seed`` (per-row noise streams)."""
        if conditions is not None:
            conditions = np.asarray(conditions, np.float32)
            if conditions.ndim == 1:
                conditions = conditions[None]
            if self.cond_dim is None:
                raise ValueError("unconditional service (cond_dim=None) got conditions")
            if conditions.shape[-1] != self.cond_dim:
                raise ValueError(f"conditions last dim {conditions.shape[-1]} != service "
                                 f"cond_dim {self.cond_dim}")
            n = conditions.shape[0] if n is None else n
            if conditions.shape[0] != n:
                raise ValueError(f"n={n} but {conditions.shape[0]} condition rows given")
        elif self.cond_dim is not None:
            raise ValueError(f"conditional service (cond_dim={self.cond_dim}) needs condition rows")
        else:
            n = 1 if n is None else n
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        future: Future = Future()
        assembly = _Assembly(n, future)
        now = time.perf_counter()
        max_bucket = self.buckets[-1]
        # closed-check and enqueue under one lock, so a concurrent close()
        # cannot strand chunks in a queue nobody drains
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("service is closed")
            with self._stats_lock:
                self._stats["requests"] += 1
                self._stats["samples"] += n
            for off in range(0, n, max_bucket):
                m = min(max_bucket, n - off)
                self._queue.put(_Chunk(
                    conditions=conditions[off:off + m] if conditions is not None else None,
                    seed=seed, n=m, enqueued_at=now, assembly=assembly, offset=off,
                ))
        return future

    def generate(self, conditions=None, n=None, seed: int = 0) -> GenerationResult:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(conditions, n, seed).result()

    def update_params(self, params: dict) -> None:
        """Serve the weights of ``params`` (a reference-layout state_dict).
        The copy is enqueued on the worker's stream between launches:
        launches already enqueued finish on the old weights, the next one
        reads the new ones."""
        with self._launch_lock, self._on_stream(self._stream):
            self.pipeline.backbone.load_state_dict(params)

    def reload_from_checkpoint(self, checkpoint=None) -> list[str]:
        """Re-resolve the weights (a ``.pth``/``.npz`` file or a checkpoint
        directory of the port's trainer, EMA per ``inference.use_ema``) and
        serve them. Only for services built by :meth:`from_config`."""
        config = getattr(self, "_config", None)
        if config is None:
            raise RuntimeError("reload_from_checkpoint needs a from_config-built service; "
                               "call update_params(params) directly instead")
        from rho_diffusion_tpu_torch.training.checkpoint import resolve_inference_params

        caught = _WeightsOnly(self.pipeline.backbone)
        messages = resolve_inference_params(caught, config, checkpoint or config.inference.checkpoint,
                                            self._work_dir)
        if caught.state_dict is not None:
            self.update_params(caught.state_dict)
        return messages

    def stats(self) -> dict:
        """Service counters: requests/samples/launches, mean batch
        occupancy, latency p50/p95 (seconds)."""
        with self._stats_lock:
            lat = sorted(self._stats["latencies_s"])
            launches = self._stats["launches"]
            return {
                "requests": self._stats["requests"],
                "samples": self._stats["samples"],
                "launches": launches,
                "mean_occupancy": self._stats["occupancy_sum"] / launches if launches else 0.0,
                "latency_p50_s": lat[len(lat) // 2] if lat else 0.0,
                "latency_p95_s": lat[int(len(lat) * 0.95)] if lat else 0.0,
                "buckets": list(self.buckets),
                "compiled_buckets": sorted(self._compiled),
                "sampler": self.sampler,
                "num_steps": self.num_steps,
                "spacing": self.spacing,
                "device": str(self.device),
                "mesh": None if self.mesh is None else self.mesh.shape,
            }

    def close(self) -> None:
        """Stop the worker; queued-but-unlaunched requests fail cleanly
        (the worker drains the queue when it sees the sentinel)."""
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=30)
        self._puller.join(timeout=30)

    def __enter__(self) -> "SamplingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- internals -----------------------------------------------------
    @staticmethod
    def _on_stream(stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _get_compiled(self, bucket: int):
        """The sampler of one bucket: (seeds, row indices, condition rows)
        -> samples on the device, narrowed to ``transfer_dtype``."""
        fn = self._compiled.get(bucket)
        if fn is not None:
            return fn
        pipeline, mesh, guidance = self.pipeline, self.mesh, self.guidance_scale
        shape = pipeline.sample_shape(bucket)
        narrow = _NARROW.get(self.transfer_dtype)
        if mesh is not None and mesh.shape[CONTEXT_AXIS] <= 1:
            mesh = None

        # On the CPU each row of a launch samples on its own: oneDNN and the
        # CPU BLAS pick their algorithm by batch size, so a row's last bits
        # would otherwise depend on its neighbours. Row by row, a request is
        # bitwise the same alone and co-batched, as JAX's contract holds.
        rows = [1] * bucket if self.device.type == "cpu" else [bucket]

        if hasattr(pipeline, "coeffs"):  # the GaussianDiffusion family
            opts = dict(sampler=self.sampler, eta=self.eta, num_steps=self.num_steps,
                        spacing=self.spacing, t_checkpoints=())

            def sample(shape, conds, keys):
                return pipeline.reverse_process(shape, conds, row_keys=keys,
                                                guidance_scale=guidance, **opts)
        else:  # DDPM: ancestral over the full schedule
            def sample(shape, conds, keys):
                return pipeline.reverse_process(shape, conds, row_keys=keys,
                                                guidance_scale=guidance)["denoised"]

        def fn(seeds, idxs, conds):
            keys = keys_from_seeds(seeds, idxs)
            outs, at = [], 0
            with active_mesh(mesh):
                for m in rows:
                    outs.append(sample((m, *shape[1:]), None if conds is None
                                       else conds[at:at + m], keys[at:at + m]))
                    at += m
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
            return out.to(narrow) if narrow is not None else out

        self._compiled[bucket] = fn
        return fn

    def _run(self, fn, seeds, idxs, conds):
        """Enqueue one launch on the worker's stream; returns the device
        output and an event recorded after it (None on the CPU)."""
        with self._launch_lock, self._on_stream(self._stream):
            conds_t = None if conds is None else torch.from_numpy(conds).to(self.device)
            out = fn(seeds, idxs, conds_t)
            event = None
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(self._stream)
        return out, event

    def _pick_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _launch(self, chunks: list[_Chunk]) -> None:
        total = sum(c.n for c in chunks)
        bucket = self._pick_bucket(total)
        try:
            pad = bucket - total
            # per-row noise identities; pad rows reuse (seed 0, row 0..) and
            # are discarded
            seeds = [c.seed for c in chunks for _ in range(c.n)] + [0] * pad
            idxs = [i for c in chunks for i in range(c.offset, c.offset + c.n)] + list(range(pad))
            conds = None
            if self.cond_dim is not None:
                conds = np.concatenate([c.conditions for c in chunks]
                                       + [np.zeros((pad, self.cond_dim), np.float32)])
                conds = conds.astype(np.float32)
            out, event = self._run(self._get_compiled(bucket), seeds, idxs, conds)
        except Exception as exc:
            # the worker thread itself must never die
            for c in chunks:
                c.assembly.fail(exc)
            return
        self._pull_queue.put((out, event, chunks, bucket, total / bucket))

    def _deliver(self, dev_out, event, chunks, bucket, occupancy) -> None:
        try:
            if event is not None:
                event.synchronize()
                host = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
                with self._on_stream(self._pull_stream):
                    host.copy_(dev_out)
            else:
                host = dev_out
            # widen a narrowed transfer back to the float32 the API promises
            out = host.float().numpy()
        except Exception as exc:
            for c in chunks:
                c.assembly.fail(exc)
            return
        now = time.perf_counter()
        # stats before resolving futures: a caller unblocked by its result
        # sees this launch counted
        with self._stats_lock:
            self._stats["launches"] += 1
            self._stats["occupancy_sum"] += occupancy
            for c in chunks:
                self._stats["latencies_s"].append(now - c.enqueued_at)
            if len(self._stats["latencies_s"]) > 10_000:
                self._stats["latencies_s"] = self._stats["latencies_s"][-5_000:]
        off = 0
        for c in chunks:
            c.assembly.deliver(c.offset, out[off:off + c.n], bucket, occupancy, c.enqueued_at)
            off += c.n

    def _pull_loop(self) -> None:
        while True:
            item = self._pull_queue.get()
            if item is None:
                return
            try:
                self._deliver(*item)
            except Exception as exc:
                # the pull thread must never die: the bounded pull queue
                # would back the worker up and deadlock the service
                for c in item[2]:
                    try:
                        c.assembly.fail(exc)
                    except Exception:
                        pass

    def _worker_loop(self) -> None:
        try:
            self._worker_loop_inner()
        finally:
            # the worker is the only producer of pulls: its sentinel lands
            # after every launch, so the pull thread drains them first
            self._pull_queue.put(None)

    def _worker_loop_inner(self) -> None:
        max_bucket = self.buckets[-1]
        while True:
            chunk = self._queue.get()
            if chunk is None:
                return
            batch, total = [chunk], chunk.n
            deadline = time.perf_counter() + self.max_delay_s
            # coalesce until the biggest bucket is full or the window closes
            while total < max_bucket:
                try:
                    nxt = self._queue.get(timeout=max(deadline - time.perf_counter(), 0.0))
                except queue.Empty:
                    break
                if nxt is None:
                    # sentinel: submit-after-close raises, so `batch` is the
                    # only remaining work
                    self._launch(batch)
                    return
                if total + nxt.n > max_bucket:
                    self._launch(batch)
                    batch, total = [nxt], nxt.n
                    deadline = time.perf_counter() + self.max_delay_s
                    continue
                batch.append(nxt)
                total += nxt.n
            self._launch(batch)


def make_http_handler(service: SamplingService):
    """An ``http.server`` handler class bound to ``service``.

    Endpoints:
      GET  /healthz  -> {"ok": true}
      GET  /stats    -> service.stats()
      POST /generate -> body {"conditions": [[...]] | null, "n": int,
                        "seed": int, "return": "list" | "stats"}
                        reply {"shape": [...], "samples": nested list,
                        "latency_s": float, "bucket": int}
      POST /reload   -> body {"checkpoint": path | null}: re-resolve and
                        swap the served weights
    ``return: "stats"`` omits the sample payload (for load tests)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self) -> None:  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self) -> None:  # noqa: N802
            if self.path == "/reload":
                try:
                    messages = service.reload_from_checkpoint(self._body().get("checkpoint"))
                except RuntimeError as exc:
                    self._reply(400, {"error": str(exc)})
                    return
                except Exception as exc:
                    self._reply(500, {"error": str(exc)})
                    return
                self._reply(200, {"ok": True, "messages": messages})
                return
            if self.path != "/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                req = self._body()
                conds = req.get("conditions")
                conds = np.asarray(conds, np.float32) if conds is not None else None
                n = req.get("n")
                seed = int(req.get("seed", 0))
            except Exception as exc:  # malformed JSON or fields
                self._reply(400, {"error": str(exc)})
                return
            try:
                result = service.generate(conditions=conds, n=n, seed=seed)
            except ValueError as exc:  # request validation (submit)
                self._reply(400, {"error": str(exc)})
                return
            except Exception as exc:  # a device or sampler fault
                self._reply(500, {"error": str(exc)})
                return
            payload = {"shape": list(result.samples.shape), "latency_s": result.latency_s,
                       "bucket": result.bucket}
            if req.get("return", "list") == "list":
                payload["samples"] = result.samples.astype(float).tolist()
            self._reply(200, payload)

        def log_message(self, *args) -> None:  # quiet by default
            pass

    return Handler
