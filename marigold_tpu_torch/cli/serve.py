"""Persistent batched-serving daemon.

Counterpart of `marigold_tpu/cli/serve.py`, with its arguments, HTTP API
and output files: a long-lived process that keeps the weights on the
device, watches a directory (or processes it once with --once), groups
same-shape images into NI-image `batch_call` batches, and overlaps host
decode/save with device work by running up to `max_in_flight` batches on a
small thread pool.

Batches are grouped by input image shape; under-full groups older than
--batch_wait run at their actual size. An HTTP API (--http_port) feeds the
same buckets: POST an image to /v1/predict (?format=npy|png), GET /healthz.

Two batches in flight share one card. Each pool thread runs its whole batch
under its own CUDA stream, so the readback that ends batch A waits only for
A's kernels, never for kernels that batch B enqueued in between. The
streams read the same weights and write nothing shared: the empty-prompt
embedding is computed before the pool starts, the conv kernels' rearranged
weights (`models/layers.py:Conv2d.prepared_weight`) are filled under a lock
and published once their stream has finished them, and the kernel launch
counters take a lock (`ops/cuda_build.py:LaunchCounter`).

Usage:
  python -m marigold_tpu_torch.cli.serve --checkpoint CKPT --modality depth \
      --watch_dir IN --output_dir OUT [--once] [--batch_images 3] ...
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from marigold_tpu_torch.cli import add_device_argument, set_full_precision
from marigold_tpu_torch.cli.run import pipeline_class, save_one

EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--modality", type=str, default="depth",
                   choices=("depth", "normals", "iid"))
    p.add_argument("--watch_dir", type=str, required=True,
                   help="Directory to watch for input images")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--batch_images", type=int, default=3,
                   help="Images per batch (NI); the denoise batch is "
                        "NI*ensemble rows. The default is the JAX "
                        "package's (chosen there for the 768px E=10 "
                        "protocols)")
    p.add_argument("--max_in_flight", type=int, default=2,
                   help="Batches processed concurrently, each on its own "
                        "CUDA stream (overlaps host save/readback with "
                        "device work)")
    p.add_argument("--ensemble_size", type=int, default=10)
    p.add_argument("--denoise_steps", type=int, default=None)
    p.add_argument("--processing_res", type=int, default=None)
    p.add_argument("--poll_interval", type=float, default=0.5,
                   help="Seconds between directory scans")
    p.add_argument("--batch_wait", type=float, default=2.0,
                   help="Max seconds to hold an under-full batch before "
                        "running it at its actual size")
    p.add_argument("--read_retry_window", type=float, default=None,
                   help="Seconds an unreadable file (e.g. an upload in "
                        "progress) keeps being retried before it is "
                        "skipped for good (default max(30, 4*batch_wait))")
    p.add_argument("--http_max_body_mb", type=int, default=64,
                   help="Reject POST bodies larger than this (413): a "
                        "single unbounded upload would otherwise buffer "
                        "multi-GB into host memory")
    p.add_argument("--http_port", type=int, default=None,
                   help="Also serve an HTTP API on this port: POST an "
                        "image to /v1/predict (?format=npy|png) and the "
                        "prediction comes back in the response; requests "
                        "join the same shape-bucketed device batches as "
                        "watched files. GET /healthz reports stats. "
                        "Incompatible with --once.")
    p.add_argument("--once", action="store_true",
                   help="Process everything currently present, then exit")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--color_map", type=str, default="Spectral")
    p.add_argument("--full_precision", action="store_true")
    p.add_argument("--no_compact_readback", action="store_true",
                   help="read predictions back as float32 instead of "
                        "uint16 (compact is 4x less device->host traffic "
                        "at the 16-bit-PNG output precision)")
    add_device_argument(p)
    return p


def _load_pipeline(args):
    import torch

    dtype = torch.float32 if args.full_precision else torch.bfloat16
    if args.full_precision:
        set_full_precision()
    return pipeline_class(args.modality).from_pretrained(
        args.checkpoint, dtype=dtype, device=args.device,
        variant=None if args.full_precision else "fp16",
    )


def _scan_new(watch_dir: str, seen: set,
              read_failures: Optional[dict] = None) -> List[str]:
    out = []
    try:
        names = sorted(os.listdir(watch_dir))
    except FileNotFoundError:
        return out
    current = set()
    for name in names:
        if not name.lower().endswith(EXTENSIONS):
            continue
        path = os.path.join(watch_dir, name)
        current.add(path)
        if path in seen:
            continue
        seen.add(path)
        out.append(path)
    # evict bookkeeping for files no longer present: a months-long daemon
    # over a churned directory must not grow `seen` without bound. (A
    # deleted-then-recreated file is treated as new work — the natural
    # watch-directory semantics.)
    if len(seen) > len(current):
        seen.intersection_update(current)
    if read_failures:
        for path in [p for p in read_failures if p not in current]:
            del read_failures[path]
    return out


class _HttpJob:
    """One in-flight HTTP request: carries the decoded image into the
    batching loop and the serialized prediction back to the handler."""

    __slots__ = ("im", "fmt", "event", "result", "content_type", "error")

    def __init__(self, im, fmt: str):
        self.im = im
        self.fmt = fmt
        self.event = threading.Event()
        self.result: Optional[bytes] = None
        self.content_type = "application/octet-stream"
        self.error: Optional[str] = None


def _serialize_http(job: "_HttpJob", modality: str, out) -> None:
    """Fill job.result from a pipeline Output per the requested format."""
    import io

    from PIL import Image

    from marigold_tpu_torch.pipelines import image_util

    buf = io.BytesIO()
    if job.fmt == "png":
        if modality == "depth":
            Image.fromarray(image_util.float2int(out.depth_np, 16)).save(
                buf, format="PNG"
            )
        elif modality == "normals":
            out.normals_img.save(buf, format="PNG")
        else:  # iid: first target's visualization (iteration order is
            # target_names order; __getitem__ keys by name, not index)
            next(iter(out)).image.save(buf, format="PNG")
        job.content_type = "image/png"
    else:  # npy / npz
        if modality == "depth":
            np.save(buf, out.depth_np)
        elif modality == "normals":
            np.save(buf, out.normals_np)
        else:
            np.savez(buf, **{e.name: e.array for e in out})
            job.content_type = "application/octet-stream"
    job.result = buf.getvalue()


def _start_http_server(port: int, inbox, stats: dict, timeout_s: float,
                       max_body_bytes: int = 64 * 1024 * 1024):
    """stdlib ThreadingHTTPServer feeding the serve loop's inbox. Each
    handler thread blocks on its job's event until the batch containing
    it completes."""
    import io
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        # Socket timeout: bounds every rfile read (incl. the 413 drain
        # loop below) so a client that advertises a huge Content-Length
        # and then stalls cannot hold a handler thread forever.
        timeout = 30.0

        def log_message(self, fmt, *a):  # route through logging, not stderr
            logging.debug("http: " + fmt, *a)

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] != "/healthz":
                self._reply(404, b"not found", "text/plain")
                return
            body = _json.dumps(dict(stats, ok=True)).encode()
            self._reply(200, body, "application/json")

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/v1/predict":
                self._reply(404, b"not found", "text/plain")
                return
            fmt = "npy"
            for part in query.split("&"):
                if part.startswith("format="):
                    fmt = part.split("=", 1)[1]
            if fmt not in ("npy", "png"):
                self._reply(400, b"format must be npy or png", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._reply(400, b"bad Content-Length", "text/plain")
                return
            if n > max_body_bytes:
                # Drain (without storing) up to 2x the cap into a fixed
                # scratch before replying: if we close with the client
                # mid-send, its write fails ECONNRESET and it sees a
                # connection error instead of the 413 (urllib sends the
                # whole body before reading the response). Past the
                # drain bound, close anyway — a multi-GB stream should
                # not be received just to be polite.
                remaining = min(n, 2 * max_body_bytes)
                while remaining > 0:
                    got = self.rfile.read(min(remaining, 1 << 16))
                    if not got:
                        break
                    remaining -= len(got)
                # any undrained bytes must not be misparsed as a
                # follow-up request
                self.close_connection = True
                self._reply(
                    413,
                    f"body too large ({n} > {max_body_bytes} bytes)".encode(),
                    "text/plain",
                )
                return
            try:
                if n <= 0:
                    raise ValueError("empty body")
                im = Image.open(io.BytesIO(self.rfile.read(n))).convert("RGB")
            except Exception as e:  # any undecodable body is the client's
                self._reply(400, f"bad image: {e}".encode(), "text/plain")
                return
            job = _HttpJob(im, fmt)
            inbox.append(job)
            if not job.event.wait(timeout=timeout_s):
                self._reply(504, b"prediction timed out", "text/plain")
                return
            if job.error is not None:
                self._reply(500, job.error.encode(), "text/plain")
                return
            self._reply(200, job.result, job.content_type)

    server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


class _ThreadStreams:
    """One CUDA stream per pool thread, made on its first batch and ordered
    after everything enqueued before it on the creating thread's stream (the
    weights' upload); a null context on the CPU."""

    def __init__(self, device):
        self.device = device
        self._local = threading.local()

    def __call__(self):
        import torch

        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stream = getattr(self._local, "stream", None)
        if stream is None:
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            self._local.stream = stream
        return torch.cuda.stream(stream)


def serve(args, stop_event=None) -> int:
    """Run the daemon. `stop_event` (threading.Event) is a programmatic
    shutdown hook for embedding/tests; the CLI runs until SIGINT."""
    from PIL import Image

    os.makedirs(args.output_dir, exist_ok=True)
    pipe = _load_pipeline(args)
    if pipe.core.text_encoder is not None:
        # computed once here, before any pool thread reads it
        pipe.core.empty_text_embed
    if pipe.core.device.type == "cuda":
        import torch

        torch.cuda.synchronize(pipe.core.device)
    streams = _ThreadStreams(pipe.core.device)

    seen: set = set()
    # path -> [n_fail, first_fail_t, next_retry_t]: a partially-written
    # upload gets retried on a clock (not a per-poll-iteration counter —
    # a busy server loops in milliseconds and would burn any attempt
    # budget before the copy finishes) and is only skipped for good once
    # it has stayed unreadable for a whole retry window.
    read_failures: dict = {}
    read_retry_window = (
        args.read_retry_window if args.read_retry_window is not None
        else max(30.0, 4 * args.batch_wait)
    )
    # buckets: input (H, W) -> deque of (path, PIL image, t_enqueued)
    buckets: dict = collections.defaultdict(collections.deque)
    n_done = 0
    failures: list = []

    call_kwargs = dict(
        denoising_steps=args.denoise_steps,
        ensemble_size=args.ensemble_size,
        processing_res=args.processing_res,
        match_input_res=True,
        batch_size=args.batch_images * args.ensemble_size,
        seed=args.seed,
        compact_readback=not args.no_compact_readback,
    )
    if args.modality == "depth":
        call_kwargs["color_map"] = (
            None if args.color_map in (None, "None") else args.color_map
        )

    def run_batch(group):
        srcs = [g[0] for g in group]
        images = [g[1] for g in group]
        try:
            with streams():
                outs = pipe.batch_call(images, **call_kwargs)
            for src, out in zip(srcs, outs):
                if isinstance(src, _HttpJob):
                    _serialize_http(src, args.modality, out)
                    src.event.set()
                    logging.info("done: <http request>")
                else:
                    stem = os.path.splitext(os.path.basename(src))[0]
                    save_one(args.modality, args.output_dir, stem, out)
                    logging.info(f"done: {stem}")
            return len(srcs)
        except Exception as e:  # one failed batch must not stop the daemon
            logging.exception(f"batch failed: {srcs}")
            failures.append(e)
            for src in srcs:
                if isinstance(src, _HttpJob):
                    # unblock the waiting handler instead of letting it
                    # run into its 504 timeout
                    src.error = f"prediction failed: {e}"
                    src.event.set()
            return 0

    http_server = None
    http_inbox: collections.deque = collections.deque()
    stats = {"served": 0, "pending": 0, "batches": 0}
    if args.http_port is not None:
        if args.once:
            raise SystemExit("--http_port requires watch mode (no --once)")
        http_server = _start_http_server(
            args.http_port, http_inbox, stats,
            timeout_s=max(600.0, 10 * args.batch_wait),
            max_body_bytes=args.http_max_body_mb * 1024 * 1024,
        )
        logging.info(f"HTTP API on :{args.http_port} "
                     "(POST /v1/predict, GET /healthz)")

    pool = ThreadPoolExecutor(max_workers=max(1, args.max_in_flight))
    futures: list = []
    last_scan = float("-inf")
    try:
        while True:
            while http_inbox:
                job = http_inbox.popleft()
                buckets[job.im.size].append((job, job.im, time.time()))
            # the directory scan keeps its --poll_interval cadence even
            # when the HTTP inbox is polled every 20 ms (listdir+sort of
            # a big or networked watch dir 50x/s would burn IO for nothing)
            if time.monotonic() - last_scan < args.poll_interval:
                new_paths = []
            else:
                last_scan = time.monotonic()
                new_paths = _scan_new(args.watch_dir, seen, read_failures)
            for path in new_paths:
                t_scan = time.monotonic()
                rf = read_failures.get(path)
                if rf is not None and t_scan < rf[2]:
                    seen.discard(path)  # retry not due yet; keep pending
                    continue
                try:
                    im = Image.open(path).convert("RGB")
                except Exception as e:  # partial upload or corrupt file
                    n_fail = (rf[0] if rf else 0) + 1
                    first_t = rf[1] if rf else t_scan
                    if t_scan - first_t < read_retry_window:
                        read_failures[path] = [
                            n_fail, first_t,
                            t_scan + max(0.5, args.poll_interval),
                        ]
                        seen.discard(path)
                        logging.warning(f"failed to read {path} "
                                        f"(attempt {n_fail}); will retry")
                    else:
                        read_failures.pop(path, None)
                        failures.append(e)
                        logging.exception(
                            f"failed to read {path}: unreadable for "
                            f"{read_retry_window:.0f}s ({n_fail} attempts); "
                            "skipping permanently")
                    continue
                read_failures.pop(path, None)
                buckets[im.size].append((path, im, time.time()))

            dispatched = False
            now = time.time()
            for shape in list(buckets):
                dq = buckets[shape]
                while len(dq) >= args.batch_images:
                    futures.append(pool.submit(
                        run_batch,
                        [dq.popleft() for _ in range(args.batch_images)],
                    ))
                    # counted here (single-threaded loop), not in
                    # run_batch: concurrent pool workers would lose
                    # read-modify-write increments
                    stats["batches"] += 1
                    dispatched = True
                if dq and (args.once or now - dq[0][2] >= args.batch_wait):
                    futures.append(pool.submit(
                        run_batch, [dq.popleft() for _ in range(len(dq))]
                    ))
                    stats["batches"] += 1
                    dispatched = True
                if not dq:
                    del buckets[shape]

            done = [f for f in futures if f.done()]
            for f in done:
                n_done += f.result()
                futures.remove(f)
            stats["served"] = n_done
            stats["pending"] = (
                sum(len(dq) for dq in buckets.values()) + len(futures)
            )

            # --once drains pending read-retries too: a mid-copy file that
            # failed its first open must get its retry window (it would
            # otherwise be silently dropped with exit code 0)
            if (args.once and not buckets and not futures
                    and not dispatched and not read_failures):
                break
            if stop_event is not None and stop_event.is_set():
                # graceful drain: everything already accepted (watched
                # files and HTTP jobs sitting in the shape buckets) still
                # runs; the finally block waits for in-flight futures
                for shape in list(buckets):
                    dq = buckets[shape]
                    if dq:
                        futures.append(pool.submit(run_batch, list(dq)))
                        stats["batches"] += 1
                    del buckets[shape]
                break
            if not dispatched:
                # with the HTTP API up, poll the inbox at request latency
                # granularity, not the directory-scan cadence
                time.sleep(
                    min(args.poll_interval, 0.02) if http_server is not None
                    else args.poll_interval
                )
    finally:
        if http_server is not None:
            http_server.shutdown()
        for f in futures:
            n_done += f.result()
        pool.shutdown(wait=True)

    logging.info(f"served {n_done} images")
    return 1 if failures else 0


def _install_sigterm_drain():
    """SIGTERM -> graceful drain (finish accepted work, then exit).
    Returns the stop event, or None when not installable (non-main
    thread, e.g. embedded in tests)."""
    import signal

    stop = threading.Event()

    def _on_term(signum, frame):
        logging.info("SIGTERM: draining accepted work, then shutting down")
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        return None
    return stop


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    return serve(args, stop_event=_install_sigterm_drain())


if __name__ == "__main__":
    raise SystemExit(main())
