"""Serving latency and throughput — port of ``hvt/tools/serve_bench.py``
(config mode).

``clients`` threads each send ``requests`` requests of one 320x320 JPEG,
closed loop, and the tool prints one JSON line: throughput and per-request
latency percentiles. By default the clients call
``InferenceEngine.predict_image`` (decode, the batcher, the step, the
top-k decode); ``--http`` sends every request through the HTTP server.

    python -m hvt_torch.tools.serve_bench --machine configs/machines/local.yaml \\
        --exp configs/pretrain/swinv2_tiny.yaml [--clients 8] [--requests 25] \\
        [--batch 0] [--topk 5] [--http] [--device cpu]

Weights resolve as the server's (the seeded init without a ``load_path``,
which serves at the same speed). Runs on the CUDA card unless ``--device
cpu``. Serving artifacts (``--artifact``) are not ported yet.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time

import numpy as np


def _jpeg_bytes(side: int = 320, seed: int = 0) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


def run_bench(engine, *, clients: int, requests: int, http: bool = False) -> dict:
    """Drive ``engine`` with ``clients`` threads × ``requests`` each and
    return the record. A request's latency covers the decode, the
    batcher's queue, the step and the top-k decode (and the HTTP round trip
    with ``http``)."""
    payload = _jpeg_bytes()
    server = None
    if http:
        import urllib.request

        from hvt_torch.downstream import serve as serve_lib

        server = serve_lib.make_server(engine, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}/predict"

        def one():
            req = urllib.request.Request(url, data=payload, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                json.loads(r.read())
    else:
        def one():
            engine.predict_image(payload)

    try:
        one()  # the whole path once, outside the timing
        latencies_ms: list[float] = []
        failures: list[str] = []
        lock = threading.Lock()
        start = threading.Barrier(clients + 1)

        def client():
            mine, fails = [], []
            start.wait()
            for _ in range(requests):
                t0 = time.perf_counter()
                try:
                    one()
                except Exception as e:  # counted; the client goes on
                    fails.append(f"{type(e).__name__}: {e}")
                    continue
                mine.append((time.perf_counter() - t0) * 1e3)
            with lock:
                latencies_ms.extend(mine)
                failures.extend(fails)

        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        elapsed = time.perf_counter() - t0
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()

    if not latencies_ms:
        raise RuntimeError(f"every request failed ({len(failures)}); first: "
                           f"{failures[0] if failures else 'n/a'}")
    lat = np.asarray(latencies_ms)
    return {
        "metric": "serving_latency",
        "model": engine.model_name,
        "mode": "http" if http else "engine",
        "clients": clients,
        "requests_per_client": requests,
        "batch": engine.batch,
        "failed_requests": len(failures),
        "throughput_rps": round(len(lat) / elapsed, 2),
        "latency_ms": {
            "p50": round(float(np.percentile(lat, 50)), 2),
            "p90": round(float(np.percentile(lat, 90)), 2),
            "p99": round(float(np.percentile(lat, 99)), 2),
            "mean": round(float(lat.mean()), 2),
            "max": round(float(lat.max()), 2),
        },
    }


def build_parser() -> argparse.ArgumentParser:
    from hvt_torch import config as config_lib
    from hvt_torch.serve import NOT_PORTED, NotPorted

    parser = argparse.ArgumentParser(prog="python -m hvt_torch.tools.serve_bench",
                                     description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--clients", type=int, default=8)
    parser.add_argument("--requests", type=int, default=25)
    parser.add_argument("--batch", type=int, default=0,
                        help="batch shape of the forward (requests pad into it); 0 = 1")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--http", action="store_true", help="measure through the HTTP server")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (an error without one)")
    parser.add_argument("--artifact", action=NotPorted,
                        help=f"benchmarking a StableHLO serving artifact {NOT_PORTED}")
    return parser


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from hvt_torch import config as config_lib
    from hvt_torch.downstream import serve as serve_lib

    config = config_lib.load(machine=args.machine, exps=args.exp)
    engine = serve_lib.InferenceEngine(config, batch=max(1, args.batch), topk=args.topk,
                                       device=args.device)
    try:
        record = run_bench(engine, clients=args.clients, requests=args.requests, http=args.http)
    finally:
        engine.close()
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
