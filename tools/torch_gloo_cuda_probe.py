"""Which collectives a gloo group takes on CUDA tensors, and what they cost.

    python tools/torch_gloo_cuda_probe.py [--world 2] [--device cuda]

Starts `--world` processes on this machine's first card (or the CPU),
joined by a gloo group on a local port, and has each try `all_gather`
and `all_reduce` on tensors of the device, natively and staged through
pinned host memory, at the sizes of row-sharded solves (a gathered
m-vector, an all-reduced n-vector, a batch of them, the n x n Gram).
Rank 0 prints one JSON line: per collective and size, whether the
native call ran (or its error), and the median ms of 50 calls each way.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

# (label, shape) of the tensors each collective moves per rank
SIZES = (("n=2048", (2048,)), ("m_r=4096", (4096,)),
         ("64 x 200", (64, 200)), ("64 x 100", (64, 100)),
         ("gram 2048^2", (2048, 2048)))


def _time(fn, reps: int = 50) -> float:
    import torch
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def child(rank: int, world: int, port: int, device: str) -> None:
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    dev = torch.device(device)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    for label, shape in SIZES:
        t = torch.full(shape, float(rank + 1), dtype=torch.float64,
                       device=dev)
        row = {}
        for name in ("all_gather", "all_reduce"):
            def native():
                if name == "all_gather":
                    parts = [torch.empty_like(t) for _ in range(world)]
                    dist.all_gather(parts, t)
                    return torch.stack(parts)
                r = t.clone()
                dist.all_reduce(r)
                return r

            def staged():
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=(
                    dev.type == "cuda"))
                h.copy_(t)
                if name == "all_gather":
                    parts = [torch.empty_like(h) for _ in range(world)]
                    dist.all_gather(parts, h)
                    return torch.stack(parts).to(dev)
                dist.all_reduce(h)
                return h.to(dev)

            try:
                got = native()
                want = staged()
                row[name] = {"native": bool(torch.equal(got, want)),
                             "native_ms": _time(native),
                             "staged_ms": _time(staged)}
            except Exception as e:     # the probe reports what refuses
                row[name] = {"native": f"{type(e).__name__}: {e}"[:300],
                             "staged_ms": _time(staged)}
        out[label] = row
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child, args.world, args.port, args.device)
        return 0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--world", str(args.world), "--device",
         args.device, "--child", str(r), "--port", str(port)],
        env=dict(os.environ, OMP_NUM_THREADS="1"))
        for r in range(args.world)]
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return max(rcs)


if __name__ == "__main__":
    raise SystemExit(main())
