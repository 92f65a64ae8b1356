"""Time the tensor-parallel decode's collectives: two ranks on one card.

    python3 tools/time_gloo_allreduce.py [--iters 200]

From the root of a checkout, on a machine with one CUDA card: spawns two
ranks over gloo (as chip_smoke's phase 26 serves GPT-2 345M at mp = 2)
and times, per call, an all-reduce of a decode step's row-parallel
partial sum, ``[8, 1, 1024]`` float32, routed four ways:

- ``cuda``: ``collective.all_reduce`` on the CUDA tensor (gloo's own
  device path: it copies to host memory, reduces, copies back);
- ``host``: ``.cpu()``, the all-reduce of the host tensor, ``.to(dev)``;
- ``pinned``: a non-blocking copy into a pinned buffer, a synchronize,
  the all-reduce, a non-blocking copy back;
- ``cpu``: the all-reduce of a host tensor alone (no device work);

each alone and after a ``[8, 1024] x [1024, 1024]`` product on the card
(the dependency a decode step's all-reduce waits for). Prints ms a call
by route, rank 0's, with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _rank(out_dir: str, iters: int) -> None:
    import pickle
    import torch
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.collective import all_reduce
    dist.init_parallel_env(backend="gloo")
    rank = dist.get_rank()
    dev = torch.device("cuda")
    x = torch.randn(8, 1, 1024, device=dev)
    w = torch.randn(1024, 1024, device=dev)
    a = torch.randn(8, 1024, device=dev)
    pinned = torch.empty(x.shape, pin_memory=True)

    def cuda():
        all_reduce(x)

    def host():
        h = x.cpu()
        all_reduce(h)
        x.copy_(h.to(dev))

    def pin():
        pinned.copy_(x, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        all_reduce(pinned)
        x.copy_(pinned, non_blocking=True)

    cpu_t = torch.randn(8, 1, 1024)

    def cpu():
        all_reduce(cpu_t)

    res = {}
    for name, fn in (("cuda", cuda), ("host", host), ("pinned", pin),
                     ("cpu", cpu)):
        for dep in (False, True):
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                if dep:
                    torch.matmul(a, w, out=a)
                fn()
            torch.cuda.synchronize()
            res[(name, dep)] = 1e3 * (time.perf_counter() - t0) / iters
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    import pickle
    import torch
    if not torch.cuda.is_available():
        print("time_gloo_allreduce.py: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.distributed.spawn_mod import spawn
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        spawn("time_gloo_allreduce:_rank", args=(tmp, args.iters), nprocs=2)
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            res = pickle.load(f)
    for (name, dep), ms in res.items():
        print(f"all_reduce [8, 1, 1024] f32, route {name}"
              f"{' after a matmul' if dep else ''}: {ms:.3f} ms a call "
              f"(two ranks on one card, rank 0, {args.iters} calls; {smi})")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
