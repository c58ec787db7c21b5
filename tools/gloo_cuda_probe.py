#!/usr/bin/env python3
"""Can two ranks share one card?  Two spawned ranks on ``cuda:0`` try
each collective the port's mesh path makes (``all_reduce``,
``reduce_scatter_tensor``, ``all_gather_into_tensor``,
``all_to_all_single``, ``batch_isend_irecv``) on CUDA tensors, once over
gloo and once over NCCL, and report per backend and op whether it ran
and gave the right numbers, or its error.  Each run has a deadline; a
rank that misses it is killed.

    python3 tools/gloo_cuda_probe.py

Prints one JSON object.  Needs a card; no network (a ``FileStore``
rendezvous in a temporary directory).
"""
import json
import multiprocessing as mp
import os
import sys
import tempfile
import traceback

WORLD = 2
DEADLINE = 90


def _ops(torch, dist, rank, dev):
    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return t.tolist() == [3.0] * 4

    def reduce_scatter():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(4., device=dev))
        return out.tolist() == [2.0 * (2 * rank), 2.0 * (2 * rank + 1)]

    def all_gather():
        out = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(out, torch.full((2,), float(rank),
                                                    device=dev))
        return out.tolist() == [0.0, 0.0, 1.0, 1.0]

    def all_to_all():
        out = torch.empty(2, device=dev)
        dist.all_to_all_single(out, torch.tensor([10. * rank, 10. * rank + 1],
                                                 device=dev))
        return out.tolist() == [float(rank), 10.0 + rank]

    def p2p():
        send = torch.full((3,), float(rank), device=dev)
        recv = torch.empty(3, device=dev)
        other = 1 - rank
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, other),
                dist.P2POp(dist.irecv, recv, other)]):
            r.wait()
        return recv.tolist() == [float(other)] * 3

    return {"all_reduce": all_reduce, "reduce_scatter_tensor": reduce_scatter,
            "all_gather_into_tensor": all_gather,
            "all_to_all_single": all_to_all, "batch_isend_irecv": p2p}


def _rank(rank, backend, store_path, out):
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    res = {}
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                               WORLD),
                                rank=rank, world_size=WORLD)
    except Exception as e:                      # the finding is the error
        out.put((rank, {"init": f"{type(e).__name__}: {e}"[:300]}))
        return
    for name, fn in _ops(torch, dist, rank, dev).items():
        try:
            ok = fn()
            torch.cuda.synchronize()
            res[name] = "ok" if ok else "wrong numbers"
        except Exception as e:                  # the finding is the error
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"[:300]
    try:
        dist.destroy_process_group()
    except Exception:
        res["destroy"] = traceback.format_exc()[-200:]
    out.put((rank, res))


def probe(backend):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank,
                             args=(r, backend, os.path.join(d, "store"), out))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in range(WORLD):
                r, res = out.get(timeout=DEADLINE)
                got[r] = res
        except Exception:
            got["timeout"] = f"ranks missed the {DEADLINE} s deadline"
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return got


def main():
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"probe": "two ranks on cuda:0",
                      "torch": torch.__version__,
                      "gloo": probe("gloo"), "nccl": probe("nccl")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
