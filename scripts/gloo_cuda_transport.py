"""Which gloo collectives take CUDA tensors on this machine's torch.

    python3 scripts/gloo_cuda_transport.py

Runs each collective of the distributed layer once in its own group of two
rank processes on the card (``parallel.driver.launch``, backend gloo) with
CUDA tensors handed to ``torch.distributed`` directly, not staged: the
all_reduce, broadcast, all_gather, all_gather_into_tensor and
all_to_all_single that ``ProcessComm`` and the a2a exchange use, and the
batch_isend_irecv of the ppermute exchange. A collective gloo does not take
may abort its rank process; the group is stopped and the line says so.
``ProcessComm`` stages every CUDA buffer through host memory under gloo
whatever this prints, so the port does not depend on it. Prints one line a
collective and a JSON line at the end. Needs a card; about a minute.
"""
import json
import pathlib
import sys

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "all_to_all_single",
               "batch_isend_irecv")


def collective(comm, device, name):
    """``name`` once on CUDA tensors; returns what this rank received."""
    me, p = comm.index(), comm.size
    t = torch.full((8,), float(me + 1), device=device)
    if name == "all_reduce":
        dist.all_reduce(t)
        return t
    if name == "broadcast":
        dist.broadcast(t, 0)
        return t
    if name == "all_gather":
        parts = [torch.empty_like(t) for _ in range(p)]
        dist.all_gather(parts, t)
        return torch.cat(parts)
    if name == "all_gather_into_tensor":
        out = torch.empty(8 * p, device=device)
        dist.all_gather_into_tensor(out, t)
        return out
    if name == "all_to_all_single":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        return out
    r = torch.empty_like(t)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, (me + 1) % p),
        dist.P2POp(dist.irecv, r, (me - 1) % p)])
    for w in works:
        w.wait()
    return r


def main():
    from trilinos_tpu_torch.parallel.driver import launch

    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_transport: no CUDA device")
    takes = {}
    for name in COLLECTIVES:
        try:
            got = launch(collective, 2, name, device="cuda", backend="gloo",
                         timeout=120.0)
            takes[name] = True
            print(f"gloo takes CUDA tensors in {name}: rank results "
                  f"{[g.tolist()[:2] for g in got]}", flush=True)
        except (RuntimeError, TimeoutError) as e:
            takes[name] = False
            print(f"gloo refuses CUDA tensors in {name}: "
                  f"{str(e).splitlines()[0]}", flush=True)
    print(json.dumps({"torch": torch.__version__, "gloo_takes_cuda": takes}))


if __name__ == "__main__":
    main()
