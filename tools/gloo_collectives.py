"""Which gloo collectives take CUDA tensors, and their host time: 2
ranks spawned on one card (cuda:0), each calling all-reduce, all-to-all
and all-gather on CUDA tensors of a decode step's (4, 4096) and a
prefill's (8, 512, 4096) f32 shapes, then the same through a host copy
(10 calls each after one warm-up; ms per call on the host clock).

    python3 tools/gloo_collectives.py      # on a machine with a card
"""
import datetime, json, os, sys, tempfile, time, traceback
import torch, torch.distributed as dist, torch.multiprocessing as mp


def worker(rank, path, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda:0")
    res = {}

    def probe(name, fn, shape):
        try:
            x = torch.full(shape, float(rank + 1), device=dev)
            torch.cuda.synchronize()
            fn(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                y = fn(x)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 100
            res[f"{name}{list(shape)}"] = {"ok": True, "ms": ms,
                                          "dev": str(y.device),
                                          "val": float(y.flatten()[0]),
                                          "val_last": float(y.flatten()[-1])}
        except Exception as e:
            res[f"{name}{list(shape)}"] = {"ok": False, "err": repr(e)[:300]}

    def ar(x):
        y = x.clone(); dist.all_reduce(y); return y

    def a2a(x):
        y = torch.empty_like(x); dist.all_to_all_single(y, x); return y

    def ag(x):
        ys = [torch.empty_like(x) for _ in range(2)]; dist.all_gather(ys, x)
        return torch.cat(ys)

    def agt(x):
        y = torch.empty((2 * x.shape[0],) + x.shape[1:], device=x.device)
        dist.all_gather_into_tensor(y, x); return y

    for shape in ((4, 4096), (8, 512, 4096)):
        probe("all_reduce", ar, shape)
        probe("all_to_all_single", a2a, shape)
        probe("all_gather", ag, shape)
        probe("all_gather_into_tensor", agt, shape)
    # host staging for comparison
    def a2a_host(x):
        h = x.cpu(); y = torch.empty_like(h); dist.all_to_all_single(y, h)
        return y.to(x.device)
    def ar_host(x):
        h = x.cpu(); dist.all_reduce(h); return h.to(x.device)
    for shape in ((4, 4096), (8, 512, 4096)):
        probe("all_reduce_host", ar_host, shape)
        probe("all_to_all_host", a2a_host, shape)
    with open(f"{out}/r{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    d = tempfile.mkdtemp()
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    mp.start_processes(worker, args=(d + "/rdv", d), nprocs=2,
                       start_method="spawn", join=True)
    for r in range(2):
        print(r, json.dumps(json.load(open(f"{d}/r{r}.json")), indent=1))
