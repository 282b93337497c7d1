#!/usr/bin/env python3
"""Which collectives, and which DTensor redistributions, a gloo group
carries for CUDA tensors: ``world`` ranks as spawned processes on ``cuda:0``
(one card), joined by a ``file://`` rendezvous.

    python3 scripts/gloo_cuda_collectives.py [--world 4] [--mib 64]

Each rank tries every collective once on a small tensor and prints ``ok``
or the error's first line (a collective that kills the ranks, as a
segfault does, is printed as such and the ranks start again past it); then each DTensor transition on a 2 x 2 mesh
over ``("data", "model")`` (Shard -> Replicate, Partial -> Replicate,
Partial -> Shard, Shard(0) -> Shard(1), Replicate -> Shard); then it times
``all_reduce`` and ``all_gather_into_tensor`` of ``--mib`` MiB of float32
(host clock around work that ends in a synchronise, the median of 5).
Rank 0 prints the torch and CUDA versions, the card's name and power
limit.  A probe: a failure is printed, not raised, and the exit code is 0
when every rank finished.
"""
import argparse
import multiprocessing
import statistics
import subprocess
import sys
import tempfile
import time


def _try(label, fn):
    try:
        fn()
        return f"{label}: ok"
    except Exception as e:  # a probe reports every failure and goes on
        return f"{label}: {type(e).__name__}: {str(e).splitlines()[0][:160]}"


def rank_main(rank: int, world: int, init: str, mib: int, out: str, skip: int) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    log = open(out, "a")

    def emit(line):
        log.write(line + "\n")
        log.flush()

    x = torch.full((world * 4,), float(rank + 1), device=dev)

    def sync(t):
        torch.cuda.synchronize()
        return t

    def all_gather_base():
        out_t = torch.empty(world * x.numel(), device=dev)
        dist.all_gather_into_tensor(out_t, x)

    def reduce_scatter_base():
        out_t = torch.empty(x.numel() // world, device=dev)
        dist.reduce_scatter_tensor(out_t, x)

    def reduce_scatter_list():
        out_t = torch.empty(4, device=dev)
        dist.reduce_scatter(out_t, list(x.chunk(world)))

    def all_to_all_single():
        out_t = torch.empty_like(x)
        dist.all_to_all_single(out_t, x)

    def scatter():
        out_t = torch.empty(4, device=dev)
        dist.scatter(out_t, list(x.chunk(world)) if rank == 0 else None, src=0)

    tests = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather (list)": lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": all_gather_base,
        "reduce_scatter (list)": reduce_scatter_list,
        "reduce_scatter_tensor": reduce_scatter_base,
        "all_to_all_single": all_to_all_single,
        "scatter": scatter,
        "funcol.all_reduce": lambda: sync(funcol.all_reduce(x, "sum", dist.group.WORLD)),
        "funcol.all_gather_tensor": lambda: sync(funcol.all_gather_tensor(x, 0, dist.group.WORLD)),
        "funcol.reduce_scatter_tensor": lambda: sync(
            funcol.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD)),
        "funcol.all_to_all_single": lambda: sync(funcol.all_to_all_single(
            x, None, None, dist.group.WORLD)),
    }
    done = 0

    def run(label, fn):
        nonlocal done
        done += 1
        if done <= skip:
            return
        emit(f"start {label}")
        emit(_try(label, fn))
        dist.barrier()

    for label, fn in tests.items():
        run(label, fn)

    if world == 4:
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        base = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)
        moves = {
            "Shard(0) -> Replicate on data": ((Shard(0), Replicate()), (Replicate(), Replicate())),
            "Partial -> Replicate on data": ((Partial(), Replicate()), (Replicate(), Replicate())),
            "Partial -> Shard(0) on data": ((Partial(), Replicate()), (Shard(0), Replicate())),
            "Shard(0) -> Shard(1) on data": ((Shard(0), Replicate()), (Shard(1), Replicate())),
            "Replicate -> Shard(1) on model": ((Replicate(), Replicate()), (Replicate(), Shard(1))),
        }
        for label, (src, dst) in moves.items():
            def move(src=src, dst=dst):
                if any(p.is_partial() for p in src):
                    t = DTensor.from_local(base, mesh, src, run_check=False)
                else:
                    t = distribute_tensor(base, mesh, src)
                sync(t.redistribute(mesh, dst).to_local())
            run(f"DTensor {label}", move)

    big = torch.ones(mib * (1 << 18), device=dev)
    for label, fn in (("all_reduce", lambda: dist.all_reduce(big)),
                      ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                          torch.empty(world * big.numel(), device=dev), big))):
        times = []
        for _ in range(6):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as e:  # reported, as above
                times = [f"{type(e).__name__}"]
                break
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if times and isinstance(times[0], float):
            med = statistics.median(times[1:])
            emit(f"time {label} of {mib} MiB f32: median {med:.1f} ms of 5 "
                         f"({mib / 1024 / (med / 1e3):.2f} GiB/s of input)")
        else:
            emit(f"time {label}: {times}")
    dist.destroy_process_group()
    emit("finished")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--mib", type=int, default=64)
    args = ap.parse_args()
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    ctx = multiprocessing.get_context("spawn")
    skip, attempt, ok = 0, 0, False
    with tempfile.TemporaryDirectory() as tmp:
        while not ok and attempt < 20:
            attempt += 1
            init = f"file://{tmp}/rendezvous{attempt}"
            outs = [f"{tmp}/a{attempt}_rank{r}.txt" for r in range(args.world)]
            procs = [ctx.Process(target=rank_main,
                                 args=(r, args.world, init, args.mib, outs[r], skip))
                     for r in range(args.world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=120)
            codes = []
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
                codes.append(p.exitcode)
            bodies = []
            for r in range(args.world):
                try:
                    with open(outs[r]) as f:
                        bodies.append(f.read().splitlines())
                except FileNotFoundError:
                    bodies.append([])
            print(f"=== attempt {attempt} (skipping the first {skip} tests), exit codes {codes}")
            for r, body in enumerate(bodies):
                print(f"--- rank {r}\n" + "\n".join(body), flush=True)
            ok = all(c == 0 for c in codes)
            started = [sum(1 for l in b if l.startswith("start ")) for b in bodies]
            if not ok:
                if not max(started):
                    break  # died before the first test: no progress to make
                last = [l for l in bodies[0] if l.startswith("start ")][-1:] or ["?"]
                print(f"*** the ranks died in: {last[0][6:]} (exit codes {codes})", flush=True)
                skip += max(started)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
