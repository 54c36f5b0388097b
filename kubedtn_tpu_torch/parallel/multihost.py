"""One process of a multi-process mesh, and the parent that starts them:

    python -m kubedtn_tpu_torch.parallel.multihost JOB_DIR RANK

The port's counterpart of the JAX package's multi-host workers
(tests/test_multihost.py): each process joins the run
(mesh.init_distributed), builds the host-major mesh over its own shards
(mesh.make_multihost_mesh) and runs the job's tasks on them, in order:

- "reduce": an [E] array's blocks summed across every shard;
- "step": chained steps of parallel/sharded.make_sharded_step;
- "router": steps of parallel/router.make_sharded_router_step from a fresh
  router.init_router state, each shard drawing from its own generator
  (shard_generators, by global shard index).

The job directory holds `job.json` (the world size, the rendezvous, each
rank's devices, the tasks and their scalars) and `inputs.pt` (each task's
tensors), both written by the parent; each rank writes its shards'
results, by task, to `out-<rank>.pt` and its counts and clocks to
`result-<rank>.json`, kernel K1's launches counted from 0 around each
task. `spawn` starts the processes and waits for them, killing the
others when one fails. A worker imports torch and this package only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
JOB = "job.json"
INPUTS = "inputs.pt"
FORBIDDEN = ("jax", "jaxlib", "kubedtn_tpu")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reduce(mesh, inputs: dict, task: dict) -> tuple:
    """Each shard sums its block of inputs["data"]; the sums of every
    shard are added in global shard order."""
    from kubedtn_tpu_torch.parallel.mesh import edge_sharding, gather_shards
    from kubedtn_tpu_torch.parallel.sharded import cross_shard_sum

    data = inputs["data"]
    mine = [(lo, hi) for e, lo, hi in edge_sharding(mesh, data.shape[0])
            if e.rank == mesh.rank]
    total = cross_shard_sum(
        gather_shards(mesh, [data[lo:hi].sum() for lo, hi in mine]),
        mesh.home)
    return {}, {"total": float(total),
                "local_shard_starts": [lo for lo, _ in mine]}


def _step(mesh, inputs: dict, task: dict) -> tuple:
    """The sharded step over inputs["steps"], each a dict of one
    UpdateLinks batch (rows, props, valid by global row), the [E]
    inputs (sizes, have, t_arr) and the uniforms `u`, or none, when the
    whole [E, NU] array is drawn from a generator on the home device
    seeded with task["seed"]."""
    from kubedtn_tpu_torch.parallel.mesh import shard_edge_state
    from kubedtn_tpu_torch.parallel.sharded import make_sharded_step

    home = mesh.home
    shards = shard_edge_state(inputs["state"], mesh)
    step = make_sharded_step(mesh, task["n_nodes"])
    gen = torch.Generator(device=home).manual_seed(task.get("seed", 0))
    results, stats, walls = [], [], []
    for x in inputs["steps"]:
        _sync(home)
        t0 = time.perf_counter()
        shards, res, st = step(shards, x["rows"], x["props"], x["valid"],
                               x["sizes"], x["have"], x["t_arr"], gen,
                               u=x.get("u"))
        _sync(home)
        walls.append(time.perf_counter() - t0)
        results.append(res)
        stats.append(st)
    return ({"shards": shards, "results": results, "stats": stats},
            {"ms_per_step": [1e3 * w for w in walls]})


def _router(mesh, inputs: dict, task: dict) -> tuple:
    """task["steps"] sharded router steps from router.init_router over
    inputs["edges"] and inputs["next_edge"]; with task["gather"] the whole
    state gathered on every rank too."""
    from kubedtn_tpu_torch import router
    from kubedtn_tpu_torch.parallel import router as prouter

    home = mesh.home
    rs = router.init_router(inputs["edges"], inputs["next_edge"],
                            task["n_nodes"], q=task["q"], k_fwd=task["k_fwd"])
    shards = prouter.shard_router_state(rs, mesh)
    del rs
    gens = prouter.shard_generators(mesh, task["seed"])
    step = prouter.make_sharded_router_step(
        mesh, task["n_nodes"], k_slots=task["k_slots"], k_fwd=task["k_fwd"],
        budget=task["budget"])
    walls = []
    for _ in range(task["steps"]):
        _sync(home)
        t0 = time.perf_counter()
        shards = step(shards, inputs["spec"], inputs["flow_dst"], gens,
                      task["dt_us"])
        _sync(home)
        walls.append(time.perf_counter() - t0)
    out = {"shards": shards}
    if task.get("gather"):
        out["gathered"] = prouter.gather_router_state(shards, mesh=mesh)
    S, n, budget = len(mesh), mesh.per_rank, task["budget"]
    row = budget * 4 * 4            # one (source, destination) block, B
    rs0 = shards[0]
    return out, {
        "ms_per_step": [1e3 * w for w in walls],
        # what this rank hands all_to_all_single a step, and the part of
        # it bound for other processes
        "a2a_bytes_per_step": n * S * row,
        "a2a_cross_process_bytes_per_step": n * (S - n) * row,
        "node_rx_packets": rs0.node_rx_packets.cpu().tolist(),
        "fwd_dropped": float(rs0.fwd_dropped),
        "no_route_dropped": float(rs0.no_route_dropped)}


TASKS = {"reduce": _reduce, "step": _step, "router": _router}


def run(job_dir: Path, rank: int) -> dict:
    """Run the job in `job_dir` as process `rank`; returns what it wrote
    to result-<rank>.json."""
    from kubedtn_tpu_torch import _build
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import mesh as pmesh

    t_start = time.time()
    job = json.loads((job_dir / JOB).read_text())
    pmesh.init_distributed(job["init"], job["world"], rank,
                           timeout_s=job["timeout_s"])
    mesh = pmesh.make_multihost_mesh(job["devices"][rank])
    home = mesh.home
    if home.type == "cuda":
        _build.library("shaping")      # K1, built by the parent
        torch.cuda.synchronize(home)
    t_ready = time.time()
    # written by the spawning process alone (dataclasses of tensors)
    inputs = torch.load(job_dir / INPUTS, map_location=home,
                        weights_only=False)
    out, info = {}, {}
    for name, task in job["tasks"].items():
        shaping.reset_launches()
        out[name], info[name] = TASKS[name](mesh, inputs[name], task)
        _sync(home)
        info[name]["k1_launches"] = shaping.LAUNCHES["shape_step_rows"]
    info.update(
        rank=rank, backend=mesh.backend, staging=mesh.staging,
        world_size=mesh.world_size, shards=len(mesh),
        entries=[[e.rank, e.device] for e in mesh.entries],
        t_start=t_start, t_ready=t_ready, t_done=time.time(),
        forbidden_modules=sorted(
            m for m in sys.modules if m.split(".")[0] in FORBIDDEN))
    torch.save(out, job_dir / f"out-{rank}.pt")
    (job_dir / f"result-{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()
    return info


def write_job(job_dir, tasks: dict, inputs: dict, **job) -> Path:
    """Write a job for `spawn`: `tasks` maps each task to run, in order,
    to its scalars, `inputs` each task to its tensors (dataclasses of
    tensors too); `job` holds world, init (the rendezvous), devices (one
    list per rank) and timeout_s."""
    job_dir = Path(job_dir)
    job_dir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, job_dir / INPUTS)
    (job_dir / JOB).write_text(json.dumps(dict(job, tasks=tasks)))
    return job_dir


def spawn(job_dir, world: int, timeout_s: float) -> list[dict]:
    """Start `world` worker processes (sys.executable) on the job in
    `job_dir`, wait for every one and return each rank's result. A worker
    that exits non-zero, or outlives `timeout_s`, fails the run: the
    others are killed and RuntimeError carries its log's tail. Each
    worker's output is in log-<rank>.txt."""
    job_dir = Path(job_dir)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env.setdefault("PYTHONFAULTHANDLER", "1")
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(job_dir / f"log-{r}.txt", "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubedtn_tpu_torch.parallel.multihost",
                 str(job_dir), str(r)], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0]} exited {codes[bad[0]]}"
                                   f"\n{_tail(job_dir, bad[0])}")
            if None not in codes:
                break
            if time.monotonic() > deadline:
                late = codes.index(None)
                raise RuntimeError(f"rank {late} outlived {timeout_s} s\n"
                                   f"{_tail(job_dir, late)}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    return [json.loads((job_dir / f"result-{r}.json").read_text())
            for r in range(world)]


def _tail(job_dir: Path, rank: int) -> str:
    text = (job_dir / f"log-{rank}.txt").read_text(errors="replace")
    return f"rank {rank}'s log:\n{text[-3000:]}"


def load_outputs(job_dir, world: int, device="cpu") -> list[dict]:
    """Each rank's out-<rank>.pt, on `device`."""
    return [torch.load(Path(job_dir) / f"out-{r}.pt", map_location=device,
                       weights_only=False)
            for r in range(world)]


if __name__ == "__main__":
    run(Path(sys.argv[1]), int(sys.argv[2]))
