"""One rank of ``launch.mesh.run_ranks``:

    python -m repro_torch.launch.rank_main WORKDIR RANK

reads the job ``run_ranks`` pickled into WORKDIR, joins the world, builds
the mesh, runs the job's function and, on rank 0, pickles its result
(tensors moved to the CPU) into WORKDIR; a failure's traceback goes to
WORKDIR/err{RANK}.txt and the exit code is 1."""
from __future__ import annotations

import datetime
import importlib
import importlib.util
import pathlib
import pickle
import sys
import traceback

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh


def _load(module: str, qual: str, path):
    if path is not None:
        spec = importlib.util.spec_from_file_location("_rank_script", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules["_rank_script"] = mod
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    obj = mod
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def main(work: str, rank: int) -> int:
    work = pathlib.Path(work)
    job = pickle.loads((work / "job.pkl").read_bytes())
    try:
        torch.set_num_threads(1)
        dev = torch.device(job["device"])
        if dev.type == "cuda":
            n = torch.cuda.device_count()
            dev = torch.device("cuda", rank if job["backend"] == "nccl"
                               else rank % n)
            torch.cuda.set_device(dev)
        world = job["world"]
        store = dist.FileStore(job["store"], world)
        kw = dict(backend=job["backend"], store=store, rank=rank,
                  world_size=world,
                  timeout=datetime.timedelta(seconds=job["timeout"]))
        if job["backend"] == "nccl":
            kw["device_id"] = dev
        dist.init_process_group(**kw)
        try:
            mesh = Mesh(job["shape"], job["axes"], device=dev)
            fn = _load(*job["fn"])
            out = fn(mesh, *job["args"], **job["kwargs"])
            if rank == 0:
                tmp = work / "result.pkl.tmp"
                tmp.write_bytes(pickle.dumps(_to_cpu(out)))
                tmp.replace(work / "result.pkl")
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        (work / f"err{rank}.txt").write_text(traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
