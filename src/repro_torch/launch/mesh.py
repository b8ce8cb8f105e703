"""Device meshes of the port, the counterparts of the reference's
``repro.launch.mesh``: a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the default process group.

Both builders are functions, so importing this module touches no
process group.  The caller opens the world first
(``torch.distributed.init_process_group``, with its address, world size
and rank given explicitly: nothing on the machine announces a cluster).

Topology (the reference's TPU v5e pods, one rank a device):
  single-pod:  (16, 16)    axes ("data", "model")           256 ranks
  multi-pod:   (2, 16, 16) axes ("pod", "data", "model")    512 ranks
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch


def _device_type(device: "Optional[torch.device | str]") -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def _mesh(shape: tuple, axes: tuple, device) -> "DeviceMesh":
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("the mesh needs an open process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: "Optional[torch.device | str]" = None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``; raises unless the world has 256
    or 512 ranks to match."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: "Optional[torch.device | str]" = None):
    """A (data, model) mesh over ("data", "model"): the tests' meshes of
    gloo ranks on the CPU, and the one-rank NCCL mesh on a card.
    ``device`` is the mesh's device type (the GPU when one is present,
    else the CPU)."""
    return _mesh((data, model), ("data", "model"), device)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object with its
    ``mesh_dim_names`` and ``shape``), the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _rank_main(rank: int, world_size: int, store: str, out_dir: str,
               backend: str) -> None:
    import pickle
    import traceback
    import torch.distributed as dist
    out = Path(out_dir)
    # the ranks share the host's cores
    torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // world_size)))
    try:
        fn, args = pickle.loads((out / "call.pkl").read_bytes())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world_size)
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(fn, world_size: int, *args, out_dir: "str | Path",
              timeout: float = 120.0, backend: str = "gloo") -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes that form one ``torch.distributed`` world (``backend``,
    gloo on the CPU by default) through a ``FileStore`` in ``out_dir``,
    so that worlds never share a port.  Returns each rank's result, in
    rank order.  The world is joined under ``timeout`` seconds in all:
    a rank still running then is killed, and a rank that failed or hung
    raises ``RuntimeError`` with its traceback.  ``fn`` and ``args``
    must pickle (``fn`` a module-level function); they reach the ranks
    through a file, so that no rank's start waits for another's."""
    import multiprocessing as mp
    import pickle
    import time
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    for old in [store, *out.glob("rank*.pkl"), *out.glob("rank*.err")]:
        old.unlink(missing_ok=True)
    (out / "call.pkl").write_bytes(pickle.dumps((fn, args)))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, str(store), str(out), backend))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (out / f"rank{r}.err").read_text()
              for r in range(world_size) if (out / f"rank{r}.err").exists()}
    if hung or errors or any(p.exitcode for p in procs):
        detail = "\n".join(f"rank {r}:\n{e}" for r, e in errors.items())
        raise RuntimeError(
            f"world of {world_size}: ranks {hung} hung past {timeout} s, "
            f"exit codes {[p.exitcode for p in procs]}\n{detail}")
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world_size)]
