"""Process groups of the PyTorch port (counterpart of
``zerospeech_tts_tpu/parallel/distributed.py``).

Training runs one process per card, launched the way PyTorch launches
it::

    torchrun --nproc-per-node D*M -m zerospeech_tts_tpu_torch train1 ... --mesh data=D,model=M

Every process calls :func:`initialize` first: it reads the variables
torchrun sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), joins the group over TCP, and binds ``cuda:LOCAL_RANK``.
The backend follows the device: NCCL on ``cuda``, gloo on ``cpu``.
Without the variables it returns False and nothing else changes, as the
JAX function does on a single host. :func:`mesh_groups` makes each rank's
data group and model group (parallel/mesh.py lays the ranks out).

Every collective of the port is an ``all_reduce``: gloo takes CUDA tensors
for ``broadcast`` and ``all_reduce`` only, and a world of two ranks on one
card must run over gloo (NCCL refuses two ranks on one device).
:func:`launch` starts such a world of local processes with torchrun's
variables (the tests, ``tools/dp_parity.py`` and ``chip_smoke.py`` use it;
``torchrun`` itself is the launcher for users).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
PKG_ROOT = Path(__file__).resolve().parents[2]
LAUNCH_ATTEMPTS = 3  # rendezvous ports tried by launch before it gives up


def launched_world() -> int:
    """WORLD_SIZE as the launcher set it (1 when no launcher did)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize(device: str | torch.device = "cuda", backend: str | None = None) -> bool:
    """Join the process group that torchrun's variables describe; True
    when a group is (or already was) initialised, False without the
    variables. On ``cuda`` it binds ``cuda:LOCAL_RANK`` (raising when that
    card is not visible). ``backend`` None picks NCCL on ``cuda`` and gloo
    on ``cpu``; "gloo" on ``cuda`` is how two ranks share one card."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {missing} are not: launch with torchrun")
    world, rank, local = (int(os.environ[k]) for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"))
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(f"LOCAL_RANK {local}: only {n} CUDA device(s) are visible")
        torch.cuda.set_device(local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                            world_size=world, rank=rank)
    return True


def local_device(device: str | torch.device) -> torch.device:
    """``cuda:LOCAL_RANK`` for a ``cuda`` device in an initialised group,
    else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def all_reduce_mean_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In place: the mean of ``t`` over the group's ranks."""
    dist.all_reduce(t, group=group)
    return t.div_(dist.get_world_size(group))


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` [n, ...] concatenated in rank order [world * n,
    ...], as an all_reduce of a zeroed [world, n, ...] buffer that each
    rank fills at its own row."""
    buf = t.new_zeros((dist.get_world_size(group), *t.shape))
    buf[dist.get_rank(group)] = t
    dist.all_reduce(buf, group=group)
    return buf.reshape(-1, *t.shape[1:])


def all_gather_slices(t: torch.Tensor, axis: int, group) -> torch.Tensor:
    """Every rank's block ``t`` of a tensor, concatenated along ``axis`` in
    the group's rank order (all_gather_rows along that axis), contiguous."""
    if axis == 0:
        return all_gather_rows(t, group)
    return all_gather_rows(t.movedim(axis, 0), group).movedim(0, axis).contiguous()


def mesh_groups(mesh) -> tuple:
    """(data group, model group) of this rank on ``mesh`` (parallel/mesh.py
    ``Mesh``): the ranks that share its ``m``, which hold the same blocks
    of the state and different rows, and the ranks that share its ``d``,
    which hold the same rows and together the whole state. Every rank
    creates every group, in the same order (``new_group`` is a collective
    of the world). With ``model`` 1: the world and no model group."""
    if mesh.model == 1:
        return dist.group.WORLD, None
    data = [dist.new_group([d * mesh.model + m for d in range(mesh.data)]) for m in range(mesh.model)]
    model = [dist.new_group([d * mesh.model + m for m in range(mesh.model)]) for d in range(mesh.data)]
    return data[mesh.m], model[mesh.d]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list[str], world: int, env: dict | None = None, local_ranks=None,
           timeout: float = 900.0) -> list[tuple[int, str, str]]:
    """Run ``python *argv`` as ``world`` local processes with torchrun's
    variables (MASTER_ADDR 127.0.0.1, a free port, LOCAL_RANK from
    ``local_ranks``, default the ranks themselves) and the package's root on
    PYTHONPATH; returns each rank's (exit code, stdout, stderr). When one
    rank fails the others are stopped, so none waits in a collective for a
    peer that is gone. The port is probed free and then closed before rank
    0 binds it, so another process can take it in between: a world whose
    rendezvous found its address in use is started again on a fresh port
    (at most ``LAUNCH_ATTEMPTS`` times in all)."""
    local_ranks = list(range(world)) if local_ranks is None else list(local_ranks)
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(p for p in (str(PKG_ROOT), base.get("PYTHONPATH")) if p)
    for attempt in range(LAUNCH_ATTEMPTS):
        port = free_port()
        procs, files = [], []
        for r in range(world):
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            e = dict(base, WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(local_ranks[r]),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen([sys.executable, *argv], env=e, stdout=out, stderr=err))
        t0 = time.monotonic()
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() - t0 > timeout:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        results = []
        for p, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
        in_use = any("address already in use" in e.lower() for _, _, e in results)
        if not (in_use and any(rc for rc, _, _ in results)) or attempt == LAUNCH_ATTEMPTS - 1:
            return results
    return results
