"""The rank mesh: a named grid of ``torch.distributed`` ranks.

The JAX package's mesh is a grid of XLA devices driven by one program
(``shard_map``).  Here every mesh position is a process (SPMD by process):
:class:`Mesh` holds the group that spans the ranks, the grid's shape and
axis names, and this rank's place in it, with the surface
:mod:`repro_torch.core.distributed` and :mod:`repro_torch.models.api` read
(``axis_names``, ``shape`` as a name -> size mapping, ``size``, ``rank``).

Production layout (JAX's ``make_production_mesh``):

  single pod:  (16, 16)     axes ("data", "model")          = 256 ranks
  multi-pod:   (2, 16, 16)  axes ("pod", "data", "model")   = 512 ranks

With fewer ranks the same axis names take the scaled-down stand-in
``(2, W//2)`` or ``(2, 2, W//4)``.

The mesh keeps the group and the shape itself rather than a
``torch.distributed.device_mesh.DeviceMesh``: the card machine has one
GPU, so the test and smoke runs put several gloo ranks on ``cuda:0``,
where ``DeviceMesh`` would map rank r to ``cuda:r``.  Like ``DeviceMesh``
it builds one subgroup per axis and line of ranks (:meth:`Mesh.axis_group`:
the ranks that differ only along that axis), which the sharded LM path
reduces over.  ``dist.new_group`` is collective over the whole world, so
every rank builds every subgroup, in one order (axis by axis, lines in
row-major order), when the mesh is made; an axis of size 1 gets none, and
a mesh over a subgroup of the world may split one axis only (its group is
then the mesh's own), because the ranks outside it would not join.

:func:`spawn_ranks` starts W processes, one a rank, each joining one group
initialized from a file store in a fresh temporary directory (no fixed TCP
port, so concurrent runs never collide), and returns what each rank's
function returned.  The children start with ``spawn``: a child that
touches CUDA must not be forked.  Every group gets a finite timeout, the
parent waits on the children with a time limit, and the first child to
raise stops the rest; its traceback is in the error.
"""

from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

# A rank that raises leaves its peers waiting in a collective: every group
# times out after this many seconds instead of hanging.
GROUP_TIMEOUT_S = 120.0


class Mesh:
    """A grid of ranks over one ``torch.distributed`` group.

    ``shape`` is an ordered ``{axis name: size}`` mapping (the JAX mesh's
    ``shape``); positions are numbered row-major over the axes, and
    position i is the group's rank i.  ``device`` is where this rank's
    tensors live (the card unless told otherwise).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], group=None, device=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ in length")
        if not dist.is_initialized():
            raise RuntimeError("the mesh needs an initialized torch.distributed group")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.group = group if group is not None else dist.group.WORLD
        world = dist.get_world_size(self.group)
        if world != self.size:
            raise ValueError(f"mesh {tuple(shape)} needs {self.size} ranks, the group has {world}")
        self.rank = dist.get_rank(self.group)
        self.backend = str(dist.get_backend(self.group))
        self.device = resolve_device(device)
        split = [ax for ax in self.axis_names if self.shape[ax] > 1]
        if self.group is not dist.group.WORLD and len(split) > 1:
            # dist.new_group is collective over WORLD: the ranks outside
            # this group would never join the subgroups' construction
            raise ValueError(f"a mesh over a subgroup splits at most one axis; {split} are split")
        self._axis_groups = {ax: self._build_axis_groups(ax) for ax in self.axis_names}

    def _build_axis_groups(self, axis: str):
        """This rank's subgroup along ``axis`` (every line's group is built
        on every rank, in row-major order of the other axes); None for an
        axis of size 1, over which nothing is reduced."""
        if self.shape[axis] == 1:
            return None
        if self.shape[axis] == self.size:
            return self.group
        mine = None
        for line in self.axis_lines(axis):
            ranks = [r if self.group is dist.group.WORLD else dist.get_global_rank(self.group, r)
                     for r in line]
            g = dist.new_group(ranks, backend=self.backend)
            if self.rank in line:
                mine = g
        return mine

    def axis_lines(self, axis: str) -> list[list[int]]:
        """The lines of ranks along ``axis``: group ranks that agree on every
        other axis, ordered by their index along ``axis``."""
        lines: dict[tuple, list[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            lines.setdefault(tuple(c[a] for a in self.axis_names if a != axis), []).append(r)
        return [lines[k] for k in sorted(lines)]

    def axis_group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis`` (``mesh.axis_group("model")``); None for an axis of
        size 1."""
        return self._axis_groups[axis]

    @property
    def size(self) -> int:
        """The number of positions (the JAX mesh's ``devices.size``)."""
        return math.prod(self.shape.values())

    def coords(self, rank: Optional[int] = None) -> dict[str, int]:
        """``{axis: index}`` of ``rank`` (default: this rank)."""
        rank = self.rank if rank is None else rank
        out = {}
        for ax in reversed(self.axis_names):
            rank, out[ax] = divmod(rank, self.shape[ax])
        return {ax: out[ax] for ax in self.axis_names}

    def axis_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """Row-major flattened index of ``rank`` over ``axes``."""
        c = self.coords(rank)
        idx = 0
        for ax in axes:
            idx = idx * self.shape[ax] + c[ax]
        return idx

    def axis_perm(self, axes: Sequence[str], pairs) -> list[tuple[int, int]]:
        """Group ranks of a permutation along ``axes``: each ``(i, j)`` of
        ``pairs`` (flattened indices over ``axes``) sends from index i to
        index j within every line of ranks that agree on the other axes --
        what ``jax.lax.ppermute`` over ``axes`` does."""
        axes = tuple(axes)
        lines: dict[tuple, dict[int, int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            lines.setdefault(key, {})[self.axis_index(axes, r)] = r
        return [(line[i], line[j]) for line in lines.values() for i, j in pairs]


def make_production_mesh(*, multi_pod: bool = False, group=None, device=None) -> Mesh:
    """The production mesh over the initialized group, or its scaled-down
    stand-in with the same axis names when there are fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size(group if group is not None else dist.group.WORLD)
    need = 512 if multi_pod else 256
    if world < need:
        shape = (2, 2, world // 4) if multi_pod else (2, world // 2)
    return Mesh(shape, axes, group, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), group=None, device=None) -> Mesh:
    """A small mesh over the initialized group, which must have
    ``prod(shape)`` ranks."""
    return Mesh(shape, axes, group, device)


# ---------------------------------------------------------------------------
# Starting the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, fn, world, backend, init_file, out_dir, args):
    """One child: join the group, run ``fn(*args)``, save its result."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_ranks(
    fn: Callable,
    world: int,
    *,
    backend: str = "gloo",
    args: tuple = (),
    timeout: float = 600.0,
) -> list:
    """Run ``fn(*args)`` on ``world`` new processes, one group of ``world``
    ranks, and return their results in rank order.

    ``fn`` must be importable by the children (a module-level function).
    Raises ``RuntimeError`` with the traceback of the first rank that
    raised (the others are stopped), or ``TimeoutError`` when the ranks
    have not all finished within ``timeout`` seconds (all are stopped).
    """
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        init_file = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world, backend, init_file, tmp, args),
            nprocs=world, join=False, start_method="spawn",
        )
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        try:
            while not ctx.join(timeout=max((deadline - datetime.datetime.now()).total_seconds(), 0.1)):
                if datetime.datetime.now() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} did not finish "
                                       f"within {timeout:.0f} s")
        except mp.ProcessRaisedException as exc:
            raise RuntimeError(f"rank {exc.error_index} of {fn.__name__} failed:\n{exc}") from None
        except mp.ProcessExitedException as exc:
            raise RuntimeError(f"rank {exc.error_index} of {fn.__name__} exited "
                               f"with code {exc.exit_code}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
