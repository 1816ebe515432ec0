"""3-D domain decomposition over a mesh of shards, and the ring shift.

The torch counterpart of ``repro.stencil.domain``. JAX's ``shard_map``
over a device mesh, with ``ppermute`` as the ring shift, becomes a
:class:`StencilMesh` that says which shards this process holds and moves
buffers between shards along one mesh axis:

- a *local* mesh (``group=None``) holds all px·py·pz shards in this
  process on one device, as ``shard_map`` holds them on a host mesh; the
  shift permutes the list of shards;
- a *process-group* mesh holds one shard per rank of an initialised
  ``torch.distributed`` group of world size px·py·pz (gloo for CPU
  tensors, NCCL for CUDA tensors); the shift is ``isend``/``irecv`` per
  pair, posted together and waited before it returns.

Shards are numbered as ``jax.make_mesh`` reshapes devices: the shard at
mesh coordinates (a, b, c) has rank ``a·py·pz + b·pz + c``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device

__all__ = ["STENCIL_AXES", "Decomposition3D", "StencilMesh",
           "make_stencil_mesh"]

STENCIL_AXES = ("dx", "dy", "dz")


@dataclass(frozen=True, eq=False)
class StencilMesh:
    """A px×py×pz mesh of shards, axes (dx, dy, dz) = (slab, row, col).

    shape:  (px, py, pz)
    device: where this process's shards live
    group:  the ``torch.distributed`` group carrying the shift, one shard
            per rank; ``None`` for a local mesh (every shard here)
    """
    shape: tuple[int, int, int]
    device: torch.device
    group: object = None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def rank_of(self, coords: tuple[int, int, int]) -> int:
        _, py, pz = self.shape
        a, b, c = coords
        return (a * py + b) * pz + c

    def coords_of(self, rank: int) -> tuple[int, int, int]:
        _, py, pz = self.shape
        return (rank // (py * pz), (rank // pz) % py, rank % pz)

    @property
    def shards(self) -> tuple[tuple[int, int, int], ...]:
        """Mesh coordinates of the shards this process holds, in rank
        order: every shard on a local mesh, this rank's on a group mesh."""
        if self.group is None:
            return tuple(self.coords_of(r) for r in range(self.size))
        return (self.coords_of(dist.get_rank(self.group)),)

    def shift(self, bufs: list[torch.Tensor], axis: int,
              pairs: list[tuple[int, int]], tag: int = 0) -> list[torch.Tensor]:
        """Ring shift along mesh ``axis`` — ``ppermute`` semantics.

        ``bufs`` holds one buffer per held shard (:attr:`shards` order),
        all of one shape. For each ``(src, dst)`` pair of positions along
        the axis (core.neighbors.ring_perms), the shard at ``dst``
        receives the buffer of the shard at ``src`` with the other two
        coordinates equal; a shard that no pair sends to receives zeros
        (open rings). ``tag`` tells apart two shifts between the same
        ranks (gloo matches by tag; NCCL by order, so every rank posts
        its operations in one order: sends, then receives).
        """
        src_of = {d: s for s, d in pairs}
        dst_of = {s: d for s, d in pairs}
        if self.group is None:
            held = {co: i for i, co in enumerate(self.shards)}
            out = []
            for i, co in enumerate(self.shards):
                q = src_of.get(co[axis])
                if q is None:
                    out.append(torch.zeros_like(bufs[i]))
                    continue
                src = list(co)
                src[axis] = q
                out.append(bufs[held[tuple(src)]])
            return out
        (co,), (buf,) = self.shards, bufs
        p = co[axis]

        def peer(pos: int) -> int:
            other = list(co)
            other[axis] = pos
            return dist.get_global_rank(self.group, self.rank_of(tuple(other)))

        q, d = src_of.get(p), dst_of.get(p)
        if q == p:  # a one-shard ring: torch.distributed refuses a send to self
            return [buf]
        ops = []
        if d is not None:
            ops.append(dist.P2POp(dist.isend, buf.contiguous(), peer(d),
                                  self.group, tag))
        recv = torch.zeros_like(buf)
        if q is not None:
            ops.append(dist.P2POp(dist.irecv, recv, peer(q), self.group, tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [recv]

    def all_gather(self, bufs: list[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard's buffer in rank order, on every process."""
        if self.group is None:
            return list(bufs)
        (buf,) = bufs
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf.contiguous(), group=self.group)
        return out


def make_stencil_mesh(shape: tuple[int, int, int], *, device="cuda",
                      group=None) -> StencilMesh:
    """Mesh for the stencil app. Axis order (dx,dy,dz) = (slab,row,col).

    ``group=None`` holds every shard in this process on ``device``. A
    ``torch.distributed`` group must be initialised, of world size
    px·py·pz, with a backend that carries ``device``'s tensors (gloo for
    the CPU, NCCL for CUDA); anything else raises — a mesh never runs the
    shards of a group locally instead.
    """
    shape = tuple(int(s) for s in shape)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"mesh shape must be 3 positive ints, got {shape}")
    dev = resolve_device(device)
    if group is not None:
        if not dist.is_initialized():
            raise RuntimeError("a process-group mesh needs an initialised "
                               "torch.distributed process group")
        n, ws = int(np.prod(shape)), dist.get_world_size(group)
        if ws != n:
            raise ValueError(f"mesh shape {shape} has {n} shards but the "
                             f"process group has {ws} ranks")
        want = "gloo" if dev.type == "cpu" else "nccl"
        backend = str(dist.get_backend(group))
        if want not in backend:
            raise ValueError(f"{dev.type} shards need a {want} group, got "
                             f"backend {backend!r}")
    return StencilMesh(shape=shape, device=dev, group=group)


def _as_shape3(global_shape) -> tuple[int, int, int]:
    """Coerce a cube edge or per-axis extent triple to a 3-tuple."""
    if isinstance(global_shape, (int, np.integer)):
        return (int(global_shape),) * 3
    gk, gi, gj = (int(x) for x in global_shape)
    return (gk, gi, gj)


@dataclass(frozen=True)
class Decomposition3D:
    """Global domain split into P = px·py·pz local blocks.

    ``global_M`` is a cube edge (the paper's M³ domain) or a per-axis
    ``(Gk, Gi, Gj)`` extent triple — a non-cubic process grid such as
    4×2×1 decomposes a non-cubic global box into *cubic* local shards
    (the SFC machinery needs cubic power-of-2 local blocks; the global
    box may be any multiple of them, DESIGN.md §10).
    """
    global_M: "int | tuple[int, int, int]"
    procs: tuple[int, int, int]

    @property
    def global_shape(self) -> tuple[int, int, int]:
        return _as_shape3(self.global_M)

    @property
    def local_shape(self) -> tuple[int, int, int]:
        gk, gi, gj = self.global_shape
        px, py, pz = self.procs
        if gk % px or gi % py or gj % pz:
            raise ValueError(f"global shape {self.global_shape} does not "
                             f"divide over procs {self.procs}")
        return (gk // px, gi // py, gj // pz)

    def check_local_pow2_cube(self) -> int:
        """SFC orderings need the local block to be a 2^m cube."""
        lx, ly, lz = self.local_shape
        if not (lx == ly == lz):
            raise ValueError(f"local block must be cubic, got {self.local_shape}")
        m = int(lx).bit_length() - 1
        if (1 << m) != lx:
            raise ValueError(f"local edge must be a power of 2, got {lx}")
        return lx
