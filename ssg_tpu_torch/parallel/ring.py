"""Ring primitives over a mesh of ranks.

Counterpart of ``ssg_tpu/parallel/ring.py``. Rank p of P holds rows
``p*r:(p+1)*r`` of a global (N, N) or (N, D) array, its row stripe:

  * ``stripe_transpose`` -- row stripe of A -> row stripe of A^T, one
    all-to-all of the (r, r) blocks;
  * ``stripe_transpose_packed`` -- the same for bit-packed boolean stripes;
  * ``ring_pairwise`` -- acc[:, owner cols] = fn(A_mine, B_owner), the B
    stripes rotating past by one rank a visit;
  * ``ring_gather_sum`` -- out[i] = sum_t B[idx[i, t]] for row-sharded B;
  * ``ring_contract`` -- A_stripe @ B for B row-sharded on the contraction
    axis.

JAX's ``ppermute`` by one becomes ``shift``: an ``all_to_all_single`` with
one non-empty split each way, which gloo (on CPU and CUDA tensors) and
NCCL both carry. Every transfer goes as raw bytes, so no backend's support
for bool or bf16 is relied on. The visit order is JAX's, owner = (me - s)
% P, so sums accumulate in its order. Each function is collective: every
rank of the mesh calls it, with stripes of one shape.

The small collectives the sharded analytics use (``all_gather``,
``all_reduce``) are here too, in the same byte-safe form.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ssg_tpu_torch.ops.bits import pack_bits, unpack_bits


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def shift(mesh, x: torch.Tensor) -> torch.Tensor:
    """Rank me's ``x`` goes to rank me + 1; returns rank me - 1's (mod P)."""
    p, me = mesh.size, mesh.rank
    src = _bytes(x)
    out = torch.empty_like(src)
    nb = src.numel()
    send, recv = [0] * p, [0] * p
    send[(me + 1) % p] = nb
    recv[(me - 1) % p] = nb
    dist.all_to_all_single(out, src, recv, send, group=mesh.group)
    return out.view(x.dtype).view(x.shape)


def all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all), concatenated on the leading
    axis in rank order: JAX's tiled ``all_gather``. A mesh of one (or None)
    returns ``x``."""
    if mesh is None or mesh.size == 1:
        return x
    src = _bytes(x)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat([q.view(x.dtype).view(x.shape) for q in parts], 0)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(mesh, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """JAX's psum / pmax / pmin: a new tensor. Booleans reduce as uint8 (any
    by ``max``, all by ``min``). A mesh of one (or None) returns ``x``."""
    if mesh is None or mesh.size == 1:
        return x
    if x.dtype == torch.bool:
        return all_reduce(mesh, x.to(torch.int32), op).bool()
    out = x.clone()
    dist.all_reduce(out, op=_OPS[op], group=mesh.group)
    return out


def stripe_transpose(mesh, x: torch.Tensor) -> torch.Tensor:
    """Row stripe (r, P r) of A -> row stripe (r, P r) of A^T."""
    if mesh is None or mesh.size == 1:
        return x.T.contiguous()
    p = mesh.size
    r = x.shape[0]
    # Column block k of my stripe goes to rank k; I receive every rank's
    # block of my columns: (P, r_owner, r_mine) = A[:, my cols] by owner.
    blocks = x.reshape(r, p, r).transpose(0, 1)
    src = _bytes(blocks)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    cols = out.view(x.dtype).view(p * r, r)
    return cols.T.contiguous()


# Output rows a block of the local packed transpose (a multiple of 8).
_TRANSPOSE_BLOCK = 1024


def transpose_packed_block(x: torch.Tensor, rows: int) -> torch.Tensor:
    """Bit-packed (rows, cols // 8) boolean block -> packed transpose
    (cols, rows // 8), ``_TRANSPOSE_BLOCK`` output rows at a time: the bool
    transient is one (rows, block) slab."""
    cols = x.shape[1] * 8
    out = torch.empty((cols, rows // 8), dtype=torch.uint8, device=x.device)
    for i0 in range(0, cols, _TRANSPOSE_BLOCK):
        i1 = min(i0 + _TRANSPOSE_BLOCK, cols)
        out[i0:i1] = pack_bits(unpack_bits(x[:, i0 // 8:i1 // 8], i1 - i0).T)
    return out


def stripe_transpose_packed(mesh, x: torch.Tensor) -> torch.Tensor:
    """Bit-packed row stripe (r, P r // 8) of boolean A -> packed stripe of
    A^T. One all-to-all of the packed (r, r / 8) blocks, then each owner's
    block is transposed locally; requires r % 8 == 0."""
    if mesh is None or mesh.size == 1:
        return transpose_packed_block(x, x.shape[0])
    p = mesh.size
    r, rb = x.shape[0], x.shape[1] // p
    blocks = x.reshape(r, p, rb).transpose(0, 1)  # (P, r, rb): my rows x rank k's cols
    recv = torch.empty_like(_bytes(blocks))
    dist.all_to_all_single(recv, _bytes(blocks), group=mesh.group)
    recv = recv.view(p, r, rb)  # (owner, owner's rows, my cols)
    return torch.cat([transpose_packed_block(recv[k], r) for k in range(p)], 1)


def ring_pairwise(mesh, a: torch.Tensor, b: torch.Tensor,
                  pair_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """acc (r_a, P r) with acc[:, owner cols] = pair_fn(a, B_owner), fp32."""
    p, me = mesh.size, mesh.rank
    r = b.shape[0]
    acc = torch.empty((a.shape[0], p * r), dtype=torch.float32, device=a.device)
    block = b
    for s in range(p):
        owner = (me - s) % p
        acc[:, owner * r:(owner + 1) * r] = pair_fn(a, block)
        if s + 1 < p:
            block = shift(mesh, block)
    return acc


def gather_sum_visit(acc: torch.Tensor, idx: torch.Tensor, block: torch.Tensor,
                     row0: int) -> torch.Tensor:
    """acc += sum_t block[idx[:, t] - row0] where that row is in the block,
    t ascending (JAX's masked ``where`` adds exact zeros elsewhere)."""
    r = block.shape[0]
    loc = idx - row0
    hit = (loc >= 0) & (loc < r)
    for t in range(idx.shape[1]):
        g = block[loc[:, t].clamp(0, r - 1)]
        acc += torch.where(hit[:, t, None], g, 0.0)
    return acc


def ring_gather_sum(mesh, idx: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_t B[idx[i, t]] for B row-sharded as (r, M) stripes,
    accumulated visit by visit in ring order, t ascending within a visit."""
    p, me = mesh.size, mesh.rank
    r = b.shape[0]
    acc = torch.zeros((idx.shape[0], b.shape[1]), dtype=torch.float32, device=b.device)
    block = b
    for s in range(p):
        gather_sum_visit(acc, idx, block, ((me - s) % p) * r)
        if s + 1 < p:
            block = shift(mesh, block)
    return acc


def ring_contract(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A_stripe (r_a, P r) @ B (P r, M) with B row-sharded as (r, M)
    stripes, fp32 (a true-fp32 product for fp32 operands, TF32 off; bf16
    0/1 operands give exact counts)."""
    p, me = mesh.size, mesh.rank
    r = b.shape[0]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=b.device)
    block = b
    for s in range(p):
        owner = (me - s) % p
        acc += (a[:, owner * r:(owner + 1) * r] @ block).float()
        if s + 1 < p:
            block = shift(mesh, block)
    return acc


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of each rank's input is the sum of
    every rank's output gradient (each rank's output feeds its own share of
    one global loss)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(mesh, x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(ctx.mesh, grad.contiguous()), None


def all_reduce_sum_autograd(mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable all-reduce sum (the data-parallel BatchNorm's)."""
    return _AllReduceSum.apply(x, mesh)


class _GatherRows(torch.autograd.Function):
    """All-gather along ``dim`` in rank order. Every rank computes the same
    global loss from the gathered tensor, so the gradient of this rank's
    slice is its own slice of the output gradient: no reduction (summing
    the P identical copies would scale the gradient by P)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        moved = x.movedim(dim, 0).contiguous()
        return all_gather(mesh, moved).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.mesh.rank * ctx.size, ctx.size), None, None


def gather_rows(mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, differentiable; the
    caller computes one global loss from it on every rank."""
    if mesh is None or mesh.size == 1:
        return x
    return _GatherRows.apply(x, mesh, dim)
