"""Launch plans of the two single-launch streaming kernels,
``csrc/payload_validity.cu`` and ``csrc/gauss_vi.cu``.

Both kernels stream a flat buffer of ``lanes`` float32 values (``N * P`` for
the validity check, ``P`` for sample + KL) in one launch:

* The buffer is cut into chunks of ``threads * groups * 4`` lanes.  Thread t
  of chunk c owns ``groups`` groups of 4 consecutive lanes: group u holds
  lanes ``4 * (c * threads * groups + u * threads + t) + j`` for j < 4, so a
  warp's loads of one group are one run of 512 contiguous bytes.
* A group is read with ``4 // vec`` loads of ``vec`` lanes (16, 8 or 4
  bytes): ``vec`` is the widest load every pointer of the call is aligned
  to.  Which lanes a thread owns, and so the order in which the KL kernel
  sums them, does not depend on ``vec``.
* The grid is at most one wave: ``sms * blocks_per_sm`` blocks, the card's
  SM count times the kernel's occupancy, and no more blocks than chunks.
  Block b takes chunks b, b + grid, ...
* The last block to finish (an arrival counter per stream, reset by that
  block) completes the reduction across chunks: the per-agent AND of the
  validity check, the KL sum in chunk order.

The kernels keep these constants and this arithmetic in C++; this module
keeps them where the CPU tests reach them (``tests/test_torch_stream_plan.py``
checks coverage, row attribution and the wave bound), and the wrappers take
``vec``, ``chunks`` and ``grid`` from here.  The launch functions refuse a
chunk size other than their own.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelShape:
    """Threads per block and 4-lane groups per thread of one kernel."""

    threads: int
    groups: int

    @property
    def chunk(self) -> int:
        """Lanes per chunk: the block's threads times 4 lanes a group."""
        return self.threads * self.groups * 4


# mean and rho: 8 lanes a thread, 64 bytes in flight before any arithmetic
VALIDITY = KernelShape(threads=512, groups=2)
# five inputs: 4 lanes a thread, 80 bytes in flight
SAMPLE_KL = KernelShape(threads=256, groups=1)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    vec: int     # lanes per load: 4, 2 or 1 (16, 8 or 4 bytes)
    chunk: int   # lanes per chunk
    chunks: int
    grid: int    # blocks, <= one wave


def vector_width(*ptrs: int) -> int:
    """The widest load (in float32 lanes) every address is aligned to."""
    for vec in (4, 2, 1):
        if all(p % (4 * vec) == 0 for p in ptrs):
            return vec
    raise ValueError("float32 buffers must be 4-byte aligned")


def plan(lanes: int, shape: KernelShape, vec: int, wave: int) -> StreamPlan:
    """The launch of ``shape``'s kernel over ``lanes`` values with loads of
    ``vec`` lanes, on a card that keeps ``wave`` of its blocks resident (SMs
    times blocks per SM)."""
    if lanes <= 0 or lanes >= 2 ** 63:
        raise ValueError(f"lanes = {lanes} outside [1, 2^63)")
    if vec not in (1, 2, 4):
        raise ValueError(f"vec = {vec}: loads are 1, 2 or 4 lanes")
    if wave <= 0:
        raise ValueError(f"no block of the kernel fits on the card (wave = {wave})")
    chunks = -(-lanes // shape.chunk)
    return StreamPlan(vec=vec, chunk=shape.chunk, chunks=chunks, grid=min(chunks, wave))


def chunk_rows(chunk_index: int, chunk: int, lanes: int, p: int) -> tuple[int, int]:
    """First and last row of ``[N, P]`` (``lanes = N * P``) that chunk
    ``chunk_index`` touches, as the validity kernel computes them."""
    first = chunk_index * chunk
    last = min(first + chunk, lanes) - 1
    return first // p, last // p
