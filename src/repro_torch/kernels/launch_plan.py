"""Launch plans of the eq. (6) kernels over ``[N, P]`` buffers
(``csrc/consensus_network.cu``, ``csrc/consensus_sparse.cu``,
``csrc/consensus_row.cu``) and the flat grid of the two attention kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_tc.cu``).

Eq. (6), dense W (``consensus_fused_network`` / ``_masked``):

* **small** (N <= ``SMALL_N_MAX``): thread t of block b owns the lane pair
  g = b * SMALL_THREADS + t (lanes 2 g, 2 g + 1) of every row, then
  g + grid * SMALL_THREADS, ...  It keeps the pair's (prec_x, pm_x) of all N
  rows in registers, so an instance is compiled per row count: N runs the
  smallest of ``SMALL_INSTANCES`` that holds it, with the rows past N
  skipped.  Loads are 8 bytes where every row allows it, else 4.
* **generic** (any N): a block owns a tile of ``GENERIC_TILE`` lanes, one a
  thread, tiles b, b + grid, ...; the input rows are staged in chunks.

Eq. (6), CSR tables (``consensus_fused_sparse`` / ``_masked_sparse``):

* **staged** (N <= ``STAGE_N_MAX``): a block owns a tile of
  ``SPARSE_TILE`` lanes (tiles b, b + grid, ...), computes every row's
  per-lane terms once into shared memory (2 N SPARSE_TILE floats, 48 KB at
  the cap) and then every (agent, lane group) of the tile gathers its slots
  from there.
* **gather** (any N): item k = i * G + g (agent i, lane group g of the
  ``G = ceil(P / 4)`` groups of a row) goes to thread k mod (grid *
  SPARSE_THREADS) of the flat grid; each agent gathers its rows from L2.
  Indexing by a flat 64-bit item has no 65535-agent limit.

Eq. (6) for one agent's row of W (``consensus_fused``, ``csrc/consensus_row.cu``):
both paths walk tiles of ``GENERIC_TILE`` lanes, one lane a thread (4-byte
loads at any alignment), block b taking tiles b, b + grid, ...

* **small** (N <= ``ROW_N_MAX``): a thread loads all N rows of its lane
  into registers before the arithmetic; an instance is compiled for each
  N, its loops unrolled over exactly N rows.
* **generic** (instance 0, N > 16 or forced): the first port's kernel, the
  row of W staged in shared memory.

Every plan's grid is at most one wave (the card's SM count times the
instance's blocks per SM), and gives every block the same number of
blocks' worth of work (at most one more): ``ceil(blocks / ceil(blocks /
wave))`` blocks, so no block walks a second tile while the others idle.  A
thread's lanes do not depend on the load width ``vec`` (4, 2 or 1 lanes:
16-, 8- or 4-byte loads, at most the lanes a thread owns), which is the
widest that every row of every buffer is aligned to: the base pointers and
the row stride of 4 P bytes (at P = 199,210 the odd rows lie 8 bytes off
16, so 8 bytes).

Attention: block index x of a 1-D grid of ``bh * n_qt`` blocks (``bh`` = B
H heads, ``n_qt`` query tiles) decodes to head ``x mod bh`` and query tile
``n_qt - 1 - x div bh``, so the heaviest causal tiles of every head go
first; the grid holds up to 2^31 - 1 blocks.

The C++ keeps these constants and choices itself and refuses a launch that
disagrees; this module keeps them where the CPU tests reach them
(``tests/test_torch_eq6_plan.py`` reads the constants back from the sources
and emulates the walks).
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import stream_plan

GROUP = 4  # lanes a thread owns on both CSR paths
SMALL_LANES = 2  # lanes a thread owns on the small dense path
SMALL_N_MAX = 16
SMALL_INSTANCES = (1, 2, 4, 8, 9, 16)  # exact at the 3x3 grid's N = 9
SMALL_THREADS = 128
GENERIC_TILE = 256  # lanes = threads per block
SPARSE_THREADS = 256
SPARSE_TILE = 256  # lanes of a staged tile: 64 groups
STAGE_N_MAX = 24  # 2 * 24 rows * 256 lanes * 4 bytes = 48 KB
GRID_MAX = 2 ** 31 - 1  # blocks of a 1-D grid
ATTN_F32_BQ = 64  # query rows per block of flash_attention.cu
ROW_N_MAX = 16  # consensus_row.cu: rows of the largest small instance


@dataclasses.dataclass(frozen=True)
class Eq6Plan:
    instance: int  # dense, row: rows of the small instance, 0 = generic; CSR: 1 staged, 0 gather
    vec: int       # lanes per load: 4, 2 or 1 (dense: 2 or 1)
    items: int     # what the grid walks: lane groups, tiles or (agent, lane group) pairs
    threads: int   # per block
    grid: int      # blocks, <= one wave


def row_vector_width(p: int, *ptrs: int) -> int:
    """The widest load (in float32 lanes) at which every row of ``[N, P]``
    buffers starting at ``ptrs`` is aligned: the pointers and the row
    stride ``4 P`` bytes must both be multiples of its bytes."""
    return stream_plan.vector_width(*ptrs, 4 * p)


def dense_instance(n: int) -> int:
    """The small instance (its row count) that runs ``n`` agents, or 0 for
    the generic path."""
    if n <= 0:
        raise ValueError(f"n = {n}: no agents")
    return next((nb for nb in SMALL_INSTANCES if nb >= n), 0)


def _groups(p: int) -> int:
    return -(-p // GROUP)


def _grid(blocks: int, wave: int) -> int:
    """At most ``wave`` blocks for ``blocks`` blocks' worth of work, each
    taking the same share (one more for some)."""
    if wave <= 0:
        raise ValueError(f"no block of the kernel fits on the card (wave = {wave})")
    return -(-blocks // -(-blocks // wave))


def _check(n: int, p: int, vec: int) -> None:
    if n <= 0 or p <= 0 or n >= 2 ** 31 or n * p >= 2 ** 63:
        raise ValueError(f"[N, P] = [{n}, {p}] outside the kernels' range")
    if vec not in (1, 2, 4):
        raise ValueError(f"vec = {vec}: loads are 1, 2 or 4 lanes")


def dense_plan(n: int, p: int, vec: int, instance: int, wave: int) -> Eq6Plan:
    """The dense eq. (6) launch: ``instance`` is ``dense_instance(n)`` or 0
    (the generic path runs any N)."""
    _check(n, p, vec)
    if instance and instance != dense_instance(n):
        raise ValueError(f"N = {n} runs the small instance {dense_instance(n)}, not {instance}")
    vec = min(vec, SMALL_LANES)
    if instance:
        items = -(-p // SMALL_LANES)
        return Eq6Plan(instance, vec, items, SMALL_THREADS,
                       _grid(-(-items // SMALL_THREADS), wave))
    items = -(-p // GENERIC_TILE)
    return Eq6Plan(0, vec, items, GENERIC_TILE, _grid(items, wave))


def sparse_staged(n: int) -> bool:
    """Does the CSR kernel stage every row's terms of a tile (the default
    for ``n`` agents)?"""
    return n <= STAGE_N_MAX


def sparse_plan(n: int, p: int, vec: int, staged: bool, wave: int) -> Eq6Plan:
    """The CSR eq. (6) launch, staged or gathering from L2."""
    _check(n, p, vec)
    if staged and n > STAGE_N_MAX:
        raise ValueError(f"N = {n}: a tile's terms of {n} rows do not fit shared memory")
    if staged:
        items = -(-p // SPARSE_TILE)
        return Eq6Plan(1, vec, items, SPARSE_THREADS, _grid(items, wave))
    items = n * _groups(p)
    return Eq6Plan(0, vec, items, SPARSE_THREADS, _grid(-(-items // SPARSE_THREADS), wave))


def row_instance(n: int) -> int:
    """The instance of ``csrc/consensus_row.cu`` that runs a row of ``n``
    weights: the small kernel for ``n`` up to ``ROW_N_MAX``, else 0 (the
    generic kernel)."""
    if n <= 0:
        raise ValueError(f"n = {n}: no agents")
    return n if n <= ROW_N_MAX else 0


def row_plan(n: int, p: int, instance: int, wave: int) -> Eq6Plan:
    """The one-agent eq. (6) launch: ``instance`` is ``row_instance(n)`` or
    0 (the generic path runs any N).  Both paths take 4-byte loads."""
    _check(n, p, 1)
    if instance and instance != row_instance(n):
        raise ValueError(f"N = {n} runs the row instance {row_instance(n)}, not {instance}")
    items = -(-p // GENERIC_TILE)
    return Eq6Plan(instance, 1, items, GENERIC_TILE, _grid(items, wave))


def attention_blocks(bh: int, s: int, bq: int) -> int:
    """Blocks of an attention kernel's flat grid: ``bh`` heads times the
    query tiles of ``bq`` rows; raises beyond a 1-D grid."""
    blocks = bh * -(-s // bq)
    if bh <= 0 or s <= 0 or blocks > GRID_MAX:
        raise ValueError(f"{bh} heads x {s} queries in tiles of {bq}: {blocks} blocks, "
                         f"outside [1, {GRID_MAX}]")
    return blocks


def attention_block(index: int, bh: int, n_qt: int) -> tuple[int, int]:
    """(head, query tile) of block ``index``, as the kernels decode it."""
    t, head = divmod(index, bh)
    return head, n_qt - 1 - t
