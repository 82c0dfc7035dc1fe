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

Eq. (6) over a ragged term list (``consensus_fused_segments``,
``csrc/consensus_segments.cu``, the gossip runtime's delayed and segment
windows): ``ragged_terms`` turns a window's parallel (dst, src, weight)
arrays into row offsets, source indices and weights sorted by destination
with a stable sort, so each row keeps the caller's summation order, in
O(E + N) host memory.  Zero-weight terms that repeat a row's source (the
``E_max - n_events`` pad slots of a window, all ``(0, 0)`` at weight 0)
collapse into the first of them: adding ``0 * x`` twice is adding it once,
``0 * NaN`` included.  Inactive rows get no terms.  ``segments_plan``:

* **tile** (instances 1 and ``SEGMENT_LANES`` = 4, the default): block b
  takes items b, b + grid, ...  The list's ``order`` puts the rows with
  terms first, those with most terms first: each gives tile items, one per
  tile of ``SEGMENT_THREADS * L`` lanes at L = instance lanes a thread, its
  terms staged ``SEGMENT_CHUNK_LANES / L`` at a time.  The idle rows after
  them give copy items, one per ``SEGMENT_COPY_TILE`` lanes, each copied by
  the whole block.  Item x is copy item floor(x C / T) where that floor steps up at
  x + 1 (C copy items of T), else tile item x - floor(x C / T): the copies
  spread evenly among the tiles.  Without an order every row takes tile
  items.  ``segments_instance`` picks L = ``SEGMENT_LANES`` (in pairs:
  8-byte x loads, 4-byte bf16/f16 loads) where every row of every buffer is
  aligned to a pair, else 1.
* **lane** (instance 0, PR 19's kernel, forced only): one lane a thread,
  item k = i * P + c walked grid-stride by a flat 64-bit index.

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

import numpy as np

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
ROW_N_MAX = 16  # consensus_row.cu: rows of the largest small instance
SEGMENT_THREADS = 256  # consensus_segments.cu: threads per block
SEGMENT_CHUNK_LANES = 8  # a chunk of terms times lanes a thread: loaded ahead, at a time
SEGMENT_LANES = 4  # lanes a thread on the tile kernel where the rows allow pairs, else 1
SEGMENT_COPY_TILE = 4096  # lanes of an idle row's item
INDEX_MAX = 2 ** 31 - 1  # int32 row offsets and source indices


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


@dataclasses.dataclass(frozen=True)
class RaggedTerms:
    """A destination-sorted term list: row i owns terms ``row_ptr[i] ..
    row_ptr[i + 1] - 1``, each a source row index and a weight; a row with
    no terms copies source row ``pass_src[i]`` (``None``: row i).
    ``order`` (``None``, or the rows with terms, most terms first, then the
    rows without, ``n_active`` of the first kind) is the kernel's walk; it
    does not change the bits.  Built on the host as numpy arrays;
    ``to(device)`` gives the same list as tensors there (a kernel call on
    device-resident terms copies nothing)."""

    row_ptr: "np.ndarray"  # [N + 1] int32
    src: "np.ndarray"  # [T] int32
    weight: "np.ndarray"  # [T] float32
    pass_src: "np.ndarray | None" = None  # [N] int32
    order: "np.ndarray | None" = None  # [N] int32
    n_active: "int | None" = None  # rows with terms (with an order)

    @property
    def n_rows(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def n_terms(self) -> int:
        return len(self.src)

    def to(self, device) -> "RaggedTerms":
        """The list as tensors on ``device`` (no copy of what is there)."""
        import torch

        def move(a):
            return None if a is None else torch.as_tensor(a).to(device)

        return RaggedTerms(move(self.row_ptr), move(self.src), move(self.weight),
                           move(self.pass_src), move(self.order), self.n_active)


def ragged_terms(n_rows: int, dst, src, weight, active=None, pass_src=None) -> RaggedTerms:
    """The term list of parallel ``dst``/``src``/``weight`` arrays, given in
    the order each row sums them: terms of rows not ``active`` dropped, a
    zero-weight term whose (row, source) an earlier zero-weight term of the
    row already holds dropped, the rest stably sorted by ``dst``."""
    dst = np.asarray(dst, np.int64).reshape(-1)
    src = np.asarray(src, np.int64).reshape(-1)
    weight = np.asarray(weight, np.float32).reshape(-1)
    if not dst.shape == src.shape == weight.shape:
        raise ValueError(f"dst {dst.shape}, src {src.shape}, weight {weight.shape} differ")
    if n_rows <= 0 or n_rows > INDEX_MAX or len(dst) > INDEX_MAX:
        raise ValueError(f"{n_rows} rows, {len(dst)} terms: outside int32 offsets")
    if len(dst) and (dst.min() < 0 or dst.max() >= n_rows):
        raise ValueError(f"destinations outside [0, {n_rows})")
    if len(src) and (src.min() < 0 or src.max() > INDEX_MAX):
        raise ValueError("source indices outside [0, 2^31)")
    keep = (np.ones(len(dst), bool) if active is None
            else np.asarray(active, bool).reshape(-1)[dst])
    zero = np.flatnonzero(keep & (weight == 0.0))
    if len(zero):
        _, first = np.unique(dst[zero] * (INDEX_MAX + 1) + src[zero], return_index=True)
        repeat = np.ones(len(zero), bool)
        repeat[first] = False
        keep[zero[repeat]] = False
    idx = np.flatnonzero(keep)
    by_dst = idx[np.argsort(dst[idx], kind="stable")]
    counts = np.bincount(dst[by_dst], minlength=n_rows)
    row_ptr = np.zeros(n_rows + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    if pass_src is not None:
        pass_src = np.asarray(pass_src, np.int32).reshape(n_rows)
    busy = np.flatnonzero(counts)
    order = np.concatenate([busy[np.argsort(-counts[busy], kind="stable")],
                            np.flatnonzero(counts == 0)]).astype(np.int32)
    return RaggedTerms(row_ptr=row_ptr, src=src[by_dst].astype(np.int32),
                       weight=weight[by_dst], pass_src=pass_src, order=order,
                       n_active=len(busy))


def segments_instance(p: int, x_ptrs, h_ptrs=(), h_bytes: int = 4) -> int:
    """The tile instance (lanes a thread) for ``[*, P]`` rows of x (float32,
    and the outputs) at ``x_ptrs`` and of h (``h_bytes`` an element) at
    ``h_ptrs``: ``SEGMENT_LANES``, loaded in pairs, where every row of every
    buffer is aligned to two of its elements (P even, each pointer so
    aligned), else 1."""
    pairs = p % 2 == 0 and all(x % 8 == 0 for x in x_ptrs)
    return SEGMENT_LANES if pairs and all(h % (2 * h_bytes) == 0 for h in h_ptrs) else 1


def segments_plan(n: int, p: int, instance: int, wave: int, n_active=None) -> Eq6Plan:
    """The ragged eq. (6) launch: ``instance`` 1 or ``SEGMENT_LANES``, the
    tile kernel with that many lanes a thread (``segments_instance``), over
    the ``n_active`` rows with terms and the idle rows after them in the
    list's order (None: no order, every row tiled alike); 0, PR 19's lane
    kernel."""
    _check(n, p, 1)
    if instance == 0:
        items = n * p
        return Eq6Plan(0, 1, items, SEGMENT_THREADS, _grid(-(-items // SEGMENT_THREADS), wave))
    if instance not in (1, SEGMENT_LANES):
        raise ValueError(f"segments instance {instance}: 0 (lane), 1 or {SEGMENT_LANES} "
                         "(lanes a thread)")
    if instance > 1 and p % 2:
        raise ValueError(f"P = {p}: {instance} lanes a thread need an even row length")
    n_active = n if n_active is None else n_active
    if not 0 <= n_active <= n:
        raise ValueError(f"{n_active} rows with terms of {n}")
    copied = (n - n_active) * -(-p // SEGMENT_COPY_TILE)
    items = n_active * -(-p // (SEGMENT_THREADS * instance)) + copied
    grid = _grid(items, wave)
    if copied * grid >= 2 ** 63:
        raise ValueError(f"{copied} copy items on {grid} blocks: past the kernel's carry")
    return Eq6Plan(instance, instance, items, SEGMENT_THREADS, grid)


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
