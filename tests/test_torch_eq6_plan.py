"""The launch plans of the eq. (6) kernels and of the attention kernels' flat
grid (``repro_torch.kernels.launch_plan``; ``csrc/consensus_network.cu``,
``csrc/consensus_sparse.cu``, ``csrc/consensus_row.cu``,
``csrc/flash_attention*.cu``), checked on the CPU, and the masked wrappers'
mask handling against the JAX package.

The CUDA kernels run only on the card; what surrounds them runs here: the
constants and choices the C++ makes (read back from the sources), the load
width chosen from the pointers and the row stride, and each kernel's walk
over its work, emulated from the C++ index arithmetic: every (agent, lane)
is written exactly once, with the grid at most one wave (132 SMs).  The
masked plain versions (what a CPU tensor runs) take bool, int and float
masks as the JAX package does: at f32 rtol 1e-6 / atol 1e-6 (another fp32
reduction order), at bf16 one wire ulp of the output scale; idle rows
bitwise their inputs.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import flat as jflat  # noqa: E402
from repro.core.graphs import bidirectional_ring_w  # noqa: E402
from repro.gossip.clocks import PoissonClock  # noqa: E402
from repro_torch.kernels import consensus as tk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import launch_plan as lp  # noqa: E402

CSRC = Path(tk.__file__).resolve().parent / "csrc"
SMS = 132  # H100 SXM
BASE = 1 << 20  # an address aligned to 16 bytes
SHAPES = [(9, 199_210), (300, 4_099), (70_000, 3), (1, 5)]  # (N, P)
WAVES = [SMS * 8, SMS, 7]  # a full card, one block an SM, a grid that walks many items


def _constants(name: str) -> dict[str, int]:
    src = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


def test_plan_constants_are_the_kernels():
    dense = _constants("consensus_network.cu")
    assert (dense["SMALL_N_MAX"], dense["SMALL_THREADS"], dense["SMALL_LANES"],
            dense["GENERIC_TILE"]) == (lp.SMALL_N_MAX, lp.SMALL_THREADS, lp.SMALL_LANES,
                                       lp.GENERIC_TILE)
    found = re.search(r"kInstances\[\] = \{([\d, ]+)\}",
                      (CSRC / "consensus_network.cu").read_text())
    assert tuple(int(x) for x in found.group(1).split(",")) == lp.SMALL_INSTANCES
    assert max(lp.SMALL_INSTANCES) == lp.SMALL_N_MAX
    sparse = _constants("consensus_sparse.cu")
    assert (sparse["THREADS"], sparse["GROUP"], sparse["SPARSE_TILE"],
            sparse["STAGE_N_MAX"]) == (lp.SPARSE_THREADS, lp.GROUP, lp.SPARSE_TILE,
                                       lp.STAGE_N_MAX)
    # the staged terms of STAGE_N_MAX rows fill the 48 KB a block has without opting in
    assert 2 * lp.STAGE_N_MAX * lp.SPARSE_TILE * 4 == 48 * 1024
    x, at, other = re.search(r"static constexpr int WARPS = HD == (\d+) \? (\d+) : (\d+);",
                             (CSRC / "flash_attention.cu").read_text()).groups()
    assert {hd: bq for hd, (bq, _) in fa.F32_TILES.items()} == {
        hd: 16 * int(at if hd == int(x) else other) for hd in fa.HEAD_DIMS}
    assert {bq for bq, _ in fa.TC_TILES.values()} == {
        int(re.search(r"static constexpr int BQ = (\d+);",
                      (CSRC / "flash_attention_tc.cu").read_text()).group(1))}


@pytest.mark.parametrize("p,ptrs,vec", [
    (199_210, (BASE, BASE + 4 * 199_210), 2),  # odd rows 8 bytes off 16: no float4
    (199_210, (BASE, BASE), 2),  # even with every base 16-byte aligned
    (4_096, (BASE, BASE + 16, BASE + 4096 * 4), 4),
    (4_098, (BASE, BASE + 32), 2),
    (4_099, (BASE, BASE), 1),  # odd P: every other row 4 bytes off 8
    (4_096, (BASE, BASE + 8), 2),  # a base 8 bytes off 16
    (4_096, (BASE, BASE + 4), 1),
])
def test_row_vector_width_from_pointers_and_row_stride(p, ptrs, vec):
    assert lp.row_vector_width(p, *ptrs) == vec
    for row in range(4):  # every row of every buffer is aligned to the width
        assert all((ptr + 4 * p * row) % (4 * vec) == 0 for ptr in ptrs)


def test_small_or_generic_as_the_kernel_chooses():
    # consensus_network.cu dense_instance: the first of kInstances that holds n, else 0
    for n in range(1, 40):
        want = next((nb for nb in (1, 2, 4, 8, 9, 16) if n <= nb), 0)
        assert lp.dense_instance(n) == want
    assert lp.dense_instance(9) == 9  # the 3x3 grid runs its exact instance
    assert [lp.sparse_staged(n) for n in (1, 9, 24, 25, 300, 70_000)] == [
        True, True, True, False, False, False]
    with pytest.raises(ValueError):
        lp.dense_instance(0)


def test_balanced_grid_at_the_slice():
    # 779 tiles of 256 lanes at P = 199,210 on 660 resident blocks: 390 blocks
    # of two tiles each, not 660 of which 119 walk a second tile
    plan = lp.sparse_plan(9, 199_210, 2, True, 660)
    assert (plan.items, plan.grid) == (779, 390)
    assert lp.sparse_plan(9, 199_210, 2, True, 1056).grid == 779  # one tile a block
    small = lp.dense_plan(9, 199_210, 2, 9, 132 * 6)
    assert (small.items, small.grid, small.vec) == (99_605, 779, 2)


def test_plans_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        lp.dense_plan(9, 5, 1, 16, SMS)  # N = 9 runs instance 9
    with pytest.raises(ValueError):
        lp.dense_plan(17, 5, 1, 16, SMS)  # no small instance holds 17 rows
    with pytest.raises(ValueError):
        lp.sparse_plan(25, 5, 1, True, SMS)  # 25 rows of terms exceed 48 KB
    for args in ((9, 5, 3, 9, SMS), (9, 5, 1, 9, 0), (0, 5, 1, 0, SMS), (9, 0, 1, 9, SMS)):
        with pytest.raises(ValueError):
            lp.dense_plan(*args)
    lp.dense_plan(300, 5, 1, 0, SMS)  # the generic path takes any N
    lp.sparse_plan(70_000, 3, 1, False, SMS)


def _grid_stride(items: int, threads: int, grid: int) -> np.ndarray:
    """Every item a grid-stride loop visits, once per visit: thread t of
    block b takes b * threads + t, then + grid * threads, ..."""
    stride = grid * threads
    starts = np.arange(min(stride, items), dtype=np.int64)
    iters = -(-items // stride)
    ks = starts[:, None] + stride * np.arange(iters, dtype=np.int64)[None, :]
    return ks[ks < items]


def _block_stride(items: int, grid: int) -> np.ndarray:
    """Every item block b visits in ``for (x = b; x < items; x += grid)``."""
    return np.concatenate([np.arange(b, items, grid, dtype=np.int64) for b in range(grid)])


def _assert_each_once(agents: np.ndarray, lanes: np.ndarray, n: int, p: int) -> None:
    keep = lanes < p
    flat = agents[keep] * p + lanes[keep]
    assert flat.size == n * p and np.array_equal(np.sort(flat), np.arange(n * p))


def _group_lanes(agents, groups, width=lp.GROUP):
    """(agent, lane) of each of the ``width`` lanes of lane groups ``groups``."""
    lanes = (width * groups)[:, None] + np.arange(width)[None, :]
    return np.repeat(agents, width).reshape(lanes.shape), lanes


def _assert_balanced(plan, wave):
    """At most one wave, and every block walks the same number of blocks'
    worth of items, one more for some."""
    blocks = -(-plan.items // plan.threads)
    assert 1 <= plan.grid <= min(wave, blocks)
    share = -(-blocks // plan.grid)
    assert share == -(-blocks // wave) and (share - 1) * plan.grid < blocks <= share * plan.grid


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("n,p", SHAPES)
def test_dense_walks_cover_every_lane_once(n, p, wave):
    # small path: thread g owns lanes 2 g, 2 g + 1 of every row
    for instance in ([lp.dense_instance(n)] if lp.dense_instance(n) else []) + [0]:
        plan = lp.dense_plan(n, p, 4, instance, wave)
        assert plan.instance == instance and plan.vec == lp.SMALL_LANES
        if instance:
            _assert_balanced(plan, wave)
            gs = _grid_stride(plan.items, plan.threads, plan.grid)
            rows = np.arange(n)
            agents, lanes = _group_lanes(np.repeat(rows, gs.size), np.tile(gs, n),
                                         lp.SMALL_LANES)
        else:  # generic: block b owns tiles b, b + grid, ...; thread t lane tile * 256 + t
            _assert_balanced(dataclasses.replace(plan, threads=1), wave)
            tiles = _block_stride(plan.items, plan.grid)
            cols = (tiles[:, None] * lp.GENERIC_TILE + np.arange(lp.GENERIC_TILE)).ravel()
            agents, lanes = np.repeat(np.arange(n), cols.size), np.tile(cols, n)
        _assert_each_once(agents.ravel(), lanes.ravel(), n, p)


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("n,p", SHAPES)
def test_sparse_walks_cover_every_agent_lane_once(n, p, wave):
    groups = -(-p // lp.GROUP)
    # gather: flat item k -> agent k // G, group k % G, any N
    plan = lp.sparse_plan(n, p, 1, False, wave)
    assert plan.items == n * groups
    _assert_balanced(plan, wave)
    ks = _grid_stride(plan.items, plan.threads, plan.grid)
    agents, lanes = _group_lanes(ks // groups, ks % groups)
    _assert_each_once(agents.ravel(), lanes.ravel(), n, p)
    if not lp.sparse_staged(n):
        return
    # staged: block b owns tiles b, b + grid, ...; in a tile, item k -> row k // 64,
    # group tile * 64 + k % 64, walked by the block's threads (staging, then gathering)
    plan = lp.sparse_plan(n, p, 1, True, wave)
    assert plan.items == -(-p // lp.SPARSE_TILE)
    _assert_balanced(dataclasses.replace(plan, threads=1), wave)
    tiles = _block_stride(plan.items, plan.grid)
    per_tile = _grid_stride(n * (lp.SPARSE_TILE // lp.GROUP), plan.threads, 1)
    tg = lp.SPARSE_TILE // lp.GROUP
    rows = np.tile(per_tile // tg, tiles.size)
    gs = (tiles[:, None] * tg + per_tile[None, :] % tg).ravel()
    agents, lanes = _group_lanes(rows, gs)
    _assert_each_once(agents.ravel(), lanes.ravel(), n, p)


@pytest.mark.parametrize("bh,s,bq", [(70_000, 64, 64), (70_000, 300, 128), (1, 4_096, 128),
                                     (3, 320, 64), (70_000 * 32, 64, 64)])
def test_attention_flat_grid_decodes_every_head_and_tile_once(bh, s, bq):
    blocks = lp.attention_blocks(bh, s, bq)
    n_qt = -(-s // bq)
    assert blocks == bh * n_qt
    x = np.arange(blocks, dtype=np.int64)
    head, tile = (x % bh, n_qt - 1 - x // bh)  # the C++ decode
    for i in (0, blocks // 2, blocks - 1):
        assert lp.attention_block(int(i), bh, n_qt) == (int(head[i]), int(tile[i]))
    assert np.array_equal(np.sort(head * n_qt + tile), np.arange(blocks))
    # heaviest causal tiles first: each head's last tile precedes any head's earlier tile
    assert np.all(tile[:bh] == n_qt - 1) and np.all(np.diff(tile) <= 0)


def test_attention_grid_refuses_past_a_one_dimensional_grid():
    assert lp.attention_blocks(2 ** 24 - 1, 128 * 128, 128) == (2 ** 24 - 1) * 128
    with pytest.raises(ValueError):
        lp.attention_blocks(2 ** 24, 128 * 128, 128)  # 2^31 blocks
    with pytest.raises(ValueError):
        lp.attention_blocks(0, 64, 64)


# -- eq. (6) for one agent's row (csrc/consensus_row.cu) ----------------------

ROW_P = [5, 4_099, 199_210]  # ragged: odd, odd, the slice's


def test_row_plan_constants_are_the_kernel():
    src = (CSRC / "consensus_row.cu").read_text()
    row = _constants("consensus_row.cu")
    assert (row["TILE"], row["ROW_N_MAX"]) == (lp.GENERIC_TILE, lp.ROW_N_MAX)
    # row_instance: n itself up to ROW_N_MAX, else the generic kernel
    assert "return n <= ROW_N_MAX ? n : 0;" in src
    assert "make_integer_sequence<int, ROW_N_MAX>" in src  # an instance for each N


def test_row_instance_by_row_length():
    got = [lp.row_instance(n) for n in (1, 2, 5, 9, 16, 17, 300)]
    assert got == [1, 2, 5, 9, 16, 0, 0]
    for n in range(1, 40):
        assert lp.row_instance(n) == (n if n <= 16 else 0)
    with pytest.raises(ValueError):
        lp.row_instance(0)


def test_row_plan_at_the_slice():
    # 779 tiles of 256 lanes at P = 199,210: one a block where 6 blocks an SM fit,
    # two for most blocks where 3 do (390 blocks, not 396 of which 383 walk two)
    plan = lp.row_plan(9, 199_210, 9, SMS * 6)
    assert (plan.instance, plan.vec, plan.items, plan.threads, plan.grid) == (
        9, 1, 779, 256, 779)
    assert lp.row_plan(9, 199_210, 9, SMS * 3).grid == 390
    assert lp.row_plan(9, 199_210, 0, SMS * 8).grid == 779
    assert lp.row_plan(300, 4_099, 0, SMS).grid == 17


def test_row_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        lp.row_plan(9, 8, 16, SMS)  # N = 9 runs instance 9
    for instance in (16, 17):  # N = 17 runs the generic kernel
        with pytest.raises(ValueError):
            lp.row_plan(17, 8, instance, SMS)
    for args in ((9, 8, 9, 0), (0, 8, 0, SMS), (9, 0, 9, SMS), (2 ** 31, 8, 0, SMS),
                 (2 ** 40, 2 ** 23, 0, SMS)):
        with pytest.raises(ValueError):
            lp.row_plan(*args)
    lp.row_plan(70_000, 3, 0, SMS)  # the generic path takes any N


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("p", ROW_P)
@pytest.mark.parametrize("n", [1, 9, 16])
def test_row_walks_cover_every_lane_once(n, p, wave):
    # block b owns tiles b, b + grid, ...; thread t lane tile * 256 + t, on both paths
    for instance in (lp.row_instance(n), 0):
        plan = lp.row_plan(n, p, instance, wave)
        assert plan.instance == instance and plan.threads == lp.GENERIC_TILE
        _assert_balanced(dataclasses.replace(plan, threads=1), wave)
        tiles = _block_stride(plan.items, plan.grid)
        lanes = (tiles[:, None] * lp.GENERIC_TILE + np.arange(lp.GENERIC_TILE)).ravel()
        _assert_each_once(np.zeros(lanes.size, dtype=np.int64), lanes, 1, p)


# -- the masked wrappers' mask handling against the JAX package ---------------

MASKS = {"bool": np.bool_, "int": np.int32, "float": np.float32}
WIRE_EPS = {"f32": 0.0, "bf16": 2.0 ** -7}


def _window_inputs(seed):
    win = PoissonClock(bidirectional_ring_w(6), rate=0.7, seed=2).window(0)
    assert 0 < win.active.sum() < 6
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(6, 130)).astype(np.float32)
    rho = rng.uniform(-4.5, 0.5, size=(6, 130)).astype(np.float32)
    return win, mean, rho


def _as_dtype(active: np.ndarray, kind: str) -> np.ndarray:
    """The mask in ``kind``; int and float masks carry values above 1 too
    (2 and 2.5: active in both the reference's ``> 0`` and its ``!= 0``)."""
    if kind == "bool":
        return active.copy()
    scale = np.where(np.arange(active.size) % 2 == 0, 1.0, 2.5 if kind == "float" else 2)
    return (active * scale).astype(MASKS[kind])


def _close(got, want, wire):
    if wire == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        u = WIRE_EPS[wire]
        np.testing.assert_allclose(got, want, rtol=u, atol=u * np.abs(want).max())


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(MASKS))
@pytest.mark.parametrize("form", ["dense", "csr"])
def test_masked_plain_versions_take_bool_int_and_float_masks(form, kind, wire):
    win, mean, rho = _window_inputs(seed=len(kind))
    mask = _as_dtype(win.active, kind)
    layout = jflat.FlatLayout.for_pytree({"w": jnp.zeros((mean.shape[1],))})
    jpost = jflat.FlatPosterior(mean=jnp.asarray(mean), rho=jnp.asarray(rho), layout=layout)
    m_t, r_t = torch.from_numpy(mean), torch.from_numpy(rho)
    if form == "dense":
        W = win.w_eff.astype(np.float32)
        want = jflat.consensus_flat_masked(jpost, jnp.asarray(W), jnp.asarray(mask),
                                           mode="xla", wire_dtype=wire)
        got = tk.consensus_fused_masked(torch.from_numpy(W), torch.from_numpy(mask), m_t, r_t,
                                        wire_dtype=wire)
    else:
        nbr, wts = jflat.neighbor_tables(win.w_eff)
        want = jflat.consensus_flat_masked_sparse(
            jpost, jnp.asarray(nbr), jnp.asarray(wts), jnp.asarray(mask), mode="interpret",
            block=128, wire_dtype=wire)
        got = tk.consensus_fused_masked_sparse(torch.from_numpy(nbr), torch.from_numpy(wts),
                                               torch.from_numpy(mask), m_t, r_t,
                                               wire_dtype=wire)
    _close(got[0].numpy(), np.asarray(want.mean), wire)
    _close(got[1].numpy(), np.asarray(want.rho), wire)
    idle = ~win.active
    assert np.array_equal(got[0].numpy()[idle], mean[idle])
    assert np.array_equal(got[1].numpy()[idle], rho[idle])
    # the same mask as bool gives the same bits: the dtype only decides activity
    ref = (tk.consensus_fused_masked(torch.from_numpy(win.w_eff.astype(np.float32)),
                                     torch.from_numpy(win.active), m_t, r_t, wire_dtype=wire)
           if form == "dense" else
           tk.consensus_fused_masked_sparse(torch.from_numpy(nbr), torch.from_numpy(wts),
                                            torch.from_numpy(win.active), m_t, r_t,
                                            wire_dtype=wire))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_mask_handling_keeps_a_bool_mask_and_converts_the_rest():
    act = torch.tensor([True, False, True])
    assert tk._as_mask(act, 3, torch.device("cpu")) is act  # no cast, no copy
    for other in (torch.tensor([1, 0, 2]), torch.tensor([0.5, 0.0, 3.0]), np.array([1, 0, 1]),
                  [True, False, True]):
        got = tk._as_mask(other, 3, torch.device("cpu"))
        assert got.dtype == torch.bool and got.tolist() == [True, False, True]
    assert tk._as_mask(torch.tensor([-1, 0, 1]), 3, torch.device("cpu")).tolist() == [
        False, False, True]
    with pytest.raises(ValueError, match="active mask"):
        tk._as_mask(act, 4, torch.device("cpu"))


# -- eq. (6) over a ragged term list (csrc/consensus_segments.cu) --------------

SEG_N = [1, 9, 4_200, 70_000]
SEG_P = [5, 4_099, 199_210]


def test_segments_plan_constants_are_the_kernel():
    seg = _constants("consensus_segments.cu")
    src = (CSRC / "consensus_segments.cu").read_text()
    seg.update({k: int(v) for k, v in re.findall(r"#define SEGMENT_(\w+) (\d+)", src)})
    assert (seg["THREADS"], seg["CHUNK_LANES"], seg["COPY_TILE"]) == (
        lp.SEGMENT_THREADS, lp.SEGMENT_CHUNK_LANES, lp.SEGMENT_COPY_TILE)
    shipped = src[:src.index("#if SEGMENT_PROBE_LANES  //")]  # probe builds add 2 and 8
    assert [int(x) for x in re.findall(r"consensus_segments_tile_kernel<HIST, WIRE, WP, (\d)>",
                                       shipped)] == [1, lp.SEGMENT_LANES]
    # the walk _segment_items emulates
    for line in ("constexpr int TILE = THREADS * L;",
                 "const long long copied = (n - n_active) * copies;",
                 "const long long items = tiled + copied;",
                 "const long long step_q = grid * copied / items;",
                 "long long q = blockIdx.x * copied / items;",
                 "x += grid, q += step_q + (rem >= items - step_r),",
                 "rem += step_r - (rem >= items - step_r ? items : 0)) {",
                 "if (rem >= items - copied) {",
                 "const long long ri = quotient(q, copies);",
                 "const long long c0 = (q - ri * copies) * COPY_TILE;",
                 "const long long row = order[n_active + ri];",
                 "const long long ri = quotient(x - q, tiles);",
                 "const long long c0 = (x - q - ri * tiles) * TILE;",
                 "const long long row = order != nullptr ? order[ri] : ri;",
                 "const int lane = threadIdx.x * L;"):
        assert line in src, line
    # the C++'s refusals: the pair instance needs P even, x and outputs 8 bytes, h two
    # elements; no order (or the lane kernel) means every row is tiled alike
    assert "const int h_pair = hist == HIST_F32 ? 8 : 4;" in src
    assert "(instance > 1 &&\n       (p % 2 != 0 || !aligned(x_mean, 8)" in src
    assert "((order == nullptr || instance == 0) && n_active != n)" in src
    assert "0x7fffffffffffffffLL / grid) ||" in src  # the carry's copied * grid < 2^63


def _segment_decode(plan, n, p, n_active, item):
    """(row position in the order, first lane, lanes) of tile-kernel items
    ``item``, from its C++ index arithmetic: item x is copy item
    floor(x C / T) where that floor steps up at x + 1, else tile item
    x - floor(x C / T)."""
    tile = lp.SEGMENT_THREADS * plan.instance
    tiles, copies = -(-p // tile), -(-p // lp.SEGMENT_COPY_TILE)
    copied = (n - n_active) * copies
    total = n_active * tiles + copied
    assert total == plan.items
    item = np.asarray(item, dtype=object)  # exact products
    q = item * copied // total
    copy = (item + 1) * copied // total > q
    k = np.where(copy, q, item - q).astype(np.int64)
    pos = np.where(copy, n_active + k // copies, k // tiles)
    c0 = np.where(copy, k % copies * lp.SEGMENT_COPY_TILE, k % tiles * tile)
    width = np.where(copy, lp.SEGMENT_COPY_TILE, tile)
    return pos, c0, np.minimum(width, p - c0)


def _segment_carry(plan, n, p, n_active, blocks, steps):
    """The kernel's carried (q, x copied mod items) over ``steps`` steps of
    blocks ``blocks``, against the exact products."""
    tile = lp.SEGMENT_THREADS * plan.instance
    copied = (n - n_active) * -(-p // lp.SEGMENT_COPY_TILE)
    items = n_active * -(-p // tile) + copied
    grid = plan.grid
    step_q, step_r = divmod(grid * copied, items)
    for b in blocks:
        q, rem = divmod(b * copied, items)
        for x in range(b, min(items, b + steps * grid), grid):
            assert (q, rem) == divmod(x * copied, items)
            assert (rem >= items - copied) == ((x + 1) * copied // items > q)
            carry = rem >= items - step_r
            q, rem = q + step_q + carry, rem + step_r - (items if carry else 0)


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("p", SEG_P)
@pytest.mark.parametrize("n", SEG_N)
def test_segments_walk_covers_every_row_lane_once(n, p, wave):
    """Block b takes items b, b + grid, ...: the tile items of the rows
    with terms (in the order) and the copy items of the idle rows spread
    among them, the kernel's carried quotient exact; each row's tiles cover
    its lanes once, and a tile's threads its lanes.  Every item is
    decoded up to 4M lanes; above, the first and last item of each kind."""
    for instance in (0, 1) + ((lp.SEGMENT_LANES,) if p % 2 == 0 else ()):
        for n_active in ([n] if instance == 0 else sorted({n, n // 3, 0})):
            plan = lp.segments_plan(n, p, instance, wave, None if instance == 0 else n_active)
            _assert_balanced(dataclasses.replace(plan, threads=1)
                             if instance else plan, wave)
            if instance == 0:  # PR 19's lane kernel: one lane a thread, grid-stride
                assert plan.items == n * p and plan.threads == lp.SEGMENT_THREADS
                if n * p <= 2_000_000:
                    ks = _grid_stride(plan.items, plan.threads, plan.grid)
                    _assert_each_once(ks // p, ks % p, n, p)
                continue
            assert plan.vec == instance
            _segment_carry(plan, n, p, n_active, {0, plan.grid // 2, plan.grid - 1}, 200)
            if n * p <= 4_000_000:  # every block's items, decoded
                item = _block_stride(plan.items, plan.grid)
                pos, c0, ln = _segment_decode(plan, n, p, n_active, item)
                assert (ln > 0).all()
                rows = np.repeat(pos, ln)
                lanes = np.repeat(c0 - np.cumsum(ln) + ln, ln) + np.arange(ln.sum())
                _assert_each_once(rows, lanes, n, p)
            else:  # the first and last item of each kind
                pos, c0, ln = _segment_decode(plan, n, p, n_active, [0, plan.items - 1])
                assert pos.min() == 0 and c0[0] == 0 and (ln > 0).all()
                assert pos[-1] == (n - 1 if n_active < n else n_active - 1)
                assert c0[-1] + ln[-1] == p
            # a tile's threads: lane = t L and min(L, len - lane) lanes from there (whole
            # pairs for L > 1, P being even)
            first = np.arange(lp.SEGMENT_THREADS) * instance
            tile = lp.SEGMENT_THREADS * instance
            for ln in {min(tile, p), p - (-(-p // tile) - 1) * tile}:
                live = first[first < ln]
                lanes = np.minimum(instance, ln - live)
                assert instance == 1 or (lanes % 2 == 0).all()
                got = np.concatenate([a + np.arange(k) for a, k in zip(live, lanes)])
                assert np.array_equal(np.sort(got), np.arange(ln))


@pytest.mark.parametrize("seed", range(4))
def test_segments_order_puts_the_rows_with_terms_first(seed):
    """ragged_terms' order: a permutation of the rows, the rows with terms
    first (most terms first, ties in row order), then the idle rows in row
    order; n_active counts the first."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    e = int(rng.integers(0, 4 * n))
    terms = lp.ragged_terms(n, rng.integers(0, n, e), rng.integers(0, 2 * n, e),
                            rng.uniform(0.1, 1, e), rng.random(n) < 0.7)
    counts = np.diff(terms.row_ptr)
    order, a = terms.order, terms.n_active
    assert order.dtype == np.int32 and np.array_equal(np.sort(order), np.arange(n))
    assert a == int((counts > 0).sum()) and (counts[order[:a]] > 0).all()
    assert (counts[order[a:]] == 0).all() and np.array_equal(order[a:], np.sort(order[a:]))
    busy = order[:a]
    assert all(counts[x] > counts[y] or (counts[x] == counts[y] and x < y)
               for x, y in zip(busy, busy[1:]))


PAIRS = lp.SEGMENT_LANES


@pytest.mark.parametrize("p,x_ptrs,h_ptrs,h_bytes,want", [
    (199_210, (BASE, BASE + 4 * 199_210), (BASE,), 4, PAIRS),  # the slice: odd rows 8 off 16
    (199_210, (BASE,), (BASE, BASE + 2 * 199_210), 2, PAIRS),  # bf16 rows 4 bytes aligned
    (199_210, (BASE,), (BASE + 2,), 2, 1),  # a ring view one element off
    (199_210, (BASE + 4,), (), 4, 1),  # an x view one lane off
    (4_099, (BASE,), (), 4, 1),  # odd P: every other row one lane off
    (4_099, (BASE,), (BASE,), 2, 1),
    (4_100, (BASE + 8,), (BASE + 8,), 4, PAIRS),  # 8 bytes is enough for a pair
    (4_100, (BASE,), (BASE + 4,), 4, 1),  # an f32 h row one lane off
    (6, (BASE,), (BASE + 4,), 2, PAIRS),  # a bf16 h view two elements off
])
def test_segments_lanes_from_pointers_and_row_stride(p, x_ptrs, h_ptrs, h_bytes, want):
    assert lp.segments_instance(p, x_ptrs, h_ptrs, h_bytes) == want
    if want > 1:  # every row of every buffer holds whole pairs
        for row in range(4):
            assert all((x + 4 * p * row) % 8 == 0 for x in x_ptrs)
            assert all((h + h_bytes * p * row) % (2 * h_bytes) == 0 for h in h_ptrs)


def test_segments_plan_at_the_delayed_slice():
    # 7 rows x 195 tiles of 1024 lanes, then 2 idle rows x 49 tiles of 4096, on 4 blocks
    # an SM: 1,463 items, 3 a block on 488 blocks
    plan = lp.segments_plan(9, 199_210, 4, SMS * 4, n_active=7)
    assert (plan.instance, plan.vec, plan.items, plan.threads, plan.grid) == (
        4, 4, 7 * 195 + 2 * 49, 256, 488)
    assert lp.segments_plan(9, 199_210, 1, SMS * 8).items == 9 * 779  # no order
    assert lp.segments_plan(4_200, 199_210, 4, SMS * 4, n_active=784).grid == SMS * 4
    lane = lp.segments_plan(9, 199_210, 0, SMS * 8)
    assert (lane.items, lane.grid) == (9 * 199_210, 1_001)


def test_segments_plan_refuses_what_the_kernel_does_not_take():
    for instance in (-1, 2, 3, 8):
        with pytest.raises(ValueError):
            lp.segments_plan(9, 8, instance, SMS)
    with pytest.raises(ValueError):
        lp.segments_plan(9, 4_099, lp.SEGMENT_LANES, SMS)  # odd P: no pairs
    for n_active in (-1, 10):
        with pytest.raises(ValueError):
            lp.segments_plan(9, 8, 1, SMS, n_active)
    for args in ((9, 8, 1, 0), (0, 8, 1, SMS), (9, 0, 1, SMS), (2 ** 31, 8, 1, SMS),
                 (2 ** 40, 2 ** 23, 1, SMS)):
        with pytest.raises(ValueError):
            lp.segments_plan(*args)
    lp.segments_plan(70_000, 3, 1, SMS)  # any N
