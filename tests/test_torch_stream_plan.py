"""The launch plans of the single-launch streaming kernels
(``repro_torch.kernels.stream_plan``; ``csrc/payload_validity.cu`` and
``csrc/gauss_vi.cu``), checked on the CPU.

The CUDA kernels run only on the card; what surrounds them runs here: the
lane each thread owns, the vector width chosen from the pointers, the grid
(at most one wave at 132 SMs), each chunk's span over the rows of
``[N, P]``, the validity kernel's per-row verdicts through its last block,
and the KL kernel's summation order, emulated in numpy float32.

Bound of the KL emulation against the fp64 sum of the same float32 terms:
a sum of float32 values by a tree of depth d is within d * 2^-24 * sum|t|
of the exact sum (to first order); d counts the kernel's sequential adds,
shuffle levels and warp sums on the longest path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import gauss_vi  # noqa: E402
from repro_torch.kernels import stream_plan as sp  # noqa: E402

SMS = 132  # H100 SXM
BASE = 1 << 20  # an address aligned to 16 bytes
ALIGNMENTS = {16: (BASE, 4), 8: (BASE + 8, 2), 4: (BASE + 4, 1)}  # bytes -> (address, vec)
# (P, N): P from 1 to the slice's 199,210, N up to 70,000 where N * P stays enumerable
SHAPES = [(1, 1), (1, 70_000), (5, 9), (5, 70_000), (2_049, 9), (2_049, 300),
          (199_210, 1), (199_210, 9)]


def _lanes_by_chunk(shape: sp.KernelShape, chunks: np.ndarray) -> np.ndarray:
    """The lanes the kernel's threads own in ``chunks``, as in the C++:
    4 * (c * threads * groups + u * threads + t) + j."""
    c = chunks[:, None, None, None]
    u = np.arange(shape.groups)[None, :, None, None]
    t = np.arange(shape.threads)[None, None, :, None]
    j = np.arange(4)[None, None, None, :]
    return 4 * (c * shape.threads * shape.groups + u * shape.threads + t) + j


@pytest.mark.parametrize("kernel", ["validity", "sample_kl"])
@pytest.mark.parametrize("align", sorted(ALIGNMENTS))
@pytest.mark.parametrize("p,n", SHAPES)
def test_every_lane_is_covered_exactly_once(kernel, align, p, n):
    shape = sp.VALIDITY if kernel == "validity" else sp.SAMPLE_KL
    address, vec = ALIGNMENTS[align]
    lanes = n * p if kernel == "validity" else p
    got_vec = sp.vector_width(address, BASE)
    assert got_vec == vec
    for wave in (SMS * 4, 7):  # a full card, and a grid that walks many chunks a block
        plan = sp.plan(lanes, shape, got_vec, wave)
        assert 1 <= plan.grid <= min(plan.chunks, wave)
        assert plan.chunks * shape.chunk >= lanes > (plan.chunks - 1) * shape.chunk
        walked = np.concatenate([np.arange(b, plan.chunks, plan.grid) for b in range(plan.grid)])
        assert np.array_equal(np.sort(walked), np.arange(plan.chunks))  # each chunk once
    owned = _lanes_by_chunk(shape, np.arange(plan.chunks))
    group0 = owned[..., 0]
    assert np.all(group0 % 4 == 0)
    for k in range(4 // vec):  # every vector load is aligned to its width
        assert np.all((address + 4 * (group0 + k * vec)) % (4 * vec) == 0)
    owned = owned.ravel()
    owned = owned[owned < lanes]
    assert owned.size == lanes and np.array_equal(np.sort(owned), np.arange(lanes))
    if kernel == "validity":  # and every (row, lane) once
        rows, cols = np.divmod(owned, p)
        assert rows.max() == n - 1 and np.unique(rows * p + cols).size == n * p


def test_vector_width_follows_the_worst_pointer():
    assert sp.vector_width(BASE, BASE + 32, BASE + 48) == 4
    assert sp.vector_width(BASE, BASE + 8) == 2
    assert sp.vector_width(BASE + 8, BASE + 4) == 1
    # a row of P = 199,210 is 796,840 bytes, 8 modulo 16: odd rows take 8-byte loads
    assert sp.vector_width(BASE + 4 * 199_210) == 2
    assert sp.vector_width(BASE + 2 * 4 * 199_210) == 4
    with pytest.raises(ValueError):
        sp.vector_width(BASE + 2)


@pytest.mark.parametrize("blocks_per_sm", [1, 4, 8])
@pytest.mark.parametrize("lanes", [1, 4_096, 1_792_890, 70_000 * 199_210, 2 ** 62])
def test_grid_stays_within_one_wave(blocks_per_sm, lanes):
    for shape in (sp.VALIDITY, sp.SAMPLE_KL):
        plan = sp.plan(lanes, shape, 4, SMS * blocks_per_sm)
        assert 1 <= plan.grid <= SMS * blocks_per_sm and plan.grid <= plan.chunks
        if plan.chunks <= SMS * blocks_per_sm:  # one chunk a block when the wave allows
            assert plan.grid == plan.chunks


def test_plan_refuses_what_the_kernels_do_not_take():
    for lanes, vec, wave in ((0, 4, 8), (2 ** 63, 4, 8), (10, 3, 8), (10, 4, 0)):
        with pytest.raises(ValueError):
            sp.plan(lanes, sp.VALIDITY, vec, wave)


def emulate_validity(bad: np.ndarray, p: int, shape: sp.KernelShape = sp.VALIDITY):
    """The validity kernel's row verdicts, step by step as in the C++, from
    the per-lane ``bad`` flags of the flat ``[N * P]`` buffer.  Returns the
    flags and how often each row was written by a chunk's interior pass or
    by the last block's first pass (each row exactly once)."""
    lanes = bad.size
    n = lanes // p
    chunk = shape.chunk
    chunks = -(-lanes // chunk)
    ok = np.full(n, 2, dtype=np.int8)  # 2: never written
    writes = np.zeros(n, dtype=np.int64)
    edge = np.zeros(2 * chunks, dtype=np.int8)
    for c in range(chunks):
        first = c * chunk
        rf, rl = sp.chunk_rows(c, chunk, lanes, p)
        ok[rf + 1:rl] = 1
        writes[rf + 1:rl] += 1
        head = tail = 1
        for lane in np.flatnonzero(bad[first:first + chunk]) + first:
            row = lane // p
            if row == rf:
                head = 0
            elif row == rl:
                tail = 0
            else:
                ok[row] = 0
        edge[2 * c], edge[2 * c + 1] = head, head if rf == rl else tail
    for c in range(chunks):  # the last block: rows that start in chunk c
        first = c * chunk
        rf, rl = sp.chunk_rows(c, chunk, lanes, p)
        if rf * p == first and rf != rl:
            ok[rf] = edge[2 * c]
            writes[rf] += 1
        if rl * p >= first:
            ok[rl] = edge[2 * c + 1]
            writes[rl] += 1
    for c in range(chunks):  # then a bad verdict clears a row begun earlier
        first = c * chunk
        rf, _ = sp.chunk_rows(c, chunk, lanes, p)
        if rf * p < first and edge[2 * c] == 0:
            ok[rf] = 0
    return ok, writes


@pytest.mark.parametrize("p,n", SHAPES + [(4_096, 5), (4_095, 7), (4_097, 7), (3, 70_000)])
def test_rows_crossing_chunks_get_their_own_lanes(p, n):
    lanes = n * p
    chunk = sp.VALIDITY.chunk
    rng = np.random.default_rng(n * 7 + p)
    bad = np.zeros(lanes, dtype=bool)
    rows = np.arange(n)
    marked = rng.random(n) < 0.3
    bad[rows[marked] * p] = True  # the first lane of some rows
    marked = rng.random(n) < 0.3
    bad[rows[marked] * p + p - 1] = True  # the last lane of others
    bounds = np.arange(chunk, lanes, chunk)  # lanes on both sides of chunk boundaries
    pick = bounds[rng.random(bounds.size) < 0.3]
    bad[pick] = True
    bad[pick[rng.random(pick.size) < 0.5] - 1] = True
    bad[rng.integers(0, lanes, size=max(1, lanes // 50_000))] = True
    ok, writes = emulate_validity(bad, p)
    assert np.all(writes == 1)  # every row decided exactly once
    assert np.array_equal(ok.astype(bool), ~bad.reshape(n, p).any(axis=1))
    if n > 1:  # all good / one bad lane in the middle of a long row
        clean = np.zeros(lanes, dtype=bool)
        assert np.all(emulate_validity(clean, p)[0] == 1)
        clean[(n // 2) * p + p // 2] = True
        ok, _ = emulate_validity(clean, p)
        assert np.flatnonzero(ok == 0).tolist() == [n // 2]


def emulate_kl_sum(terms: np.ndarray, shape: sp.KernelShape = sp.SAMPLE_KL) -> np.float32:
    """The KL kernel's sum of the per-lane float32 ``terms``, in its order:
    each thread adds its lanes (group 0's four, then group 1's) from 0, a
    warp folds 32 values by shuffles at offsets 16..1, thread 0 adds the
    warp sums in order -> one partial per chunk; the last block sums the
    partials by the same tree, thread t taking chunks t, t + threads, ..."""
    f32 = np.float32

    def block_tree(per_thread: np.ndarray) -> np.float32:  # [threads] -> one value
        warps = per_thread.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            warps = (warps[:, :off] + warps[:, off:2 * off]).astype(f32)
        total = f32(0.0)
        for w in warps[:, 0]:
            total = f32(total + w)
        return total

    lanes = terms.size
    chunks = -(-lanes // shape.chunk)
    padded = np.zeros(chunks * shape.chunk, dtype=f32)
    padded[:lanes] = terms
    # [chunk, group, thread, lane of group] -> a thread's lanes in its order
    per = padded.reshape(chunks, shape.groups, shape.threads, 4).transpose(0, 2, 1, 3)
    per = per.reshape(chunks, shape.threads, 4 * shape.groups)
    valid = (np.arange(chunks * shape.chunk) < lanes).reshape(
        chunks, shape.groups, shape.threads, 4).transpose(0, 2, 1, 3).reshape(per.shape)
    acc = np.zeros((chunks, shape.threads), dtype=f32)
    for k in range(4 * shape.groups):  # masked lanes are skipped, not added as 0
        acc = np.where(valid[:, :, k], (acc + per[:, :, k]).astype(f32), acc)
    parts = np.array([block_tree(acc[c]) for c in range(chunks)], dtype=f32)
    acc = np.zeros(shape.threads, dtype=f32)
    for start in range(0, chunks, shape.threads):
        block = parts[start:start + shape.threads]
        acc[:block.size] = (acc[:block.size] + block).astype(f32)
    return block_tree(acc)


def _kl_terms(p: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mu, eps, mu_p = (rng.normal(size=p).astype(np.float32) * s for s in (1.0, 1.0, 0.1))
    rho = (rng.normal(size=p) * 0.3 - 1.0).astype(np.float32)
    rho_p = (rng.normal(size=p) * 0.1).astype(np.float32)
    sq, spp = (torch.nn.functional.softplus(torch.from_numpy(x)) for x in (rho, rho_p))
    d = torch.from_numpy(mu) - torch.from_numpy(mu_p)
    terms = torch.log(spp / sq) + (sq * sq + d * d) / (2.0 * spp * spp) - 0.5
    return terms.numpy().astype(np.float32), (mu, rho, eps, mu_p, rho_p)


@pytest.mark.parametrize("p", [1, 5, 1_023, 1_025, 2_049, 199_210, 1_000_003])
def test_kl_summation_order_against_fp64(p):
    terms, args = _kl_terms(p, seed=p)
    got = emulate_kl_sum(terms)
    exact = float(np.sum(terms.astype(np.float64)))
    chunks = -(-p // sp.SAMPLE_KL.chunk)
    depth = (4 * sp.SAMPLE_KL.groups + 5 + sp.SAMPLE_KL.threads // 32) * 2 + chunks
    bound = depth * 2.0 ** -24 * float(np.sum(np.abs(terms.astype(np.float64))))
    assert abs(float(got) - exact) <= bound, (float(got), exact, bound)
    # and against the plain version's sum, within the KL tolerance the card is held to
    _, kl_plain = gauss_vi.sample_and_kl_plain(*(torch.from_numpy(a) for a in args))
    assert abs(float(got) - float(kl_plain)) <= 1e-5 * abs(float(kl_plain)) + 1e-6


def test_kl_emulation_is_the_sequential_sum_for_one_thread():
    terms = np.float32([0.5, 1e-8, 3.0, -0.25, 7.0])  # P = 5: thread 0's group 0 and lane 4
    want = np.float32(0.0)
    for t in terms[:4]:
        want = np.float32(want + t)
    # thread 1 holds lane 4; the shuffle tree adds thread 1's value at offset 1
    assert emulate_kl_sum(terms) == np.float32(want + terms[4])
