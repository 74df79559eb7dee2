"""The launch geometry of K3's cluster design, of blur_rows' keypoint
design and of warp_tangents' knots design (ops/cuda_residual.py), of K4's
select design (ops/cuda_image.py) and of K5's staged design
(ops/cuda_layout.py), which is plain Python so that it is tested here,
without a card: K3's chunk and part row ranges cover every row once, in
order, and are the chunks of the reference's compensated sum
(ops/residual.py::_kahan_chunked_normal_eq); each design's shared memory
fits a block's 227 KB at every tangent count the kernels were built for;
K4's blocks take every sample once and its division constant is exact; K5
stages every knot count up to its limit and refuses more. The kernels
check the bytes they are given against their own layout; the card tests
(tests/test_torch_cuda.py) run them."""

import numpy as np
import pytest
import torch

from mba_vo_tpu_torch.ops import cuda_image as ci
from mba_vo_tpu_torch.ops import cuda_layout as cl
from mba_vo_tpu_torch.ops import cuda_residual as cr
from mba_vo_tpu_torch.ops import residual as tres

# the bench's row counts: a frame (1 x 512 x 8) and joint chunks of 4 and 8
# frames; then sizes off every multiple
BENCH_ROWS = [4096, 16384, 32768]
ODD_ROWS = [1, 9, 15, 16, 17, 35, 127, 518, 4095, 4097, 100003]


def _check_rows(M):
    rows = cr.normal_equations_rows(M)
    assert len(rows) == cr.CHUNKS and all(len(parts) == cr.SPLIT for parts in rows)
    covered = 0
    L = -(-M // cr.CHUNKS)
    for c, parts in enumerate(rows):
        # a chunk's parts are contiguous and make up [c L, (c + 1) L), cut at M
        assert parts[0][0] == min(c * L, M) and parts[-1][1] == min((c + 1) * L, M)
        for begin, end in parts:
            assert begin == covered and end >= begin
            covered = end
    assert covered == M


@pytest.mark.parametrize("first", range(1, 3001, 500))
def test_k3_parts_cover_every_row_once_in_order(first):
    for M in range(first, first + 500):
        _check_rows(M)


@pytest.mark.parametrize("M", BENCH_ROWS + ODD_ROWS)
def test_k3_parts_at_the_bench_and_odd_sizes(M):
    _check_rows(M)
    # a part holds ceil(ceil(M / 16) / 8) rows but at a chunk's end
    Lb = -(-(-(-M // cr.CHUNKS)) // cr.SPLIT)
    assert max(end - begin for parts in cr.normal_equations_rows(M)
               for begin, end in parts) == Lb


@pytest.mark.parametrize("M", BENCH_ROWS + ODD_ROWS)
def test_k3_chunks_are_the_compensated_sums_chunks(M, monkeypatch):
    """_kahan_chunked_normal_eq pads the rows to 16 equal chunks; the rows it
    puts in chunk c are the rows of K3's chunk c, padding aside."""
    seen = []
    einsum = torch.einsum

    def spy(eq, *ops):
        if eq == "cmk,cm->ck":
            seen.append(ops[0].clone())
        return einsum(eq, *ops)

    monkeypatch.setattr(torch, "einsum", spy)
    rows = torch.arange(1, M + 1, dtype=torch.float64)[:, None]     # row m holds m + 1
    tres._kahan_chunked_normal_eq(rows, torch.ones(M, dtype=torch.float64))
    (chunked,) = seen
    assert chunked.shape[0] == cr.CHUNKS
    for c, parts in enumerate(cr.normal_equations_rows(M)):
        held = chunked[c, :, 0]
        real = held[held > 0].long() - 1
        assert torch.equal(real, torch.arange(parts[0][0], parts[-1][1]))
        assert not held[len(real):].any()       # the padded rows trail, as zeros


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("D", [0, 1, 12, 42, 66, 124, 125, cr.MAX_TANGENTS])
@pytest.mark.parametrize("per_chunk", [1, cr.SPLIT])
def test_k3_cluster_layout_fits(D, itemsize, per_chunk):
    """At the bench's sizes and off them, both layouts of the cluster design
    (the rule's choice by the rows, and the other, which the layout sweep
    times) fit a block's shared memory: a round of G parts, a step of TS
    tiles of each; whole parts a step where they fit (two copies), two
    stages where a CTA takes more than one step; at most two blocks a
    thread."""
    N = 512
    E = (D + 1) * (D + 2) // 2 - 1 if D else 0
    nb = -(-(D + 1) // cr.BLOCK)
    blocks = nb * (nb + 1) // 2 if D else 0
    for M in BENCH_ROWS + ODD_ROWS:
        lay = cr._cluster_layout(D, itemsize, N, M, per_chunk)
        if per_chunk == (1 if M <= cr.CLUSTER_ROWS else cr.SPLIT):
            assert lay == cr.normal_equations_layout(D, itemsize, N, M)
        G, TS = lay.parts_a_round, lay.tiles_a_step
        assert lay.per_chunk == per_chunk
        assert lay.threads == (cr.CLUSTER_THREADS if per_chunk == 1 or blocks > 2 * cr.PART_THREADS
                               else cr.PART_THREADS)
        # a cluster of the 16 chunks' CTAs, or of a chunk's 8 CTAs (a part each)
        assert lay.cluster == (cr.CHUNKS if per_chunk == 1 else cr.SPLIT)
        assert G in ((1, 2, 4, 8) if per_chunk == 1 else (1,)) and 1 <= G * TS <= 32
        assert lay.items in (1, 2) and lay.kw_staged
        assert G * blocks <= lay.items * lay.threads
        assert lay.smem_bytes <= cr.MAX_SHARED_BYTES and lay.smem_bytes % 16 == 0
        assert lay.smem_bytes == cr._cluster_smem(D, G, TS, lay.stages, itemsize, N)
        # the sums, kp_w and the stages of a step's rows fit
        assert lay.smem_bytes >= ((1 + E + N) * itemsize
                                  + lay.stages * G * TS * 32 * D * itemsize)
        longest = max(end - begin for parts in cr.normal_equations_rows(M)
                      for begin, end in parts)
        tiles = max(1, -(-longest // 32))
        steps = cr.SPLIT // per_chunk // G * -(-tiles // TS)
        assert lay.stages == (2 if steps > 1 else 1)
        if TS < tiles:
            # a step that covers whole parts would not fit, with any round
            assert all(cr._cluster_smem(D, g, tiles, 2 if cr.SPLIT // per_chunk // g > 1 else 1,
                                        itemsize, N) > cr.MAX_SHARED_BYTES or g * tiles > 32
                       or g * blocks > 2 * lay.threads
                       for g in (1, 2, 4, 8) if g <= cr.SPLIT // per_chunk)
        assert lay.chunk_scratch == (cr.CHUNKS * (1 + E) if per_chunk > 1 else 0)


def test_k3_layout_rule_and_kp_w():
    """One cluster of the chunks' CTAs up to CLUSTER_ROWS rows, a CTA a part
    past them; kp_w staged where it fits."""
    assert cr.normal_equations_layout(12, 4, 512, cr.CLUSTER_ROWS).per_chunk == 1
    assert cr.normal_equations_layout(12, 4, 512, cr.CLUSTER_ROWS + 1).per_chunk == cr.SPLIT
    assert cr.normal_equations_layout(12, 8, cr.KW_STAGE_BYTES // 8, 4096).kw_staged
    big = cr.normal_equations_layout(12, 8, cr.KW_STAGE_BYTES // 8 + 1, 4096)
    assert not big.kw_staged
    assert big.smem_bytes == cr.normal_equations_layout(12, 8, 0, 4096).smem_bytes


def test_k3_cluster_layout_at_the_bench_shapes():
    """The frame (M = 4,096, D = 12): one cluster of 16, a round of the 8
    parts whole in one step; the joint chunk at degree 4 (M = 16,384, D =
    42): a CTA a part, its 4 tiles in one step."""
    frame = cr.normal_equations_layout(12, 4, 512, 4096)
    assert (frame.per_chunk, frame.parts_a_round, frame.tiles_a_step, frame.stages,
            frame.items) == (1, 8, 1, 1, 1)
    joint = cr.normal_equations_layout(42, 4, 512, 16384)
    assert (joint.per_chunk, joint.parts_a_round, joint.tiles_a_step, joint.stages) == \
        (cr.SPLIT, 1, 4, 1)
    assert cr.normal_equations_layout(cr.MAX_TANGENTS, 8, 512, 4096).items == 2


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", [8, 9, 25])
@pytest.mark.parametrize("V", [1, 3, 5])
@pytest.mark.parametrize("F", [1, 4, 8])
def test_blur_rows_layout_fits(F, P, V, itemsize):
    """At every D up to MAX_TANGENTS the keypoint design's tangent tile
    covers D (in one stage) or streams it in tiles of up to BLUR_TILE (two
    stages), and its shared memory stays within 227 KB."""
    for D in range(cr.MAX_TANGENTS + 1):
        lay = cr.blur_rows_layout(F, P, V, D, itemsize)
        run = F * P * V * itemsize
        assert lay.smem_bytes <= cr.MAX_SHARED_BYTES, (D, lay)
        assert lay.span_bytes % 128 == 16 and lay.span_bytes >= run + 16
        table = -(-F * P * 8 // 16) * 16
        assert lay.smem_bytes == 16 + table + lay.span_bytes * (3 + 2 * lay.stages * lay.tile)
        if lay.stages == 1:
            assert lay.tile == max(D, 1)
        else:
            assert lay.stages == 2 and lay.tile <= cr.BLUR_TILE and lay.tile < D
            # the keypoint's whole slab, its rows' table included, would not fit
            assert 16 + table + (3 + 2 * D) * cr._span(run) > cr.BLUR_SLAB_BYTES
        assert lay.threads % 32 == 0 and 32 <= lay.threads <= 1024
        # a warp a block of 4 x 8 or 8 x 4 outputs, as many as there are
        wd = 8 if lay.tile % 8 == 0 else 4
        blocks = -(-F * P // (32 // wd)) * -(-lay.tile // wd)
        assert lay.threads == min(1024, 32 * blocks)


def test_blur_rows_layout_at_the_bench_shapes():
    """The frame (F = 1, D = 12): 96 threads, all 12 tangents in one stage;
    the joint chunk (F = 4, D = 42): tangents streamed in tiles of 8, two
    stages deep; D = 128 in float64 at a chunk of 8 frames streams narrower
    tiles."""
    frame = cr.blur_rows_layout(1, 8, 5, 12, 4)
    assert (frame.tile, frame.stages, frame.threads) == (12, 1, 96)
    joint = cr.blur_rows_layout(4, 8, 5, 42, 4)
    assert (joint.tile, joint.stages, joint.threads) == (8, 2, 256)
    wide = cr.blur_rows_layout(8, 8, 5, cr.MAX_TANGENTS, 8)
    assert wide.stages == 2 and wide.tile < 8


def test_blur_rows_layout_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cr.blur_rows_layout(8, 64, 64, cr.MAX_TANGENTS, 8)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("P", [8, 9, 25])
@pytest.mark.parametrize("V", [1, 3, 5, 9])
def test_warp_tangents_layout_fits(V, P, itemsize):
    """At every D up to MAX_TANGENTS (0 included: the cost-only calls) the
    knots design's tables fit a block's 227 KB, a block's samples are whole
    keypoints' P V runs no more than a CTA's threads, and the thread groups
    take every thread a sample can have."""
    for D in range(cr.MAX_TANGENTS + 1):
        lay = cr.warp_tangents_layout(P, V, D, itemsize)
        assert lay.smem_bytes <= cr.MAX_SHARED_BYTES, (D, lay)
        assert lay.smem_bytes == (8 * V * D + 12 * V + 28 * cr.WARP_JOBS * V) * itemsize
        assert lay.samples == lay.keypoints * P * V <= cr.WARP_THREADS
        assert lay.keypoints == max(1, cr.WARP_SAMPLES // (P * V))
        assert lay.groups == cr.WARP_THREADS // lay.samples >= 1
        # the tangent table starts the shared memory, in 16-byte words
        assert (8 * itemsize) % 16 == 0


def test_warp_tangents_layout_at_the_bench_shapes():
    """The frame and a joint chunk (P = 8, V = 5): blocks of 6 keypoints,
    240 samples, one thread group; the widest table (D = 128, float64)
    past the 48 KB a block gets without asking (the kernel asks for 227)."""
    for D in (12, 42, 66):
        lay = cr.warp_tangents_layout(8, 5, D, 4)
        assert (lay.keypoints, lay.samples, lay.groups) == (6, 240, 1)
    assert cr.warp_tangents_layout(8, 5, cr.MAX_TANGENTS, 8).smem_bytes == 56000 > 48 * 1024


def test_warp_tangents_layout_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="samples a keypoint"):
        cr.warp_tangents_layout(64, 5, 12, 4)
    with pytest.raises(ValueError, match="shared memory"):
        cr.warp_tangents_layout(1, 40, cr.MAX_TANGENTS, 8)


# K4's select design (ops/cuda_image.py): the bench's sample counts (a
# frame's 512 x 40, a joint chunk's 512 x 160) and odd ones (1, 39, 41, 257
# and 100,003 samples, as N x S both ways)
IMAGE_SIZES = [(512, 40), (512, 160), (1, 1), (3, 13), (1, 39), (39, 1), (41, 1), (1, 41),
               (257, 1), (1, 257), (100003, 1), (1, 100003)]


@pytest.mark.parametrize("N,S", IMAGE_SIZES)
def test_image_select_map_covers_every_sample_once(N, S):
    """Thread t of block b takes sample b IMAGE_THREADS + t below N S: over
    the grid every (n, s) is taken once, and (i m) >> k is the keypoint
    n = i // S of each (s = i - n S)."""
    lay = ci.select_layout(N, S)
    threads = ci.IMAGE_THREADS
    assert (lay.grid - 1) * threads < N * S <= lay.grid * threads
    b, t = np.meshgrid(np.arange(lay.grid), np.arange(threads), indexing="ij")
    i = lay.samples(b, t).reshape(-1)
    taken = np.sort(i[i < N * S])
    assert np.array_equal(taken, np.arange(N * S))
    n = lay.keypoint(taken)
    s = taken - n * S
    assert np.array_equal(n, taken // S) and (s >= 0).all() and (s < S).all() and n.max() < N


@pytest.mark.parametrize("S", [1, 2, 3, 5, 7, 13, 39, 40, 41, 160, 257, 320, 1000, 65537,
                               100003, 2 ** 20 + 1, 2 ** 30 + 3, 2 ** 31 - 1])
def test_image_divisor_is_exact_below_2_31(S):
    """(i m) >> k == i // S: at every i below N S for the bench's S, and, for
    every S, around each of the first and last multiples of S below 2^31 and
    at sampled i; m fits 32 bits and its error m S - 2^k lies in [0, S)."""
    m, k = ci.sample_divisor(S)
    assert 0 < m < 2 ** 32 and 0 <= m * S - 2 ** k < S and 31 <= k <= 62
    rng = np.random.default_rng(S)
    top = (2 ** 31 - 1) // S * S
    edges = np.array([q * S + d for q in (0, 1, 2, top // S - 1, top // S)
                      for d in (-1, 0, 1, S - 1) if 0 <= q * S + d < 2 ** 31], dtype=np.int64)
    i = np.concatenate([np.arange(min(512 * S, 2 ** 22), dtype=np.int64), edges,
                        rng.integers(0, 2 ** 31, 100000, dtype=np.int64),
                        np.array([2 ** 31 - 1], dtype=np.int64)])
    assert np.array_equal((i * m) >> k, i // S)


def test_image_select_layout_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="32-bit"):
        ci.select_layout(2 ** 16, 2 ** 15)
    with pytest.raises(ValueError, match="S = 0"):
        ci.sample_divisor(0)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_layout_staging_fits_up_to_the_limit(itemsize):
    """K5's staged design: at every K up to MAX_LAYOUT_KNOTS, warp 0 stages
    the 4 K rotation values and warp 1 the 3 K translation values, at most
    LAYOUT_LOADS a lane; the shared memory holds them, 3 segments' exps and
    the pose, in 16-byte units, well within the 48 KB a block gets without
    asking."""
    for K in range(1, cl.MAX_LAYOUT_KNOTS + 1):
        st = cl.layout_staging(K, itemsize)
        assert st.loads_q <= cl.LAYOUT_LOADS and st.loads_t <= cl.LAYOUT_LOADS
        assert 32 * st.loads_q >= 4 * K > 32 * (st.loads_q - 1)
        assert 32 * st.loads_t >= 3 * K > 32 * (st.loads_t - 1)
        assert st.smem_bytes % 16 == 0
        assert (7 * K + 12 + 7) * itemsize <= st.smem_bytes < (7 * K + 12 + 7) * itemsize + 16
        assert st.smem_bytes <= 48 * 1024


def test_layout_staging_at_the_bench_shapes_and_refusals():
    """The frame's 2 knots and a degree-4 joint chunk's 7 (chunk 4) and 27
    (chunk 24) stage in one load a lane or a few; past MAX_LAYOUT_KNOTS and
    at no knot the staging is refused (the wrapper raises before any
    launch)."""
    assert cl.layout_staging(2, 4) == cl.LayoutStaging(1, 1, 144)
    assert (cl.layout_staging(7, 8).loads_q, cl.layout_staging(7, 8).loads_t) == (1, 1)
    assert (cl.layout_staging(27, 8).loads_q, cl.layout_staging(27, 8).loads_t) == (4, 3)
    assert cl.MAX_LAYOUT_KNOTS >= 27
    for K in (0, cl.MAX_LAYOUT_KNOTS + 1, 1000):
        with pytest.raises(ValueError, match="MAX_LAYOUT_KNOTS"):
            cl.layout_staging(K, 8)
