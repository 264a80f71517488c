"""The host-side arithmetic of the port's warp-specialised bf16 kernels
on the CPU: ``csrc/flash_attention_wgmma.cu`` and the prefill and small-C
regimes of ``csrc/grouped_matmul_tc.cu``; and of the f32 grouped matmul's
kernel (``csrc/grouped_matmul.cu``).

The kernels run only on the card; what they take from the host is checked
here at every bf16 path shape of ``chip_smoke.py`` and its reference
sweeps: the TMA tensor maps (16-byte strides, boxes of at most 256 and
128-byte inner rows under the 128-byte swizzle, the model's (B,S,H,D)
views described without a copy), the shared memory of a CTA, the Python
twin of the attention kernel's key-tile range and mask-free test against
the mask itself, the grouped matmul's grid and clusters against the
output they must cover, the Python twin of the small-C stream's walk
and second pass against every slice of every item, and the f32 kernel's
grid and threads against every output of every f32 shape checked."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm

BOX_MAX = 256                   # a TMA box's largest size in any dimension
SWIZZLE_ROW = 128               # bytes of a box's inner row, 128-byte swizzle

# (B, H, K, S, T, D) of every bf16 flash-attention shape chip_smoke checks.
FLASH_SHAPES = sorted(
    {(B, H, K, S, S, D) for B, H, K, S, D in chip_smoke.FLASH_CASES}
    | {(B, H, K, S, T, D) for B, H, K, S, T, D in
       chip_smoke.FLASH_CROSS_CASES}
    | {(B, H, K, S, S, D) for (B, H, K, S, D), dt in
       chip_smoke.FLASH_PATH_CASES if dt == torch.bfloat16}
    | {shape for shape, dt, _, _ in chip_smoke.FLASH_MASK_PATH_CASES
       if dt == torch.bfloat16})


def _view(B, N, L, D, model_layout):
    """A (B, N, L, D) bf16 tensor on the meta device: the model's (B, L, N,
    D) tensor transposed, or a contiguous one."""
    if model_layout:
        return torch.empty((B, L, N, D), dtype=torch.bfloat16,
                           device="meta").transpose(1, 2)
    return torch.empty((B, N, L, D), dtype=torch.bfloat16, device="meta")


def _check_map(layout, rank, dims, rows):
    """A tensor map TMA takes in the 128-byte swizzle."""
    assert len(layout) == 3 * rank - 1
    got_dims = layout[:rank]
    strides = layout[rank:2 * rank - 1]
    box = layout[2 * rank - 1:]
    assert tuple(got_dims) == tuple(dims)
    assert all(s % 16 == 0 and 0 < s < 2 ** 40 for s in strides)
    assert all(1 <= b <= BOX_MAX for b in box)
    assert box[0] * 2 == SWIZZLE_ROW and box[1] == rows
    assert all(b == 1 for b in box[2:])
    return strides


@pytest.mark.parametrize("model_layout", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_tensor_maps(shape, model_layout):
    """q's, k's and v's maps: (D, rows, heads, batch), byte strides of the
    tensor as it is passed (the model's views through their own strides),
    boxes of 64 columns by 128 rows."""
    B, H, K, S, T, D = shape
    for (N, L, rows) in ((H, S, fa.BLOCK_Q), (K, T, fa.BLOCK_KV)):
        x = _view(B, N, L, D, model_layout)
        strides = _check_map(fa.tma_layout(x, rows), 4, (D, L, N, B), rows)
        assert strides == tuple(2 * s for s in (x.stride(2), x.stride(1),
                                                x.stride(0)))
        if model_layout:             # (B, S, H, D) read in place
            assert strides == (N * D * 2, D * 2, L * N * D * 2)


def test_model_views_are_read_in_place():
    """The model's (B,S,H,D) views need no copy: TMA describes them; a
    view with a stride that is not a multiple of 16 bytes is copied."""
    x = torch.zeros(2, 40, 6, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert fa.kernel_layout(x) is x
    odd = torch.zeros(2, 40, 6, 68, dtype=torch.bfloat16)[..., :64]
    odd = odd.transpose(1, 2)        # rows 136 bytes apart
    assert fa.kernel_layout(odd) is not odd
    assert fa.kernel_layout(odd).is_contiguous()


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_flash_shared_memory_fits(D):
    dp = fa.padded_head_dim(D)
    assert dp % fa.PANEL == 0 and D <= dp
    assert fa.smem_bytes(D) <= fa.SMEM_LIMIT
    # every swizzled buffer starts on a 1024-byte atom
    assert (fa.BLOCK_Q * fa.PANEL * 2) % 1024 == 0
    assert (fa.BLOCK_KV * fa.PANEL * 2) % 1024 == 0


# (S, T, causal, window): the path's masks, the sweeps' windows, S != T,
# and S or T off the 128-row tile.
MASKS = [(2048, 2048, True, 0), (2048, 2048, True, 16),
         (2048, 2048, True, 100), (2048, 2048, True, 1024),
         (1050, 1050, True, 1024), (1500, 1500, False, 0),
         (448, 448, True, 0), (448, 1500, False, 0), (200, 200, True, 100),
         (200, 200, True, 16), (96, 96, True, 0), (130, 75, False, 0),
         (37, 100, False, 0), (1, 129, False, 0), (64, 200, False, 0),
         (300, 300, False, 100)]


def _keep(rows, keys, T, causal, window):
    i = np.asarray(rows)[:, None]
    j = np.asarray(keys)[None, :]
    ok = (j < T) & (i >= 0)
    if causal:
        ok &= i >= j
    if window > 0:
        ok &= (i - j) < window
    return ok


@pytest.mark.parametrize("S,T,causal,window", MASKS)
def test_key_tiles_cover_the_mask(S, T, causal, window):
    """For every query block: the visited key tiles hold every kept (i, j)
    pair of its rows, every visited tile holds one, and a tile that
    ``mask_free`` passes for a consumer warpgroup masks none of that
    warpgroup's 64 rows."""
    kv = fa.BLOCK_KV
    for q0 in range(0, S, fa.BLOCK_Q):
        rows = np.arange(q0, min(q0 + fa.BLOCK_Q, S))
        k_lo, n = fa.key_tiles(q0, S, T, causal, window)
        assert k_lo % kv == 0 and n >= 1
        kept = _keep(rows, np.arange(T), T, causal, window)
        cols = np.nonzero(kept.any(axis=0))[0]
        assert cols.min() >= k_lo and cols.max() < k_lo + n * kv
        for t in range(n):
            k0 = k_lo + t * kv
            tile = _keep(rows, np.arange(k0, k0 + kv), T, causal, window)
            assert tile.any(), (q0, k0)
            for g in range(fa.BLOCK_Q // fa.WG_ROWS):
                r0 = q0 + g * fa.WG_ROWS
                if fa.mask_free(k0, r0, T, causal, window):
                    wg_rows = np.arange(r0, r0 + fa.WG_ROWS)
                    assert _keep(wg_rows, np.arange(k0, k0 + kv), T, causal,
                                 window).all(), (q0, k0, g)


@pytest.mark.parametrize("B,H,S", [(4, 32, 2048), (2, 48, 2048), (4, 25, 2048),
                                   (8, 6, 448), (8, 6, 1500), (1, 4, 24),
                                   (2, 5, 100)])
def test_persistent_grid_takes_every_item_once(B, H, S):
    """The bf16 kernel's persistent CTAs cover every (query block, head)
    item once, each CTA taking the heaviest causal blocks first, and no
    CTA is idle."""
    p = fa.plan(B, H, S, 64, torch.bfloat16)
    ctas = p.grid[0]
    per_cta = fa.work_items(S, B * H, ctas)
    flat = [it for items in per_cta for it in items]
    n_qb = -(-S // fa.BLOCK_Q)
    assert sorted(flat) == [(qb, bh) for qb in range(n_qb)
                            for bh in range(B * H)]
    assert ctas == min(fa.SMS, len(flat)) and all(per_cta)
    for items in per_cta:
        qbs = [qb for qb, _ in items]
        assert qbs == sorted(qbs, reverse=True)
    # causal work (key tiles) per CTA is within one heaviest item of even
    work = [sum(qb + 1 for qb, _ in items) for items in per_cta]
    assert max(work) - min(work) <= n_qb


def test_mask_free_tiles_are_most_of_a_long_causal_row():
    """The skip is not vacuous: at S = T = 2048, causal, every tile below a
    warpgroup's diagonal is mask-free."""
    q0 = 1920
    k_lo, n = fa.key_tiles(q0, 2048, 2048, True, 0)
    free = [fa.mask_free(k_lo + t * fa.BLOCK_KV, q0, 2048, True, 0)
            for t in range(n)]
    assert (k_lo, n) == (0, 16) and free == [True] * 15 + [False]


# The grouped matmul's bf16 prefill shapes (E, C, d, f) in chip_smoke, and
# small ragged ones.
GMM_SHAPES = sorted(
    {s for s, dt in chip_smoke.GMM_PATH_CASES if dt == torch.bfloat16}
    | {s for _, s, _, _ in chip_smoke.GMM_OFF_PATH}
    | set(chip_smoke.GMM_CASES) | set(chip_smoke.GMM_EDGE_CASES)
    | {(3, 100, 64, 300), (2, 333, 128, 200), (1, 161, 72, 136)})
# Those the wgmma kernel takes when contiguous: rows of x and w whole
# 16-byte units, more than 64 rows an expert.
TMA_SHAPES = [s for s in GMM_SHAPES if s[2] % 8 == 0 and s[3] % 8 == 0
              and gm.plan(*s, torch.bfloat16).kernel == "wgmma"]
# Those the small-C stream takes (up to 64 rows an expert; the plan is the
# same whether or not the rows are aligned), and ragged ones: f and d off
# the item and the slice, fewer units than SMs, a CTA inside one item.
STREAM_SHAPES = sorted(
    {s for s in GMM_SHAPES if gm.plan(*s, torch.bfloat16).kernel == "stream"}
    | {(1, 8, 64, 8), (2, 16, 4160, 136), (5, 40, 640, 4096),
       (1, 3, 64 * 500, 128), (7, 9, 1000, 1000)})


def test_prefill_shapes_take_the_tma_kernel():
    """Grok-1's gate/up, down and one-row chunk take the wgmma kernel; rows
    TMA cannot read (1, 77, 24, 129) take the 64-row mma.sync tile."""
    for s in [(8, 320, 6144, 32768), (8, 320, 32768, 6144),
              (8, 160, 6144, 32768)]:
        assert s in TMA_SHAPES
        assert gm.plan(*s, torch.bfloat16).cluster == gm.CLUSTER
    x = torch.zeros(1, 77, 24, dtype=torch.bfloat16)
    w = torch.zeros(1, 24, 129, dtype=torch.bfloat16)
    tma = gm._vec_ok(x) and gm._vec_ok(w)
    p = gm.plan(1, 77, 24, 129, torch.bfloat16, tma=tma)
    assert not tma and p.kernel == "tensor_core" and p.cluster == 1
    assert p.variant == gm.SYNC_VARIANT
    assert (p.bm, p.bn, p.bk, p.stages) == tuple(
        gm.SYNC_TILE[i] for i in (0, 1, 2, 4))


@pytest.mark.parametrize("shape", TMA_SHAPES)
def test_gmm_tensor_maps(shape):
    """x's map (d, C, E) with boxes of bm / cluster token rows, w's (f, d,
    E) with boxes of 64 rows of d; both 64 columns wide, strided views
    described in place."""
    cluster = gm.CLUSTER
    E, C, d, f = shape
    p = gm.plan(E, C, d, f, torch.bfloat16)
    assert p.cluster == cluster and p.bm % cluster == 0
    assert (p.bm // cluster * 128) % 1024 == 0   # parts keep swizzle atoms
    x = torch.empty((E, C, d), dtype=torch.bfloat16, device="meta")
    w = torch.empty((E, d, f), dtype=torch.bfloat16, device="meta")
    assert _check_map(gm.tma_layout(x, p.bm // p.cluster), 3, (d, C, E),
                      p.bm // cluster) == (d * 2, C * d * 2)
    assert _check_map(gm.tma_layout(w, p.bk), 3, (f, d, E), p.bk) == \
        (f * 2, d * f * 2)
    # a transposed x and one layer of stacked weights, read in place
    xt = torch.empty((C, E, d), dtype=torch.bfloat16,
                     device="meta").transpose(0, 1)
    ws = torch.empty((2, E, d, f), dtype=torch.bfloat16, device="meta")[1]
    assert _check_map(gm.tma_layout(xt, p.bm // p.cluster), 3, (d, C, E),
                      p.bm // cluster) == (E * d * 2, d * 2)
    assert _check_map(gm.tma_layout(ws, p.bk), 3, (f, d, E), p.bk) == \
        (f * 2, d * f * 2)


@pytest.mark.parametrize("variant", [2, 3])
def test_gmm_shared_memory_fits(variant):
    bm, bn, bk, warps, stages = gm.TC_VARIANTS[variant]
    assert warps == 12 and bn == 2 * gm.PANEL and bk == gm.PANEL
    assert gm.tma_smem_bytes(variant) <= gm.SMEM_LIMIT
    ring = stages * (bk * bn + bm * bk) * 2
    assert bm * (bn + 8) * 2 <= ring            # the staged output tile
    assert (bk * bn * 2) % 1024 == 0 and (bm * bk * 2) % 1024 == 0
    # one more slot would not fit
    assert gm.tma_smem_bytes(variant) + (bk * bn + bm * bk) * 2 + 16 \
        > gm.SMEM_LIMIT


def _intervals_partition(parts, lo, hi):
    parts = sorted(p for p in parts if p[0] < p[1])
    assert parts[0][0] == lo and parts[-1][1] == hi
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("shape", TMA_SHAPES)
def test_gmm_grid_covers_the_output_once(shape):
    """The grid's CTAs store disjoint (token tile, column tile) blocks of
    each expert that together cover (C, f); CTAs past f store nothing;
    each cluster's CTAs share one token tile whose rows their x parts
    cover once."""
    cluster = gm.CLUSTER
    E, C, d, f = shape
    p = gm.plan(E, C, d, f, torch.bfloat16)
    gx, gy, gz = gm.tma_grid(p, E, C, f)
    assert gx % cluster == 0 and gz == E and gy <= 65535 and gz <= 65535
    rows = [(by * p.bm, min(by * p.bm + p.bm, C)) for by in range(gy)]
    cols = [(bx * p.bn, min(bx * p.bn + p.bn, f)) for bx in range(gx)]
    _intervals_partition(rows, 0, C)
    _intervals_partition(cols, 0, f)
    idle = [bx for bx in range(gx) if bx * p.bn >= f]
    assert len(idle) < cluster
    part = p.bm // cluster
    for by in range(gy):
        t0 = by * p.bm
        _intervals_partition([(t0 + r * part, t0 + (r + 1) * part)
                              for r in range(cluster)], t0, t0 + p.bm)
    if E * C * f <= 2 ** 22:        # small shapes: count every element
        count = np.zeros((C, f), dtype=np.int32)
        for by in range(gy):
            for bx in range(gx):
                r0, c0 = by * p.bm, bx * p.bn
                count[r0:min(r0 + p.bm, C), c0:min(c0 + p.bn, f)] += 1
        assert (count == 1).all()


def test_small_c_shapes_take_the_stream():
    """Every small-C shape of the paths (decode, Kimi-K2's prefill chunk)
    and the off-path four-row chunk take the stream, at the wgmma width
    that holds C; rows TMA cannot read, (2, 1, 99, 37), take the mma.sync
    tile instead."""
    for s in [(8, 8, 6144, 32768), (8, 8, 32768, 6144), (384, 8, 7168, 2048),
              (384, 8, 2048, 7168), (384, 28, 7168, 2048),
              (384, 28, 2048, 7168), (384, 56, 7168, 2048)]:
        p = gm.plan(*s, torch.bfloat16)
        assert p.kernel == "stream" and p.ctas in (128, gm.SMS), s
        assert p.bm == {8: 8, 28: 32, 56: 64}[s[1]]
    x = torch.zeros(2, 1, 99, dtype=torch.bfloat16)
    w = torch.zeros(2, 99, 37, dtype=torch.bfloat16)
    tma = gm._vec_ok(x) and gm._vec_ok(w)
    p = gm.plan(2, 1, 99, 37, torch.bfloat16, tma=tma)
    assert not tma and p.kernel == "tensor_core"


@pytest.mark.parametrize("shape", [s for s in STREAM_SHAPES
                                   if s[2] % 8 == 0 and s[3] % 8 == 0])
def test_stream_tensor_maps(shape):
    """x's map (d, C, E) with boxes of the wgmma width in token rows (C
    rounded up to 8, 16, 32 or 64: the rows past C come from the map's own
    bound on C, not from the next expert), w's (f, d, E) with boxes of 64
    rows of d; both 64 columns wide, strided views described in place."""
    E, C, d, f = shape
    p = gm.plan(E, C, d, f, torch.bfloat16)
    assert p.kernel == "stream" and p.bm in gm.STREAM_ROWS
    assert C <= p.bm and p.bm % 8 == 0
    assert p.bn == gm.STREAM_BN and p.bn // gm.PANEL * p.bm <= 256
    assert p.bm == 8 or p.bm // 2 < C          # the smallest width that holds C
    x = torch.empty((E, C, d), dtype=torch.bfloat16, device="meta")
    w = torch.empty((E, d, f), dtype=torch.bfloat16, device="meta")
    assert _check_map(gm.tma_layout(x, p.bm), 3, (d, C, E), p.bm) == \
        (d * 2, C * d * 2)
    assert _check_map(gm.tma_layout(w, p.bk), 3, (f, d, E), p.bk) == \
        (f * 2, d * f * 2)
    xt = torch.empty((C, E, d), dtype=torch.bfloat16,
                     device="meta").transpose(0, 1)
    ws = torch.empty((2, E, d, f), dtype=torch.bfloat16, device="meta")[1]
    assert _check_map(gm.tma_layout(xt, p.bm), 3, (d, C, E), p.bm) == \
        (E * d * 2, d * 2)
    assert _check_map(gm.tma_layout(ws, p.bk), 3, (f, d, E), p.bk) == \
        (f * 2, d * f * 2)


@pytest.mark.parametrize("rows", gm.STREAM_ROWS)
def test_stream_shared_memory_fits(rows):
    """The most ring slots shared memory holds (``stream_stages``): the
    slots, their barriers, the staged output tile and the alignment fit,
    one more slot would not, and every slot keeps 1024-byte swizzle atoms.
    The ring the plan takes (``STREAM_STAGES``) is within them and keeps
    96 KB of w in flight an SM; the accumulators stay within 128 a
    thread."""
    bn = gm.STREAM_BN
    stages = gm.stream_stages(rows, bn)
    assert stages >= 4 and gm.plan(1, rows, 64, bn, torch.bfloat16).stages \
        == gm.STREAM_STAGES == 3
    smem = gm.stream_smem_bytes(rows, bn, stages)
    assert smem <= gm.SMEM_LIMIT < gm.stream_smem_bytes(rows, bn, stages + 1)
    slot = gm.PANEL * bn * 2 + rows * gm.PANEL * 2
    assert slot % 1024 == 0 and (rows * gm.PANEL * 2) % 1024 == 0
    assert smem == 1024 + stages * (slot + 16) + rows * (bn + 8) * 2
    assert gm.STREAM_STAGES * gm.PANEL * bn * 2 >= 96 * 1024
    assert bn // 64 * rows // 2 <= 128          # accumulators a thread


def _per_cta_slices(walk):
    return [sum(s1 - s0 for _, _, s0, s1, _ in pieces) for pieces in walk]


@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_stream_walk_covers_every_slice_once(shape):
    """The persistent CTAs' walk (the kernel's Python twin) takes every
    (expert, column tile, slice) once, each CTA within one slice of an
    even share: whole items in rounds, CTA c item r ctas + c of round r,
    so that the CTAs stream neighbouring column tiles together; the items
    left after the rounds are cut into ranges of d that cover each once,
    each CTA with at most one piece in each scratch slot.  The tiles and
    slices cover (d, f) of each expert once, ragged edges masked."""
    E, C, d, f = shape
    p = gm.plan(E, C, d, f, torch.bfloat16)
    cols, slices, units = gm.stream_units(E, d, f, p.bn)
    items = E * cols
    assert p.ctas == gm.stream_ctas(items, slices)
    assert min(units, gm.SMS - gm.SMS // 16) <= p.ctas <= min(units, gm.SMS)
    assert cols * p.bn >= f > (cols - 1) * p.bn
    assert slices * gm.PANEL >= d > (slices - 1) * gm.PANEL
    ranges = gm.stream_ranges(items, slices, p.ctas)
    assert ranges[0][0] == 0 and ranges[-1][1] == items % p.ctas * slices
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    walk = gm.stream_pieces(p, E, d, f)
    assert set(_per_cta_slices(walk)) <= {units // p.ctas,
                                          units // p.ctas + 1}
    rounds = items // p.ctas
    seen = []
    cut = {}
    for c, pieces in enumerate(walk):
        assert pieces
        for r in range(rounds):            # the rounds: whole items
            e, f0, s0, s1, slot = pieces[r]
            assert e * cols + f0 // p.bn == r * p.ctas + c
            assert (s0, s1, slot) == (0, slices, None)
        tail = pieces[rounds:]
        slots = [s for *_, s in tail if s is not None]
        assert len(slots) == len(set(slots)) <= 2
        for i, (e, f0, s0, s1, slot) in enumerate(pieces):
            assert 0 <= s0 < s1 <= slices and f0 % p.bn == 0 and f0 < f
            seen += [(e, f0, s) for s in range(s0, s1)]
            if slot is None:
                assert (s0, s1) == (0, slices)
            else:
                assert i >= rounds
                assert slot == (0 if i == rounds else 1)
                assert i in (rounds, len(pieces) - 1)
                cut.setdefault((e, f0), []).append((c, slot, s0, s1))
    assert len(seen) == units
    assert sorted(seen) == [(e, ct * p.bn, s) for e in range(E)
                            for ct in range(cols) for s in range(slices)]
    for pieces in cut.values():
        assert len(pieces) >= 2
        bounds = [(s0 * gm.PANEL, min(d, s1 * gm.PANEL))
                  for _, _, s0, s1 in pieces]
        _intervals_partition(bounds, 0, d)
    if d * f <= 2 ** 22:            # count every weight of every expert
        count = np.zeros((E, d, f), dtype=np.int32)
        for e, f0, s in seen:
            count[e, s * gm.PANEL:(s + 1) * gm.PANEL, f0:f0 + p.bn] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("shape", STREAM_SHAPES)
def test_stream_fold_adds_each_cut_item_once(shape):
    """The second pass (the fold kernel's Python twin) adds every cut item
    once, from the slots its pieces stored, in CTA order; the call needs
    scratch exactly when some item is cut."""
    E, C, d, f = shape
    p = gm.plan(E, C, d, f, torch.bfloat16)
    cols, slices, units = gm.stream_units(E, d, f, p.bn)
    stored = {}
    for c, pieces in enumerate(gm.stream_pieces(p, E, d, f)):
        for e, f0, s0, s1, slot in pieces:
            if slot is not None:
                stored.setdefault(e * cols + f0 // p.bn, []).append((c, slot))
    folds = gm.stream_folds(p, E, d, f)
    assert folds == stored
    assert gm.stream_cuts(E * cols, slices, p.ctas) == bool(folds)


@pytest.mark.parametrize("items,slices", [(133, 4), (132, 7), (264 + 5, 3),
                                          (140, 512), (1, 1), (3, 100)])
def test_stream_fold_skips_empty_ranges(items, slices):
    """When the items left after the rounds have fewer slices than there
    are CTAs, some CTAs' ranges are empty: no piece is theirs, and the
    fold adds only the pieces that were stored."""
    E, f = 1, items * gm.STREAM_BN
    d = slices * gm.PANEL
    p = gm.plan(E, 8, d, f, torch.bfloat16)
    walk = gm.stream_pieces(p, E, d, f)
    stored = {}
    for c, pieces in enumerate(walk):
        for e, f0, s0, s1, slot in pieces:
            if slot is not None:
                stored.setdefault(f0 // p.bn, []).append((c, slot))
    assert gm.stream_folds(p, E, d, f) == stored
    assert sum(_per_cta_slices(walk)) == items * slices


@pytest.mark.parametrize("shape", [(8, 8, 6144, 32768), (384, 8, 7168, 2048),
                                   (384, 8, 2048, 7168), (384, 28, 7168, 2048),
                                   (384, 28, 2048, 7168), (384, 56, 7168, 2048),
                                   (8, 8, 32768, 6144)])
def test_stream_ctas_fill_whole_rounds_where_they_can(shape):
    """Where a count of CTAs from 15/16 of the SMs up divides the items,
    the stream takes the largest such count: every item whole, no scratch
    and no second pass (one launch a call).  Of the path shapes only
    Grok-1's down projection (192 items of 256 columns) has none, and
    runs on every SM with its last items cut."""
    E, C, d, f = shape
    p = gm.plan(E, C, d, f, torch.bfloat16)
    cols, slices, _ = gm.stream_units(E, d, f, p.bn)
    items = E * cols
    fits = [c for c in range(gm.SMS - gm.SMS // 16, gm.SMS + 1)
            if items % c == 0]
    assert p.ctas == (max(fits) if fits else gm.SMS)
    assert gm.stream_cuts(items, slices, p.ctas) == (not fits)
    assert bool(gm.stream_folds(p, E, d, f)) == (not fits)
    grok_down = shape == (8, 8, 32768, 6144)
    assert (p.ctas, bool(fits)) == ((gm.SMS, False) if grok_down
                                    else (128, True))


def test_path_decode_needs_no_second_pass_of_the_old_kind():
    """Grok-1's down projection (few column tiles) is no longer split into
    three passes over d: its CTAs each stream an even share of the slices
    to within one, a whole item in a round and a range of the items left,
    and only items cut by a range's end (at most one per CTA boundary) are
    folded."""
    p = gm.plan(8, 8, 32768, 6144, torch.bfloat16)
    cols, slices, units = gm.stream_units(8, 32768, 6144, p.bn)
    assert (cols, slices, p.ctas) == (6144 // p.bn, 512, 132)
    walk = gm.stream_pieces(p, 8, 32768, 6144)
    assert set(_per_cta_slices(walk)) == {units // 132, units // 132 + 1}
    assert all(pieces[0][2:4] == (0, 512) for pieces in walk)
    assert len(gm.stream_folds(p, 8, 32768, 6144)) <= p.ctas - 1


def test_ablation_variants_apply_to_the_sources():
    """``tools/torch_kernel_ablate.py`` edits the kernels' real sources;
    every variant's edits still apply, each but the bases and the wrapper's
    choices changes its source, and every wrapper attribute a variant sets
    exists; the small-C stream has its no_mma, no_load, ring and width
    variants, the f32 flash attention its products, loads and blocks."""
    path = Path(__file__).resolve().parents[1] / "tools/torch_kernel_ablate.py"
    spec = importlib.util.spec_from_file_location("torch_kernel_ablate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    modules = {mod.GMM: gm, mod.FLASH: fa, mod.F32: gm, mod.FDEC: da,
               mod.FA32: fa}
    for name, (source, edits, knobs) in mod.VARIANTS.items():
        text = mod.variant_source(name)
        assert (text != (mod.build.CSRC / source).read_text()) == bool(edits)
        assert all(hasattr(modules[source], k) for k in knobs), name
    assert {"stream base", "stream no_mma", "stream no_load",
            "stream stages4"} <= set(mod.VARIANTS)
    assert mod.VARIANTS["stream bn128"][2]["STREAM_BN"] == 128
    # the f32 grouped matmul and the bf16 decode: products, loads, layout
    # and tile or ring depth, here and (OLD_VARIANTS) on the parent's
    # sources
    for group, names in (("f32", ("x_store_vec", "tm4tn8", "tm8tn16")),
                         ("fdec", ("stages2", "stages4", "split1",
                                   "no_prefetch"))):
        for v in ("base", "no_mma", "no_load") + names:
            assert f"{group} {v}" in mod.VARIANTS
        for v in ("base", "no_mma", "no_load"):
            assert f"{group} {v}" in mod.OLD_VARIANTS
    assert "f32 x_store_vec" in mod.OLD_VARIANTS
    # the f32 flash attention: products, loads, the 64-row block and the
    # 64-key tile; products and loads also on the kernel before it
    for v in ("base", "no_mma", "no_load", "bq64", "bk64"):
        assert f"fa32 {v}" in mod.VARIANTS
    for v in ("base", "no_mma", "no_load"):
        assert mod.OLD_VARIANTS[f"fa32 {v}"][0] == mod.FA32
    assert mod.VARIANTS["fa32 bq64"][2] == {"F32_BLOCKS": (64,)}
    # the replaced design's variants name its 32-row tile
    for name, (source, edits, knobs) in mod.SYNC_DECODE_VARIANTS.items():
        assert source == mod.GMM and not knobs
        assert all("launch<32, 128, 64, 1, 4, 4, VEC>" == old
                   or "acc[i][j]" in old or "load_chunk<VEC>" in old
                   for old, _ in edits), name


# (E, C, d, f) of every f32 grouped matmul chip_smoke checks: the sweep,
# the edges, the strided view and the path shapes.
F32_SHAPES = sorted(set(chip_smoke.GMM_CASES + chip_smoke.GMM_EDGE_CASES)
                    | {(3, 40, 64, 300)}
                    | {s for s, dt in chip_smoke.GMM_PATH_CASES
                       if dt == torch.float32})


@pytest.mark.parametrize("shape", F32_SHAPES)
def test_f32_grid_covers_every_output_once(shape):
    """The f32 kernel's grid and its threads' outputs (the Python twin
    ``f32_thread_outputs``) cover each of the E x C x f outputs exactly
    once after the stores' masks (row < C, column < f), with row tiles
    fastest on the grid; the 64-row tiles divide Grok-1's 320 rows."""
    E, C, d, f = shape
    p = gm.plan(E, C, d, f, torch.float32)
    gx, gy, gz = gm.f32_grid(p, E, C, f)
    assert gz == E and gx * p.bm >= C > (gx - 1) * p.bm
    assert gy * p.bn >= f > (gy - 1) * p.bn
    per_thread = [gm.f32_thread_outputs(p, t)
                  for t in range(gm.f32_threads(p))]
    tile = sorted(rc for outs in per_thread for rc in outs)
    assert tile == [(r, c) for r in range(p.bm) for c in range(p.bn)]
    hits = np.zeros((C, f), np.int64)
    for bx in range(gx):
        for by in range(gy):
            rows = np.array([r for r, _ in tile]) + bx * p.bm
            cols = np.array([c for _, c in tile]) + by * p.bn
            keep = (rows < C) & (cols < f)
            np.add.at(hits, (rows[keep], cols[keep]), 1)
    assert (hits == 1).all()
    if C == 320:
        assert C % p.bm == 0 and p.bm == gm.ROW_TILES[-1]


@pytest.mark.parametrize("tile", range(len(gm.ROW_TILES)))
def test_f32_tiles_fit_shared_memory(tile):
    """Every f32 variant's two slices of x and w fit the 48 KB of static
    shared memory, its threads split a slice of w evenly, and at 64 rows a
    thread's 8 x 8 tile reads 16 floats of shared memory for 64 fmaf a
    step of d (the 4 x 8 tile it replaced read 12 for 32)."""
    C = gm.ROW_TILES[tile]
    p = gm.plan(8, C, 6144, 32768, torch.float32)
    assert p.variant == tile and p.bm == C and (p.bk, p.stages) == (16, 2)
    assert gm.f32_smem_bytes(p) <= 48 * 1024
    threads = gm.f32_threads(p)
    assert threads <= 1024 and threads % 32 == 0
    assert p.bk * p.bn // 4 % threads == 0
    tm, tn = gm.F32_THREAD_TILES[tile]
    assert p.bm % tm == 0 and p.bn % tn == 0
    if C == 64:
        assert (tm, tn) == (8, 8) and (tm + tn) / (tm * tn) == 0.25
