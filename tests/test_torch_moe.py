"""The port's MoE layer and grouped matmul against ``repro`` on the CPU.

``repro_torch.models.moe.moe_apply`` is held against
``repro.models.moe.moe_apply`` on every case of ``tests/test_moe.py`` (no
drops over a (B,S,E,k) grid, chunking, capacity drops, a uniform router)
and on tied routers, at 2e-4 in f32, with the reference's weights
converted leaf by leaf and inputs drawn by numpy from a seed.  The plain
grouped matmul, which ``ops.grouped_matmul`` runs for a CPU tensor, is held
against the Pallas kernel in interpret mode over the sweep of
``tests/test_kernels.py`` at its tolerances (f32 1e-4; bf16 5e-2 rtol,
5e-1 atol).  The CUDA kernel runs only on the card (``chip_smoke.py``);
here its source, wrapper and dispatch are checked."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models import moe as jax_moe
from repro.models.params import init_params as jax_init_params
from repro_torch import convert
from repro_torch.kernels import build, grouped_matmul, ops
from repro_torch.models import moe

KERNELS = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels"
TOL = dict(rtol=2e-4, atol=2e-4)
METRICS = ("moe_aux_loss", "moe_z_loss", "moe_dropped_frac")


def _params(seed, d, f, E):
    """The reference's random MoE parameters: (numpy tree, torch tree)."""
    p = jax_init_params(jax_moe.moe_spec(d, f, E), jax.random.PRNGKey(seed),
                        jnp.float32)
    p = jax.tree.map(lambda a: np.array(a), p)     # writable copies
    return p, convert.params_from_reference(p, device="cpu")


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _both(jp, tp, x, **kw):
    want, jaux = jax_moe.moe_apply(jax.tree.map(jnp.asarray, jp),
                                   jnp.asarray(x), **kw)
    got, aux = moe.moe_apply(tp, torch.from_numpy(x), **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(aux) == set(jaux) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **TOL,
                                   err_msg=k)
    return got, aux


@pytest.mark.parametrize("B,S,E,k", [(2, 16, 4, 2), (1, 32, 8, 2),
                                     (3, 8, 4, 1)])
def test_moe_matches_reference_no_drops(B, S, E, k):
    jp, tp = _params(0, 16, 32, E)
    _, aux = _both(jp, tp, _x(1, (B, S, 16), 0.5), top_k=k,
                   capacity_factor=float(E))
    assert float(aux["moe_dropped_frac"]) == 0.0


@pytest.mark.parametrize("seq_chunk", [16, 64])
def test_moe_seq_chunking_matches_reference(seq_chunk):
    """S=64 in chunks of 16 (a loop of 4) and of 64 (one chunk): each
    equals the reference, and the two agree with each other."""
    jp, tp = _params(2, 16, 32, 4)
    x = _x(3, (2, 64, 16), 0.5)
    got, _ = _both(jp, tp, x, top_k=2, capacity_factor=4.0,
                   seq_chunk=seq_chunk)
    other, _ = moe.moe_apply(tp, torch.from_numpy(x), top_k=2,
                             capacity_factor=4.0,
                             seq_chunk={16: 64, 64: 16}[seq_chunk])
    np.testing.assert_allclose(got.numpy(), other.numpy(), **TOL)


def test_moe_chunk_metrics_are_averaged():
    """With drops, capacity and the metrics are per chunk: the chunked
    call's metrics are the mean of the chunks' own."""
    _, tp = _params(4, 8, 16, 4)
    x = torch.from_numpy(_x(5, (1, 64, 8)))
    _, whole = moe.moe_apply(tp, x, top_k=2, capacity_factor=0.5,
                             seq_chunk=16)
    parts = [moe.moe_apply(tp, x[:, i:i + 16], top_k=2,
                           capacity_factor=0.5)[1] for i in range(0, 64, 16)]
    for k in METRICS:
        assert float(whole[k]) == pytest.approx(
            float(np.mean([float(p[k]) for p in parts])), rel=1e-6)


def test_moe_capacity_drops_match_reference():
    jp, tp = _params(4, 8, 16, 4)
    _, aux = _both(jp, tp, _x(5, (1, 64, 8)), top_k=2, capacity_factor=0.25)
    assert float(aux["moe_dropped_frac"]) > 0.1


def test_moe_uniform_router_matches_reference():
    jp, tp = _params(6, 8, 16, 4)
    jp["router"] = np.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    _, aux = _both(jp, tp, _x(7, (2, 128, 8)), top_k=2, capacity_factor=4.0)
    assert float(aux["moe_aux_loss"]) == pytest.approx(1.0, rel=0.15)


@pytest.mark.parametrize("tie", ["all", "pairs"])
def test_tied_router_picks_like_lax_top_k(tie):
    """``jax.lax.top_k`` takes the lower index first among equal values:
    with a zero router every expert ties, and with duplicated router
    columns experts tie in pairs.  The port picks the same experts, keeps
    and drops the same slots, and gives the same output."""
    jp, tp = _params(8, 8, 16, 8)
    if tie == "all":
        jp["router"] = np.zeros_like(jp["router"])
    else:
        jp["router"][:, 4:] = jp["router"][:, :4]
    tp["router"] = torch.from_numpy(jp["router"].copy())
    x = _x(9, (2, 32, 8))
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x),
                        jnp.asarray(jp["router"]))
    want_gates, want_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    _, _, gates, idx = moe.route(torch.from_numpy(x), tp["router"], 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates), **TOL)
    if tie == "all":
        assert (idx.numpy() == [0, 1]).all()
    _, aux = _both(jp, tp, x, top_k=2, capacity_factor=1.0)
    assert float(aux["moe_dropped_frac"]) > 0.0


def test_moe_runs_three_grouped_matmuls_per_chunk(monkeypatch):
    """The expert FFNs go through ``ops.grouped_matmul``: three calls per
    chunk, each over every expert's B*C rows, expert-major."""
    _, tp = _params(10, 8, 16, 4)
    calls = []
    real = ops.grouped_matmul

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(ops, "grouped_matmul", spy)
    moe.moe_apply(tp, torch.from_numpy(_x(11, (2, 64, 8))), top_k=2,
                  capacity_factor=1.25, seq_chunk=16)
    C = -(-16 * 2 * 1.25 // 4)                    # per row and chunk: 10
    rows = 2 * int(C)
    assert calls == [((4, rows, 8), (4, 8, 16)), ((4, rows, 8), (4, 8, 16)),
                     ((4, rows, 16), (4, 16, 8))] * 4


@pytest.mark.parametrize("S,n", [(1, 1), (512, 1), (513, 1), (1024, 2),
                                 (2048, 4), (1000, 1)])
def test_chunk_count_follows_the_reference_rule(S, n):
    assert moe.n_chunks(S) == n


# ---- the grouped matmul ----------------------------------------------------

GMM_DTYPES = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("E,C,d,f,bc,bf,bd", [
    (4, 64, 96, 64, 32, 32, 32),
    (2, 100, 64, 48, 64, 16, 64),    # padded C/f
    (8, 32, 128, 128, 32, 128, 128),
])
def test_grouped_matmul_matches_pallas(dtype, E, C, d, f, bc, bf, bd):
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((E, C, d)).astype(np.float32)
    ws = rng.standard_normal((E, d, f)).astype(np.float32)
    jdt, tdt = GMM_DTYPES[dtype]
    want = jax_ops.grouped_matmul(jnp.asarray(xs).astype(jdt),
                                  jnp.asarray(ws).astype(jdt), block_c=bc,
                                  block_f=bf, block_d=bd)
    got = ops.grouped_matmul(torch.from_numpy(xs).to(tdt),
                             torch.from_numpy(ws).to(tdt))
    assert got.dtype == tdt and got.shape == (E, C, f)
    tol = dict(rtol=5e-2, atol=5e-1) if dtype == "bf16" \
        else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_grouped_matmul_takes_strided_views():
    """One layer's slice of stacked weights and a transposed x go in as
    views; the result equals the contiguous call's."""
    g = torch.Generator().manual_seed(13)
    stacked = torch.randn(3, 2, 8, 12, generator=g)
    x = torch.randn(8, 2, 5, generator=g).permute(1, 2, 0)   # (2,5,8) view
    got = ops.grouped_matmul(x, stacked[1])
    want = torch.einsum("ecd,edf->ecf", x.contiguous(), stacked[1].clone())
    torch.testing.assert_close(got, want)


def _xw(E=2, C=3, d=8, f=16):
    return torch.zeros(E, C, d), torch.zeros(E, d, f)


GMM_BAD = {
    "rank2_x": lambda x, w: (x[0], w),
    "rank4_w": lambda x, w: (x, w[None]),
    "float16": lambda x, w: (x.half(), w.half()),
    "mixed_dtype": lambda x, w: (x, w.bfloat16()),
    "experts_differ": lambda x, w: (x, w[:1]),
    "depth_differs": lambda x, w: (x, w[:, :7]),
    "no_rows": lambda x, w: (x[:, :0], w),
    "no_columns": lambda x, w: (x, w[:, :, :0]),
    "numpy_x": lambda x, w: (x.numpy(), w),
    "numpy_w": lambda x, w: (x, w.numpy()),
}


@pytest.mark.parametrize("case", sorted(GMM_BAD))
def test_grouped_matmul_inputs_are_checked(case):
    with pytest.raises((ValueError, TypeError)):
        ops.grouped_matmul(*GMM_BAD[case](*_xw()))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the dispatcher sees
    when it is handed a CUDA tensor."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_grouped_matmul_refuses_gradients_on_cuda():
    """No backward kernel: a CUDA call that would need a gradient raises
    (before the card is even looked for) instead of taking the plain
    path."""
    x, w = _xw()
    x.requires_grad_(True)
    args = [t.as_subclass(_FakeCuda) for t in (x, w)]
    assert args[0].requires_grad
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ops.grouped_matmul(*args)
    with torch.no_grad():
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA device"):
                ops.grouped_matmul(*args)


def test_grouped_matmul_refuses_cuda_tensor_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.grouped_matmul(*(t.as_subclass(_FakeCuda) for t in _xw()))


@pytest.mark.parametrize("C,tile", [(1, 0), (8, 0), (9, 1), (32, 1),
                                    (33, 2), (320, 2), (16, 1), (28, 1),
                                    (64, 2), (1000, 2)])
def test_row_tile_follows_the_rows(C, tile):
    """f32: decode's 8 rows per expert take the CUDA-core kernel's 8-row
    tile, so a CTA computes no padded rows there.  bf16: the ``TC_VARIANTS``
    entry whose rows hold C (the last when none does): up to 32 and 64 rows
    the small-C stream, whose wgmma width is C rounded up to 8, 16, 32 or
    64 (decode and Kimi-K2's 28-row prefill chunk compute no padded row
    past the next multiple of 8), then one wgmma CTA over 160 or 320 rows
    (Grok-1's 320-row chunk is one tile, so w is read once)."""
    gm = grouped_matmul
    assert gm.row_tile(C) == tile
    assert gm.ROW_TILES[tile] >= min(C, 64)
    f32 = gm.plan(2, C, 64, 96, torch.float32)
    assert (f32.kernel, f32.regime, f32.variant, f32.bm, f32.ctas) == \
        ("cuda_core", "f32", tile, gm.ROW_TILES[tile], 0)
    bf = gm.plan(2, C, 64, 96, torch.bfloat16)
    rows = [v[0] for v in gm.TC_VARIANTS]
    assert bf.variant == next((i for i, bm in enumerate(rows) if C <= bm),
                              len(rows) - 1)
    assert bf.regime == ("decode" if C <= 32 else "prefill")
    assert bf.variant == 0 or rows[bf.variant - 1] < C
    if bf.variant < gm.STREAM_VARIANTS:
        assert bf.kernel == "stream" and bf.bm == gm.stream_rows(C)
        assert C <= bf.bm <= rows[bf.variant] and bf.bm % 8 == 0
        assert bf.bm == 8 or bf.bm // 2 < C
        assert (bf.bn, bf.bk) == tuple(gm.TC_VARIANTS[bf.variant][1:3])
        assert bf.stages == gm.STREAM_STAGES <= gm.stream_stages(bf.bm,
                                                                 bf.bn)
        assert bf.ctas == gm.stream_ctas(2, 1) == 2
    else:
        assert bf.kernel == "wgmma" and bf.ctas == 0
        assert bf.bm == rows[bf.variant] and bf.bm % 16 == 0
        assert bf.bm >= C or bf.bm == max(rows)
        assert (bf.bm, bf.bn, bf.bk, bf.stages) == tuple(
            gm.TC_VARIANTS[bf.variant][i] for i in (0, 1, 2, 4))


# (E, C, d, f) of every grouped matmul on the serving paths: Grok-1's and
# Kimi-K2's gate/up and down projections at decode and in a prefill chunk.
GMM_PATH_SHAPES = {
    "grok decode": (8, 8, 6144, 32768),
    "grok decode down": (8, 8, 32768, 6144),
    "grok prefill": (8, 320, 6144, 32768),
    "grok prefill down": (8, 320, 32768, 6144),
    "kimi decode": (384, 8, 7168, 2048),
    "kimi decode down": (384, 8, 2048, 7168),
    "kimi prefill": (384, 28, 7168, 2048),
    "kimi prefill down": (384, 28, 2048, 7168)}


@pytest.mark.parametrize("name", sorted(GMM_PATH_SHAPES))
def test_gmm_plan_at_the_path_shapes(name):
    """bf16 takes the tensor cores at every path shape, in the regime its
    rows call for: up to 64 rows the small-C stream, every SM streaming
    many slices; f32 takes the CUDA cores."""
    gm = grouped_matmul
    E, C, d, f = GMM_PATH_SHAPES[name]
    p = gm.plan(E, C, d, f, torch.bfloat16)
    assert p.kernel == ("wgmma" if C > 64 else "stream")
    assert p.regime == ("prefill" if C > 32 else "decode")
    assert gm.plan(E, C, d, f, torch.float32).kernel == "cuda_core"
    if p.kernel == "stream":
        units = gm.stream_units(E, d, f, p.bn)[2]
        assert p.ctas in (128, gm.SMS) and units // p.ctas >= 500
        assert p.bm == (8 if C == 8 else 32)
        assert p.bn == gm.STREAM_BN
    else:
        assert p.cluster == gm.CLUSTER and p.ctas == 0
    if name == "grok decode down":      # few column tiles: no split of d
        assert units == 8 * (6144 // p.bn) * 512    # into passes


@pytest.mark.parametrize("E,C,d,f,variant", [
    (8, 160, 6144, 32768, 2),        # Grok-1, a chunk of one 512-token row
    (8, 640, 6144, 32768, 3),        # Grok-1, of four rows: two tiles
    (384, 42, 7168, 2048, 1),        # Kimi-K2, of three rows
    (384, 56, 7168, 2048, 1),        # Kimi-K2, of four rows
    (384, 14, 7168, 2048, 0)])       # Kimi-K2, of one row
def test_gmm_plan_off_the_path(E, C, d, f, variant):
    """Prefill chunks of other batch sizes take the tile that holds their
    rows, not the 320-row one sized for the path's."""
    assert grouped_matmul.plan(E, C, d, f, torch.bfloat16).variant == variant


def test_gmm_padding_share_is_bounded():
    """Above decode's 32 rows, where the tensor cores set the time, no C
    up to 2048 pads more than 60% of a launch's rows (a single 320-row
    tile would pad 87% at C = 42)."""
    for C in range(33, 2049):
        p = grouped_matmul.plan(8, C, 6144, 32768, torch.bfloat16)
        padded = -(-C // p.bm) * p.bm
        assert (padded - C) / padded <= 0.6, (C, p.bm)


@pytest.mark.parametrize("E,C,d,f", [
    (8, 8, 32768, 6144), (8, 8, 6144, 32768), (3, 13, 1000, 300),
    (2, 1, 99, 37), (1, 1, 64, 8), (1, 1, 100000, 8), (4, 30, 4097, 16),
    (1, 5, 513, 128), (384, 28, 2048, 7168)])
def test_gmm_split_covers_d_exactly(E, C, d, f):
    """The small-C stream cuts d only where a CTA's range of slices ends:
    the pieces of every item, [s0 * 64, min(d, s1 * 64)), are whole slices,
    none empty, and together cover d once; every CTA streams an even share
    of the slices to within one."""
    gm = grouped_matmul
    p = gm.plan(E, C, d, f, torch.bfloat16)
    assert p.kernel == "stream" and p.bk == gm.PANEL
    cols, slices, units = gm.stream_units(E, d, f, p.bn)
    items = {}
    for pieces in gm.stream_pieces(p, E, d, f):
        for e, f0, s0, s1, _ in pieces:
            items.setdefault((e, f0), []).append(
                (s0 * p.bk, min(d, s1 * p.bk)))
    assert len(items) == E * cols
    for ranges in items.values():
        assert ranges[0][0] == 0 and ranges[-1][1] == d
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    per_cta = [sum(s1 - s0 for _, _, s0, s1, _ in pieces)
               for pieces in gm.stream_pieces(p, E, d, f)]
    assert set(per_cta) <= {units // p.ctas, units // p.ctas + 1}


def _code(src: str) -> str:
    """A CUDA source without its // comments (which may name TF32 to say
    why it is not used)."""
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_grouped_matmul_cuda_source():
    src = (build.CSRC / "grouped_matmul.cu").read_text()
    tc = (build.CSRC / "grouped_matmul_tc.cu").read_text()
    header = (build.CSRC / "mma_sm90.cuh").read_text()
    flags = " ".join(build.NVCC_FLAGS)
    for text in (_code(src), _code(tc), _code(header), flags):
        assert "use_fast_math" not in text and "tf32" not in text.lower()
    assert 'extern "C" int grouped_matmul_fwd' in src
    assert 'extern "C" int grouped_matmul_bf16_fwd' in tc
    for text in (src, tc):
        assert "cuda_error_string" in text and "cudaGetLastError" in text
    assert "constexpr int kBN = 128;" in src and grouped_matmul.BN == 128
    for bm, (tm, tn) in zip(grouped_matmul.ROW_TILES,
                            grouped_matmul.F32_THREAD_TILES):
        assert f"launch<T, {bm}, {tm}, {tn}, VEC>" in src
    # f32 stays on the CUDA cores; bf16 runs the small-C stream and the
    # prefill kernel warp-specialised under TMA on wgmma, and mma.sync
    # where TMA cannot read, from the headers.
    assert "mma" not in _code(src) and "bfloat16" not in _code(src)
    assert '#include "mma_sm90.cuh"' in tc and "mma_bf16_16816(" in tc
    assert '#include "tma_sm90.cuh"' in tc and "ldmatrix_x4_trans(" in tc
    for call in ("wgmma_m64n160k16_ta(", "tma_load_3d(",
                 "tma_load_3d_multicast(", "mbar_arrive_cluster(",
                 "setmaxnreg_dec<", "setmaxnreg_inc<", "stmatrix_x4_trans(",
                 "cudaLaunchAttributeClusterDimension", "cluster_sync()",
                 "gmm_stream_kernel<N, NT>", "wgmma_m64nNk16_ta<N>(",
                 "cudaLaunchKernelEx(&cfg, gmm_stream_fold_kernel,",
                 "cudaLaunchAttributeProgrammaticStreamSerialization",
                 "grid_dependency_wait();", "launch_dependents();",
                 "mbar_expect_tx(",
                 'extern "C" int grouped_matmul_bf16_stream'):
        assert call in tc, call
    # the stream's fold is a second pass in a fixed order: no atomics, no
    # cp.async copies, no split-K pass of the old kind
    for gone in ("atomic", "cp_async", "splitk", "gmm_wgmma_t_kernel"):
        assert gone not in _code(tc).lower(), gone
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16" in header
    for rows in grouped_matmul.STREAM_ROWS:
        assert f"wgmma.mma_async.sync.aligned.m64n{rows}k16.f32.bf16.bf16" \
            in header
        case = tc.split("int dispatch_stream(")[1].split(f"case {rows}:")[1]
        assert case.split(";")[0].strip().startswith(
            f"return launch_stream<{rows}, NT>("), rows
    bn = grouped_matmul.STREAM_BN
    assert f"if (bn == {bn})\n    return dispatch_stream<{bn // 64}>(" in tc
    assert "constexpr int kStreamThreads = 160;" in tc
    assert "return 1024 + stages * (kSlot + 16) + kStage;" in tc
    n_stream = grouped_matmul.STREAM_VARIANTS
    for i, (bm, bn, bk, warps, stages) in enumerate(
            grouped_matmul.TC_VARIANTS):
        if i < n_stream:
            assert warps * 32 == 160 and bk == grouped_matmul.PANEL
            assert bm == grouped_matmul.STREAM_ROWS[i + 2] and stages == 0
        else:
            case = tc.split("int dispatch(")[1].split(f"case {i}:")[1]
            assert bm % 160 == 0 and warps == 12
            assert f"return launch_tma<{bm // 160}, {stages}, kCluster>(" \
                in case.split("case ")[0], i
            assert "static constexpr int kBF = " \
                f"{bn}, kBT = 160 * NH, kBK = {bk};" in tc
    bm, bn, bk, warps, stages = grouped_matmul.SYNC_TILE
    assert f"if (variant == {grouped_matmul.SYNC_VARIANT})" in tc
    assert f"gmm_tc_kernel<{bm}, {bn}, {bk}, 2, 4, {stages}>" in tc
    assert warps == 2 * 4
    assert f"case {grouped_matmul.SYNC_VARIANT}:" not in tc
    assert f"constexpr int kCluster = {grouped_matmul.CLUSTER};" in tc
    assert f"constexpr int kSmemLimit = {grouped_matmul.SMEM_LIMIT};" in tc


def test_no_try_around_the_grouped_matmul():
    for name in ("ops.py", "grouped_matmul.py"):
        tree = ast.parse((KERNELS / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name
