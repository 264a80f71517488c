"""The port's attention kernels against ``repro``'s on the CPU.

``repro_torch.kernels.ops.flash_attention`` and ``ops.flash_decode`` take a
CPU tensor to their plain versions; each is held against the reference's
Pallas kernel, run in interpret mode as ``tests/test_kernels.py`` runs it,
on the same numpy-seeded inputs, with that file's tolerances: 2e-5 in f32,
2e-2 in bf16.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here their sources, wrappers and dispatch are
checked."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro_torch.kernels import (build, decode_attention, flash_attention,
                                 ops, ref)
from repro_torch.models import attention as port_attn

KERNELS = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor (bf16 rounds the
    same f32 numbers to nearest-even on both sides)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,K,S,D,bq,bk", [
    (1, 4, 4, 128, 64, 64, 64),      # MHA
    (2, 8, 2, 256, 64, 128, 128),    # GQA
    (1, 4, 2, 96, 32, 64, 64),       # padded (non-multiple) seq
    (1, 8, 2, 96, 112, 64, 64),      # Kimi-K2's head dim, GQA, padded
])
def test_flash_attention_matches_pallas(dtype, B, H, K, S, D, bq, bk):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    ((B, H, S, D), (B, K, S, D),
                                     (B, K, S, D)))
    want = jax_ops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                   block_k=bk)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, H, S, D)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("window", [16, 100])
def test_flash_attention_sliding_window_matches_pallas(window):
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "f32") for s in
                                    ((1, 4, 256, 32), (1, 2, 256, 32),
                                     (1, 2, 256, 32)))
    want = jax_ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                   block_q=64, block_k=64)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("f32"))


def test_flash_attention_padded_kv_matches_oracle():
    """T not a multiple of any block, and T != S, not causal: the key mask
    k < T is all that applies."""
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "f32") for s in
                                    ((1, 4, 40, 32), (1, 2, 70, 32),
                                     (1, 2, 70, 32)))
    want = jax_ref.mha_reference(jq, jk, jv, causal=False)
    got = ops.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("f32"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,K,G,T,D,bk", [
    (2, 2, 2, 256, 64, 128),
    (1, 4, 1, 100, 32, 64),          # padded T
    (2, 8, 8, 130, 112, 64),         # Kimi-K2's head dim and group of 8
])
def test_flash_decode_matches_pallas(dtype, B, K, G, T, D, bk):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, dtype) for s in
                                    ((B, K, G, D), (B, K, T, D),
                                     (B, K, T, D)))
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = 1                   # the shortest valid prefix
    want = jax_ops.flash_decode(jq, jk, jv, jnp.asarray(lengths), block_k=bk)
    got = ops.flash_decode(tq, tk, tv, torch.from_numpy(lengths))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, K, G, D)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_oracles_are_twins():
    rng = np.random.default_rng(4)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "f32") for s in
                                    ((2, 4, 24, 16), (2, 2, 24, 16),
                                     (2, 2, 24, 16)))
    for causal, window in ((True, 0), (True, 5), (False, 0)):
        np.testing.assert_allclose(
            _np(ref.mha_reference(tq, tk, tv, causal=causal, window=window)),
            _np(jax_ref.mha_reference(jq, jk, jv, causal=causal,
                                      window=window)), rtol=1e-6, atol=1e-6)
    lengths = np.array([3, 24], np.int32)
    np.testing.assert_allclose(
        _np(ref.decode_reference(tq[:, :, 0], tk, tv,
                                 torch.from_numpy(lengths))),
        _np(jax_ref.decode_reference(jq[:, :, 0], jk, jv,
                                     jnp.asarray(lengths))),
        rtol=1e-6, atol=1e-6)


def test_strided_views_equal_contiguous():
    """The model hands the kernels (B,S,H,D) and (B,T,K,D) tensors as
    (B,H,S,D) / (B,K,T,D) views; the result does not depend on it, and the
    output keeps q's layout on the card (checked there)."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 33, 4, 16, generator=g)
    k = torch.randn(2, 33, 2, 16, generator=g)
    v = torch.randn(2, 33, 2, 16, generator=g)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert torch.equal(ops.flash_attention(*views),
                       ops.flash_attention(*(t.contiguous() for t in views)))
    lengths = torch.tensor([5, 33])
    qg = q[:, 0].reshape(2, 2, 2, 16)
    assert torch.equal(ops.flash_decode(qg, views[1], views[2], lengths),
                       ops.flash_decode(qg, views[1].contiguous(),
                                        views[2].contiguous(), lengths))


def test_kernel_layout_keeps_views_and_copies_the_rest():
    x = torch.zeros(2, 8, 4, 16).transpose(1, 2)
    assert flash_attention.kernel_layout(x) is x
    y = torch.zeros(2, 4, 16, 8).transpose(2, 3)          # last dim strided
    z = flash_attention.kernel_layout(y)
    assert z.is_contiguous() and torch.equal(z, y)
    w = torch.zeros(2, 4, 8, 18)[..., :16]                # rows not 16-byte
    assert flash_attention.kernel_layout(w).is_contiguous()


@pytest.mark.parametrize("expand_heads", [True, False])
def test_dense_attention_matches_reference(expand_heads):
    rng = np.random.default_rng(6)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "f32") for s in
                                    ((2, 12, 4, 16), (2, 12, 2, 16),
                                     (2, 12, 2, 16)))
    pos = np.arange(12, dtype=np.int32)
    valid = np.ones((2, 12), bool)
    valid[0, 9:] = False
    want = jax_attn.dense_attention(
        jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), causal=True,
        window=5, kv_valid=jnp.asarray(valid), expand_heads=expand_heads)
    got = port_attn.dense_attention(
        tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos),
        causal=True, window=5, kv_valid=torch.from_numpy(valid),
        expand_heads=expand_heads)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_prefill_kernel_ties_to_dense_path():
    """The kernel computes what the reference model's dense path computes
    (the port's prefill calls it where ``repro`` calls dense_attention)."""
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, s, "f32") for s in
                                    ((1, 64, 4, 32), (1, 64, 2, 32),
                                     (1, 64, 2, 32)))
    pos = jnp.arange(64)
    want = jax_attn.dense_attention(jq, jk, jv, pos, pos, causal=True)
    got = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n_rows,T", [(1, 1), (64, 4096), (128, 32768),
                                      (3, 100), (2048, 300), (8, 129)])
def test_decode_split_covers_the_cache(n_rows, T):
    chunk, n_chunks = decode_attention.split(n_rows, T)
    assert chunk % decode_attention.TILE == 0
    assert (n_chunks - 1) * chunk < T <= n_chunks * chunk
    assert n_rows * n_chunks <= max(
        n_rows, 2 * decode_attention.CTAS_PER_SM * decode_attention.SMS)


def _qkv(shape_q=(1, 4, 8, 16), shape_kv=(1, 2, 8, 16)):
    return torch.zeros(shape_q), torch.zeros(shape_kv), torch.zeros(shape_kv)


FLASH_BAD = {
    "rank3": lambda q, k, v: (q[0], k, v),
    "float16": lambda q, k, v: (q.half(), k.half(), v.half()),
    "mixed_dtype": lambda q, k, v: (q, k.bfloat16(), v),
    "heads_not_multiple": lambda q, k, v: (q[:, :3], k, v),
    "head_dim_48": lambda q, k, v: (torch.zeros(1, 4, 8, 48),
                                    torch.zeros(1, 2, 8, 48),
                                    torch.zeros(1, 2, 8, 48)),
    "kv_shapes_differ": lambda q, k, v: (q, k, v[:, :, :4]),
    "numpy_q": lambda q, k, v: (q.numpy(), k, v),
}


@pytest.mark.parametrize("case", sorted(FLASH_BAD))
def test_flash_attention_inputs_are_checked(case):
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(*FLASH_BAD[case](*_qkv()))


@pytest.mark.parametrize("window", [-1, 2.5, True])
def test_flash_attention_window_is_checked(window):
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(*_qkv(), window=window)


DECODE_BAD = {
    "group_9": lambda q, k, v, n: (torch.zeros(1, 2, 9, 16), k, v, n),
    "lengths_float": lambda q, k, v, n: (q, k, v, n.float()),
    "lengths_short": lambda q, k, v, n: (q, k, v, n[:0]),
    "kv_batch": lambda q, k, v, n: (q, k[:, :1], v[:, :1], n),
    "head_dim_24": lambda q, k, v, n: (torch.zeros(1, 2, 2, 24),
                                       torch.zeros(1, 2, 8, 24),
                                       torch.zeros(1, 2, 8, 24), n),
}


@pytest.mark.parametrize("case", sorted(DECODE_BAD))
def test_flash_decode_inputs_are_checked(case):
    args = (torch.zeros(1, 2, 2, 16), torch.zeros(1, 2, 8, 16),
            torch.zeros(1, 2, 8, 16), torch.tensor([3]))
    with pytest.raises((ValueError, TypeError)):
        ops.flash_decode(*DECODE_BAD[case](*args))


@pytest.mark.parametrize("name", ["flash_attention.cu",
                                  "flash_attention_wgmma.cu",
                                  "flash_decode.cu", "flash_decode_tc.cu"])
def test_cuda_sources(name):
    src = (build.CSRC / name).read_text()
    flags = " ".join(build.NVCC_FLAGS)
    for text in (_code(src), flags):         # no fast math, no TF32
        assert "use_fast_math" not in text and "tf32" not in text.lower()
        assert "ftz=true" not in text
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-1e30f" in src                   # the reference's finite fill
    assert 'extern "C" int' in src and "cuda_error_string" in src
    assert "cudaGetLastError" in src
    for d in flash_attention.HEAD_DIMS:      # every head dim has a kernel
        assert f"case {d}:" in src, d


def _code(src: str) -> str:
    """A CUDA source without its // comments (which may name TF32 to say
    why it is not used)."""
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_bf16_attention_runs_on_the_tensor_cores():
    """The bf16 kernel is warp-specialised through the shared headers: a
    producer warpgroup gives up registers and issues TMA copies under
    full and empty mbarriers, two consumer warpgroups take registers and
    multiply with wgmma (S = Q K^T from shared memory, O += P V with P in
    registers and V through the transpose bit), taking turns through named
    barriers; no mma.sync, no cp.async.  The f32 kernel stays on the CUDA
    cores (no tensor-core instruction, so no TF32)."""
    wg = _code((build.CSRC / "flash_attention_wgmma.cu").read_text())
    header = (build.CSRC / "mma_sm90.cuh").read_text()
    tma = (build.CSRC / "tma_sm90.cuh").read_text()
    assert '#include "mma_sm90.cuh"' in wg and '#include "tma_sm90.cuh"' in wg
    for call in ("wgmma_m64n128k16_ss(", "wgmma_m64n128k16_rs_tb(",
                 "wgmma_m64n64k16_rs_tb(", "tma_load_4d(", "mbar_wait(",
                 "mbar_expect_tx(", "setmaxnreg_dec<kProducerRegs>",
                 "setmaxnreg_inc<kConsumerRegs>", "bar_sync(", "bar_arrive(",
                 "__grid_constant__ CUtensorMap", "encode_bf16_map("):
        assert call in wg, call
    for gone in ("mma_bf16_16816(", "ldmatrix", "cp_async16("):
        assert gone not in wg, gone
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in header
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in header
    assert "cp.async.bulk.tensor.4d" in tma and "setmaxnreg" in tma
    assert "cudaGetDriverEntryPoint" in tma and "-lcuda" not in \
        " ".join(build.NVCC_FLAGS)
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in tma
    assert "tf32" not in _code(header + tma).lower()
    f32 = _code((build.CSRC / "flash_attention.cu").read_text())
    assert "mma" not in f32 and "bfloat16" not in f32
    assert not (build.CSRC / "flash_attention_tc.cu").exists()


@pytest.mark.parametrize("B,H,S,D", [
    (4, 32, 2048, 128),              # Qwen3-4B's prefill
    (2, 48, 2048, 128),              # Grok-1's
    (2, 64, 2048, 112),              # Kimi-K2's
    (1, 4, 24, 16),                  # a smoke config's
])
def test_flash_plan_picks_the_kernel_by_dtype(B, H, S, D):
    bf = flash_attention.plan(B, H, S, D, torch.bfloat16)
    # one producer and two consumer warpgroups of WG_ROWS query rows each
    assert bf.kernel == "wgmma" and bf.warps == 12
    assert bf.block_q == 2 * flash_attention.WG_ROWS
    items = -(-S // bf.block_q) * B * H      # persistent: a CTA per SM
    assert bf.grid == (min(items, flash_attention.SMS), 1)
    assert bf.stages >= 2
    f32 = flash_attention.plan(B, H, S, D, torch.float32)
    assert f32.kernel == "cuda_core"
    assert f32.block_q in flash_attention.F32_BLOCKS
    assert f32.grid[0] == B * H      # heads on x, query blocks on y
    assert f32.grid[1] * f32.block_q >= S > (f32.grid[1] - 1) * f32.block_q
    with pytest.raises(ValueError):
        flash_attention.plan(B, H, S, 48, torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention.plan(B, H, S, D, torch.float16)


def _constants(src: str) -> dict:
    """The file-scope ``constexpr int name = value;`` of a CUDA source,
    evaluated in order (a value may name an earlier constant)."""
    out = {}
    for line in _code(src).splitlines():
        line = line.rstrip()
        if line.startswith("constexpr int ") and line.endswith(";"):
            name, value = line[len("constexpr int "):-1].split(" = ")
            out[name] = eval(value, {}, dict(out))
    return out


def test_flash_plan_matches_the_sources():
    """The plan's blocks, warps, ring and grid, the consumer rows and the
    shared memory are those the kernels launch."""
    f32 = flash_attention.plan(2, 4, 200, 64, torch.float32)
    bf = flash_attention.plan(2, 4, 200, 64, torch.bfloat16)
    src = (build.CSRC / "flash_attention_wgmma.cu").read_text()
    c = _constants(src)
    assert (c["kBQ"], c["kBKV"], c["kThreads"] // 32) == \
        (bf.block_q, bf.block_k, bf.warps)
    f32_src = (build.CSRC / "flash_attention.cu").read_text()
    c = _constants(f32_src)
    assert (c["kBK"], c["kThreads"] // 32, c["kSlots"], c["kPanel"]) == (
        f32.block_k, f32.warps, f32.stages, flash_attention.F32_PANEL)
    assert c["kThreads"] == flash_attention.F32_THREADS == 16 * 16
    # the query rows a CTA are a template parameter: one instance each
    for bq in flash_attention.F32_BLOCKS:
        assert f"case {bq}:\n      return launch<D, {bq}>(" in f32_src, bq
    assert "const dim3 grid(B * H, (S + BQ - 1) / BQ);" in f32_src
    assert "const int qb = gridDim.y - 1 - blockIdx.y;" in f32_src
    assert f32.block_q == 64 and f32.grid == (8, -(-200 // 64))
    big = flash_attention.plan(4, 32, 2048, 128, torch.float32)
    assert big.block_q == 128 and big.grid == (128, 16)
    assert "BQ * D + BQ * kBK +\n                             kSlots * kBK * " \
        "Panels<D>::kWidth" in f32_src       # f32_smem_bytes' terms
    for D in flash_attention.HEAD_DIMS:
        n, width = flash_attention.f32_panels(D)
        assert n * flash_attention.F32_PANEL >= D > (n - 1) * \
            flash_attention.F32_PANEL and width == min(D, 64)
    assert "flash_wgmma_kernel<D><<<ctas, kThreads, smem, stream>>>" in src
    assert "q0 = (n_qb - 1 - i / BH) * kBQ;" in src    # work_items' order
    assert bf.grid == (min(flash_attention.SMS, 2 * 4 * 2), 1)
    c = _constants(src)
    assert (c["kStages"], c["kWGRows"]) == (bf.stages,
                                            flash_attention.WG_ROWS)
    assert c["kMapWords"] == len(flash_attention.tma_layout(
        torch.zeros(1, 1, 1, 64), 128))
    for line in ("static constexpr int kQBytes = kBQ * DP * 2;",
                 "static constexpr int kTileBytes = kBKV * DP * 2;",
                 "static constexpr int kBar = kOnes + 1024;",
                 "static constexpr int kBars = 2 + 4 * kStages;",
                 "static constexpr int kBytes = kBar + kBars * 8 + 1024;",
                 "constexpr int DP = D <= 64 ? 64 : 128;"):
        assert line in src, line
    for D in flash_attention.HEAD_DIMS:
        dp = flash_attention.padded_head_dim(D)
        q_bytes = c["kBQ"] * dp * 2
        ring = 2 * c["kStages"] * c["kBKV"] * dp * 2
        assert flash_attention.smem_bytes(D) == \
            q_bytes + ring + 1024 + (2 + 4 * c["kStages"]) * 8 + 1024


DECODE_SHAPES = [
    (16, 8, 4, 32768, 128),          # decode_32k
    (8, 8, 4, 4096, 128),            # Qwen3-4B's serving cache
    (8, 8, 6, 1024, 128),            # Grok-1's
    (8, 8, 8, 1024, 112),            # Kimi-K2's
]


@pytest.mark.parametrize("B,K,G,T,D", DECODE_SHAPES + [(2, 2, 2, 40, 16)])
def test_decode_plan_picks_the_kernel_by_dtype(B, K, G, T, D):
    bf = decode_attention.plan(B, K, G, T, D, torch.bfloat16)
    assert bf.kernel == "tensor_core" and bf.grid == (bf.split, B * K)
    assert 1 <= bf.split <= decode_attention.MAX_SPLIT
    assert bf.split <= -(-T // bf.tile) and bf.stages >= 2
    assert B * K * bf.split <= decode_attention.TC_CTAS_PER_SM * \
        decode_attention.SMS or bf.split == 1
    f32 = decode_attention.plan(B, K, G, T, D, torch.float32)
    chunk, n_chunks = decode_attention.split(B * K, T)
    assert f32.kernel == "cuda_core" and f32.tile == decode_attention.TILE
    assert f32.grid == (n_chunks, B * K) == (f32.split, B * K)
    with pytest.raises(ValueError):
        decode_attention.plan(B, K, G, T, 48, torch.bfloat16)
    with pytest.raises(ValueError):
        decode_attention.plan(B, K, G, T, D, torch.float16)
    with pytest.raises(ValueError):
        decode_attention.plan(B, K, 9, T, D, torch.bfloat16)


@pytest.mark.parametrize("B,K,G,T,D", DECODE_SHAPES)
def test_decode_device_split_covers_every_live_length(B, K, G, T, D):
    """The Python twin of the tensor-core kernel's split: for every length
    1..T the row's CTAs take [0, len) exactly, in order, without overlap,
    in whole tiles but the last, and none is idle once len >= split *
    tile."""
    p = decode_attention.plan(B, K, G, T, D, torch.bfloat16)
    for n in range(1, T + 1):
        chunks = [decode_attention.tc_chunk(r, p.split, n)
                  for r in range(p.split)]
        assert chunks[0][0] == 0 and chunks[-1][1] == n
        for (lo, hi), (lo2, _) in zip(chunks, chunks[1:]):
            assert hi == lo2 or lo == hi
        assert sum(hi - lo for lo, hi in chunks) == n
        assert all(lo % p.tile == 0 and lo <= hi for lo, hi in chunks)
        assert all(hi % p.tile == 0 or hi == n for lo, hi in chunks)
        if n >= p.split * p.tile:
            assert all(hi > lo for lo, hi in chunks)


@pytest.mark.parametrize("B,K,G,T,D", DECODE_SHAPES)
def test_decode_split_takes_every_live_key_at_ragged_lengths(B, K, G, T, D):
    """In one batch of ragged lengths (1, 63, 64, 65, T - 1 and T) each
    row's CTAs (``tc_chunk`` over the plan's split) take every live key
    exactly once, and at full length every CTA of every row streams the
    same number of 64-key tiles: at decode_32k 256 of the 512, two CTAs a
    row, 256 CTAs in all."""
    p = decode_attention.plan(B, K, G, T, D, torch.bfloat16)
    lengths = [(1, 63, 64, 65, T - 1, T)[b % 6] for b in range(B)]
    for n in lengths:
        keys = [t for r in range(p.split)
                for t in range(*decode_attention.tc_chunk(r, p.split, n))]
        assert keys == list(range(n))
    tiles = [(hi - lo) // p.tile for lo, hi in
             (decode_attention.tc_chunk(r, p.split, T)
              for r in range(p.split))]
    assert max(tiles) - min(tiles) <= 1
    if (B, K, G, T, D) == (16, 8, 4, 32768, 128):
        assert p.split == 2 and tiles == [256, 256]
        assert p.grid == (2, 128)


def test_decode_plan_matches_the_source():
    """The plan's tile, stages, warps and largest split are those of
    flash_decode_tc.cu, whose C entry launches (split, B*K) CTAs; the
    kernel and the wrapper compute the split with one formula."""
    src = (build.CSRC / "flash_decode_tc.cu").read_text()
    c = _constants(src)
    assert (c["kTile"], c["kStages"], c["kWarps"], c["kMaxSplit"],
            c["kRows"]) == (decode_attention.TC_TILE,
                            decode_attention.TC_STAGES,
                            decode_attention.TC_WARPS,
                            decode_attention.MAX_SPLIT,
                            decode_attention.MAX_GROUP)
    assert "config<D>(dim3(split, B * K), split, stream, &attr)" in src
    assert "const int tile_lo = rank * n_live / split;" in src
    assert "const int tile_hi = (rank + 1) * n_live / split;" in src
    assert "lo = rank * n_live // n_split" in \
        (KERNELS / "decode_attention.py").read_text()
    assert "cudaLaunchAttributeClusterDimension" in src


def test_bf16_decode_runs_on_the_tensor_cores():
    """The bf16 decode kernel multiplies with mma.sync on bf16 operands
    (K through ldmatrix, V through ldmatrix.trans) from a cp.async ring,
    through the shared header, and folds a row's CTAs through distributed
    shared memory in one launch; the f32 kernel stays on the CUDA cores."""
    tc = (build.CSRC / "flash_decode_tc.cu").read_text()
    assert '#include "mma_sm90.cuh"' in tc
    for call in ("mma_bf16_16816(", "ldmatrix_x4(", "ldmatrix_x4_trans(",
                 "cp_async16_l2_256(", "cp_async_wait<kStages - 2>()",
                 "map_shared_rank(", "cluster.sync()"):
        assert call in _code(tc), call
    assert _code(tc).count("<<<") == 0       # cudaLaunchKernelEx: one launch
    f32 = _code((build.CSRC / "flash_decode.cu").read_text())
    assert "mma" not in f32 and "ldmatrix" not in f32


def test_decode_wrapper_takes_no_cpu_tensor_and_no_unknown_kernel():
    """The wrapper launches a kernel or raises: a CPU tensor is refused (the
    plain version is ops.flash_decode's, not the wrapper's), and so is a
    kernel name it does not know."""
    args = (torch.zeros(1, 2, 2, 16), torch.zeros(1, 2, 8, 16),
            torch.zeros(1, 2, 8, 16), torch.tensor([3]))
    before = decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.flash_decode(*args)
    with pytest.raises(ValueError, match="kernel"):
        decode_attention.flash_decode(*args, kernel="tensor_core")
    assert decode_attention.launches == before


def test_no_try_around_the_kernels():
    for name in ("ops.py", "flash_attention.py", "decode_attention.py",
                 "build.py"):
        tree = ast.parse((KERNELS / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


# ---- the f32 kernel (csrc/flash_attention.cu): Python twins --------------

F32_SHAPES = [
    (4, 32, 8, 2048, 2048, 128),     # Qwen3-4B's prefill
    (4, 25, 5, 2048, 2048, 64),      # a full-width D = 64 shape
    (1, 32, 8, 256, 256, 128),       # the f32 checks' shapes: Qwen3-4B,
    (1, 64, 8, 256, 256, 112),       # Kimi-K2, Hymba, Whisper's encoder,
    (1, 25, 5, 1050, 1050, 64),      # decoder and cross-attention
    (1, 6, 6, 1500, 1500, 64),
    (1, 6, 6, 448, 448, 64),
    (1, 6, 6, 448, 1500, 64),
]


@pytest.mark.parametrize("block_q", flash_attention.F32_BLOCKS)
@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_f32_thread_tiles_cover_the_block_once(D, block_q):
    """The Python twin of the kernel's thread-to-element mapping: the 256
    threads' scores cover each (row, key) of a query block and key tile
    once, their outputs each (row, column) of the block once; the CTA's
    shared memory fits.  At 128 rows each thread's tiles are 8 x 8 in
    S = Q K^T and, at D = 128, in O += P V: 0.25 floats read an fmaf."""
    fa = flash_attention
    scores = [rk for t in range(fa.F32_THREADS)
              for rk in fa.f32_thread_scores(block_q, t)]
    assert sorted(scores) == [(r, k) for r in range(block_q)
                              for k in range(fa.F32_BLOCK_K)]
    outs = [rc for t in range(fa.F32_THREADS)
            for rc in fa.f32_thread_outputs(block_q, D, t)]
    assert sorted(outs) == [(r, c) for r in range(block_q)
                            for c in range(D)]
    assert fa.f32_smem_bytes(D, block_q) <= fa.SMEM_LIMIT
    rows = block_q // 16
    keys = len(fa.f32_thread_scores(block_q, 0)) // rows
    cols = -(-D // 64) * (min(D, 64) // 16)      # with the columns past D
    assert (rows + keys) / (rows * keys) == (0.25 if block_q == 128
                                             else 0.375)
    if (D, block_q) == (128, 128):
        assert (rows, keys, cols) == (8, 8, 8)
        assert fa.f32_smem_bytes(D, block_q) == 229376


def _bank_groups(addrs):
    """The 4-bank groups (16-byte slots) of float indices in shared
    memory."""
    return [(a // 4) % 8 for a in addrs]


@pytest.mark.parametrize("D", flash_attention.HEAD_DIMS)
def test_f32_shared_memory_reads_and_writes_without_conflicts(D):
    """The K panel's swizzle is a permutation of each row's 16-byte
    chunks under which the 8 keys a quarter warp reads at one step of d
    (tx .. tx + 7 of one ty, key tx + 16 j) fall on 8 distinct bank
    groups; the half-warps' P writes (step j: even rows write key
    tx + 16 j, odd rows tx + 16 (j ^ 1)) fall on 32 distinct banks."""
    fa = flash_attention
    n, width = fa.f32_panels(D)
    chunks = width // 4
    for key in range(fa.F32_BLOCK_K):
        assert sorted(c ^ fa.f32_k_swizzle(D, key)
                      for c in range(chunks)) == list(range(chunks))
    for j in range(fa.F32_BLOCK_K // 16):
        for c in range(chunks):
            for q0 in (0, 8):
                addrs = [(tx + 16 * j) * width
                         + 4 * (c ^ fa.f32_k_swizzle(D, tx + 16 * j))
                         for tx in range(q0, q0 + 8)]
                assert len(set(_bank_groups(addrs))) == 8, (j, c)
    for j in range(fa.F32_BLOCK_K // 16):
        banks = [((ty + 0) * fa.F32_BLOCK_K + tx + 16 * (j ^ (ty & 1))) % 32
                 for ty in (2, 3) for tx in range(16)]
        assert len(set(banks)) == 32


@pytest.mark.parametrize("shape", F32_SHAPES)
def test_f32_block_choice_keeps_the_sms_busy(shape):
    """plan() takes 128-row blocks only where they give every SM a CTA;
    elsewhere 64-row blocks launch as many CTAs as the 64-row kernel
    before them, so no f32 path shape runs on fewer SMs."""
    B, H, K, S, T, D = shape
    p = flash_attention.plan(B, H, S, D, torch.float32)
    ctas = p.grid[0] * p.grid[1]
    parent = -(-S // 64) * B * H
    assert ctas >= min(parent, flash_attention.SMS)
    assert ctas >= parent or ctas >= flash_attention.SMS
    assert p.block_q == (128 if -(-S // 128) * B * H >= flash_attention.SMS
                         else 64)


def _emulate_f32(q, k, v, causal, window, block_q):
    """The f32 kernel's schedule and arithmetic in numpy, one CTA at a
    time: shared memory as flat arrays filled with NaN, Q and the ring's
    panels stored as the kernel stores them (K swizzled, zero past T and
    D), each panel issued, committed, waited for and read in the kernel's
    order (a panel read from a slot that holds another, or before its
    group was waited for, fails), S and P V in the threads' tiles, P
    written by the half-warps' alternation, row sums reduced at the
    end."""
    fa = flash_attention
    BK, NT, SLOTS, PANEL = (fa.F32_BLOCK_K, fa.F32_THREADS, fa.F32_SLOTS,
                            fa.F32_PANEL)
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    NP, W = fa.f32_panels(D)
    VW, TM, KJ = W // 16, block_q // 16, BK // 16
    scale2 = np.float32(np.float32(D ** -0.5) * np.float32(1.4426950408889634))
    tid = np.arange(NT)
    tx, ty = tid % 16, tid // 16
    rows = ty[:, None] + 16 * np.arange(TM)[None, :]
    keys = tx[:, None] + 16 * np.arange(KJ)[None, :]
    sw = np.array([fa.f32_k_swizzle(D, int(x)) for x in tx])
    o = np.full(q.shape, np.nan, np.float32)
    n_qb = -(-S // block_q)
    for bh in range(B * H):
        b, h = divmod(bh, H)
        kvh = h // (H // K)
        for qb in reversed(range(n_qb)):
            q0 = qb * block_q
            Qs = np.zeros((block_q, D), np.float32)
            Qs[:min(block_q, S - q0)] = q[b, h, q0:q0 + block_q]
            Ps = np.full(block_q * BK, np.nan, np.float32)
            ring = np.full((SLOTS, BK * W), np.nan, np.float32)
            held, groups, pending, done = [None] * SLOTS, [], [], set()
            k_lo = max(0, q0 - window + 1) // BK * BK if window > 0 else 0
            k_hi = min(T, q0 + block_q, S) if causal else T
            n_tiles = -(-(k_hi - k_lo) // BK) if k_hi > k_lo else 0

            def issue(n):
                t, w = divmod(n, 2 * NP)
                if t >= n_tiles:
                    return
                is_v, col0 = w >= NP, (w % NP) * PANEL
                src = (v if is_v else k)[b, kvh]
                k0 = k_lo + t * BK
                slot = np.full((BK, W), np.nan, np.float32)
                for key in range(BK):
                    for c in range(W // 4):
                        ok = k0 + key < T and col0 + 4 * c < D
                        phys = c if is_v else c ^ fa.f32_k_swizzle(D, key)
                        slot[key, 4 * phys:4 * phys + 4] = \
                            src[k0 + key, col0 + 4 * c:col0 + 4 * c + 4] \
                            if ok else 0
                ring[n % SLOTS] = slot.reshape(-1)
                held[n % SLOTS] = n
                pending.append(n)

            def commit():
                groups.append(list(pending))
                pending.clear()

            def wait(n_pending):
                for g in groups[:len(groups) - n_pending]:
                    done.update(g)

            def read(n):
                assert held[n % SLOTS] == n and n in done, n
                return ring[n % SLOTS]

            def qk(s, p, n):
                panel = read(n)
                for c in range(min(W, D - p * PANEL) // 4):
                    for e in range(4):
                        kv = panel[keys * W + ((c ^ sw) * 4)[:, None] + e]
                        qv = Qs.reshape(-1)[rows * D + p * PANEL + 4 * c + e]
                        s += qv[:, :, None] * kv[:, None, :]

            issue(0)
            commit()
            if NP == 1:
                issue(1)
                commit()
            m = np.full((NT, TM), -1e30, np.float32)
            l = np.zeros((NT, TM), np.float32)
            acc = np.zeros((NT, TM, NP * VW), np.float32)
            for t in range(n_tiles):
                k0, n0 = k_lo + t * BK, t * 2 * NP
                s = np.zeros((NT, TM, KJ), np.float32)
                if NP == 2:
                    wait(0)
                    issue(n0 + 1)
                    commit()
                    issue(n0 + 2)
                    commit()
                    qk(s, 0, n0)
                    wait(1)
                    issue(n0 + 3)
                    commit()
                    qk(s, 1, n0 + 1)
                else:
                    wait(1)
                    issue(n0 + 2)
                    commit()
                    qk(s, 0, n0)
                x = s * scale2
                qpos = (q0 + rows)[:, :, None]
                kpos = (k0 + keys)[:, None, :]
                ok = (kpos < T) & (qpos >= 0)
                if causal:
                    ok &= qpos >= kpos
                if window > 0:
                    ok &= (qpos - kpos) < window
                x = np.where(ok, x, np.float32(-1e30))
                mx = x.max(-1).reshape(16, 16, TM).max(1)    # the row's 16
                m_new = np.maximum(m, np.repeat(mx, 16, 0))
                corr = np.exp2(m - m_new)
                m = m_new
                p = np.exp2(x - m_new[:, :, None])
                l = l * corr + p.sum(-1)
                acc *= corr[:, :, None]
                odd = ty & 1
                for i in range(TM):
                    for j in range(KJ):
                        Ps[(ty + 16 * i) * BK + tx + 16 * (j ^ odd)] = \
                            p[tid, i, j ^ odd]
                wait(0 if NP == 2 else 1)
                issue(n0 + (4 if NP == 2 else 3))
                commit()
                vs = [read(n0 + NP + w) for w in range(NP)]
                for key in range(BK):
                    pv = Ps[rows * BK + key]
                    vv = np.concatenate(
                        [vp[key * W + tx[:, None] * VW + np.arange(VW)]
                         for vp in vs], 1)
                    acc += pv[:, :, None] * vv[:, None, :]
            den = np.maximum(np.repeat(l.reshape(16, 16, TM).sum(1), 16, 0),
                             np.float32(1e-30))
            for t in range(NT):
                for r, col in flash_attention.f32_thread_outputs(block_q, D,
                                                                 t):
                    if q0 + r < S:
                        w, e = divmod(col, PANEL)
                        o[b, h, q0 + r, col] = \
                            acc[t, (r - ty[t]) // 16, w * VW + e - tx[t] * VW] \
                            / den[t, (r - ty[t]) // 16]
    return o


@pytest.mark.parametrize("block_q", flash_attention.F32_BLOCKS)
@pytest.mark.parametrize("shape,causal,window", [
    ((1, 2, 1, 129, 129, 128), True, 0),     # past one 128-row block
    ((1, 2, 1, 200, 200, 112), True, 100),   # a window across a key tile
    ((1, 1, 1, 300, 300, 32), True, 100),    # three key tiles, skipped ones
    ((1, 2, 1, 127, 127, 16), True, 0),
    ((1, 2, 2, 130, 1, 64), False, 0),       # one key for 130 queries
    ((1, 2, 2, 37, 100, 64), False, 0),      # cross-attention, S < T
])
def test_f32_kernel_twin_matches_the_plain_version(shape, causal, window,
                                                   block_q):
    """The kernel's data flow, emulated (``_emulate_f32``), equals the
    plain version within the f32 tolerance: every value it reads was
    stored where it reads it, in time."""
    B, H, K, S, T, D = shape
    rng = np.random.default_rng(29)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, S, D), (B, K, T, D), (B, K, T, D)))
    want = ref.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal, window=window).numpy()
    got = _emulate_f32(q, k, v, causal, window, block_q)
    np.testing.assert_allclose(got, want, **_tol("f32"))
