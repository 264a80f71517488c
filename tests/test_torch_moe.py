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
                                    (33, 2), (320, 2)])
def test_row_tile_follows_the_rows(C, tile):
    """Decode's 8 rows per expert take the 8-row tile, so a CTA computes no
    padded rows there."""
    assert grouped_matmul.row_tile(C) == tile
    assert grouped_matmul.ROW_TILES[tile] >= min(C, 64)


def test_grouped_matmul_cuda_source():
    src = (build.CSRC / "grouped_matmul.cu").read_text()
    assert "use_fast_math" not in src + " ".join(build.NVCC_FLAGS)
    assert 'extern "C" int grouped_matmul_fwd' in src
    assert "cuda_error_string" in src and "cudaGetLastError" in src
    assert "constexpr int kBN = 128;" in src and grouped_matmul.BN == 128
    for bm in grouped_matmul.ROW_TILES:
        assert f"launch<T, {bm}," in src


def test_no_try_around_the_grouped_matmul():
    for name in ("ops.py", "grouped_matmul.py"):
        tree = ast.parse((KERNELS / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name
