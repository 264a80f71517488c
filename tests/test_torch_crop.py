"""The port's crop/mirror/normalize against the reference's.

On the CPU the port's dispatcher runs the kernel's plain PyTorch version;
it is held against ``repro.kernels.ops.crop_mirror_normalize`` (the Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and against
``repro.kernels.ref.crop_mirror_normalize_np``, at the reference's bound of
1e-6 in f32, and exact agreement is expected.  The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import build, crop_norm, ops, ref

KERNELS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels"

# name -> (B, H, W, C, out_h, out_w, oy, ox); None offsets are drawn in
# range from the case's seed.
CASES = {
    "edges": (3, 24, 24, 3, 16, 12, None, None),
    "clamped_offsets": (4, 16, 16, 3, 8, 8, [100, -5, -1, 9],
                        [-3, 99, 8, -100]),
    "ragged_c3": (5, 61, 57, 3, 48, 40, None, None),
    "ragged_c1": (5, 61, 57, 1, 48, 40, None, None),
    "full_frame": (3, 32, 40, 3, 32, 40, [0, 7, -7], [0, 3, -3]),
}


def _inputs(seed, B, H, W, C, oh, ow, oy, ox):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(B, H, W, C)).astype(np.uint8)
    img[0, 0, :, :] = 0                       # edge values of uint8
    img[0, -1, :, :] = 255
    img[1] = 255                              # a saturated frame
    if oy is None:
        oy = rng.integers(0, H - oh + 1, size=B)
    if ox is None:
        ox = rng.integers(0, W - ow + 1, size=B)
    mirror = np.arange(B) % 2                 # mirror on and off
    mean = rng.uniform(90.0, 140.0, size=C).astype(np.float32)
    std = rng.uniform(40.0, 70.0, size=C).astype(np.float32)
    return (img, np.asarray(oy, np.int32), np.asarray(ox, np.int32),
            mirror.astype(np.int32), mean, std)


def _port(arrays, oh, ow, dtype=torch.float32):
    out = ops.crop_mirror_normalize(*map(torch.from_numpy, arrays),
                                    out_h=oh, out_w=ow, dtype=dtype)
    return out.float().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_and_numpy(case):
    B, H, W, C, oh, ow, oy, ox = CASES[case]
    arrays = _inputs(sorted(CASES).index(case), B, H, W, C, oh, ow, oy, ox)
    got = _port(arrays, oh, ow)
    pallas = np.asarray(ref_ops.crop_mirror_normalize(
        *map(jnp.asarray, arrays), out_h=oh, out_w=ow))
    numpy_ref = ref_ref.crop_mirror_normalize_np(*arrays, oh, ow)
    assert got.shape == (B, C, oh, ow)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, numpy_ref, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got, pallas) and np.array_equal(got, numpy_ref)


@pytest.mark.parametrize("case", ["edges", "ragged_c1"])
def test_plain_version_bf16_matches_pallas(case):
    B, H, W, C, oh, ow, oy, ox = CASES[case]
    arrays = _inputs(7, B, H, W, C, oh, ow, oy, ox)
    got = _port(arrays, oh, ow, torch.bfloat16)
    pallas = ref_ops.crop_mirror_normalize(
        *map(jnp.asarray, arrays), out_h=oh, out_w=ow, dtype=jnp.bfloat16)
    assert np.array_equal(got, np.asarray(pallas, np.float32))


@pytest.mark.parametrize("seed", range(4))
def test_copied_numpy_transform_equals_original(seed):
    rng = np.random.default_rng(100 + seed)
    B, H, W, C = 4, 20 + seed, 18 + seed, 1 + seed % 3
    oh, ow = int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1))
    arrays = _inputs(seed, B, H, W, C, oh, ow, rng.integers(-5, H, B),
                     rng.integers(-5, W, B))
    assert np.array_equal(ref.crop_mirror_normalize_np(*arrays, oh, ow),
                          ref_ref.crop_mirror_normalize_np(*arrays, oh, ow))


def test_cuda_source_keeps_ieee_rounding():
    src = (KERNELS / "csrc" / "crop_norm.cu").read_text()
    flags = " ".join(build.NVCC_FLAGS)
    for text in (src, flags):
        assert "use_fast_math" not in text
        assert "prec-div" not in text
    assert "__fdiv_rn" in src and "__fsub_rn" in src
    assert "arch=compute_90a,code=sm_90a" in flags


class _FakeCuda(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    def plain(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ops, "crop_mirror_normalize_reference", plain)
    arrays = _inputs(0, *CASES["edges"])
    fake = [torch.from_numpy(a).as_subclass(_FakeCuda) for a in arrays]
    with pytest.raises((RuntimeError, ValueError)) as info:
        ops.crop_mirror_normalize(*fake, out_h=16, out_w=12)
    assert "plain version" not in str(info.value)
    assert crop_norm.launches == 0


def test_no_try_around_the_kernel():
    for name in ("ops.py", "crop_norm.py"):
        tree = ast.parse((KERNELS / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


BAD_ARGS = {
    "float_image": lambda a: (a[0].float(),) + a[1:],
    "rank3_image": lambda a: (a[0][0],) + a[1:],
    "int64_offsets": lambda a: (a[0], a[1].long()) + a[2:],
    "short_mirror": lambda a: a[:3] + (a[3][:1],) + a[4:],
    "wrong_mean_len": lambda a: a[:4] + (a[4][:2],) + a[5:],
    "non_contiguous": lambda a: (a[0].transpose(1, 2),) + a[1:],
    "numpy_std": lambda a: a[:5] + (a[5].numpy(),),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_inputs_are_checked(case):
    arrays = tuple(map(torch.from_numpy, _inputs(0, *CASES["edges"])))
    with pytest.raises((ValueError, TypeError)):
        ops.crop_mirror_normalize(*BAD_ARGS[case](arrays), out_h=16,
                                  out_w=12)


@pytest.mark.parametrize("oh,ow,dtype", [(25, 12, torch.float32),
                                         (16, 0, torch.float32),
                                         (16, 12, torch.float16)])
def test_crop_size_and_dtype_are_checked(oh, ow, dtype):
    arrays = tuple(map(torch.from_numpy, _inputs(0, *CASES["edges"])))
    with pytest.raises(ValueError):
        ops.crop_mirror_normalize(*arrays, out_h=oh, out_w=ow, dtype=dtype)
