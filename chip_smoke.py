"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: builds the port's CUDA kernels, holds each against its plain PyTorch
version, drives the image lane (and its arena bench), the dense Qwen3-4B
serving path, the Grok-1 and Kimi-K2 MoE serving paths, the Qwen3-4B
training path and the 1000-host multi-host loader end to end, and times
the kernels.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the kernels from ``src/repro_torch/kernels/csrc/*.cu``, one
     ``nvcc`` per source, all started together;
  3. crop kernel == plain version on the card: edge values, clamped
     offsets, mirror, ragged sizes, a full-frame crop and the main-path
     shape (max|diff| == 0 in f32, <= 1 ulp in bf16);
  4. the image lane: store -> cluster -> pool -> OOO prefetcher -> arena ->
     ImageFeed -> kernel at B=512, 256x256x3 -> 224x224 on route high,
     through ``bench_torch_wirefmt.compare_paths``: every batch checked
     against the same run on the materialize path, the kernel's launches
     against the batches formed, and the bench's checks (host prep <= 0.5x
     the materialize path, slab reuse);
  5. the crop kernel's time per launch (CUDA events around back-to-back
     launches), the host's time per call, the plain version's time and the
     bound;
  A. the image lane's arena bench on the card: ``bench_torch_wirefmt``'s
     arena section at its full sizes (B=64, 64x64x3 -> 56x56, 24 batches
     on each path, through ``ImageFeed``): its three checks (tensors within
     1e-5 of the materialize path, host prep <= 0.5x the materialize path,
     slab reuse) and the crop kernel's launches equal to the arena batches
     formed; prints both paths' host prep ms per batch, their ratio, the
     max difference and its own launches (the kernels line counts phase
     4's);
  6. flash attention and flash decode == their plain versions on the card
     (the reference's kernel sweeps with head dim 112 added, 2e-5 in f32,
     2e-2 in bf16; every serving path's shapes, Kimi-K2's at head dim 112
     included, 2e-5 in f32, and in bf16 2**-6 rtol plus 2**-5 of each
     output row's RMS; bf16 decode also at the engine's live length and at
     ragged lengths that hit each tile and split boundary);
  7. the serving path at full width: Qwen3-4B (36 layers, bf16, seeded
     random weights), prompts fetched over the simulated WAN by
     ``build_stack``, a 4 x 2048 prefill and continuous-batching decode of
     16 prompts, with the kernels' launches counted;
  8. the same path in f32 at 2 layers on the card and on the CPU (the
     kernels' plain versions): prefill and decode logits within 1e-3;
  9. the attention kernels' times at every bf16 path shape (Qwen3-4B's,
     Grok-1's and Kimi-K2's) against their bounds, plain versions and
     ``scaled_dot_product_attention``; flash decode also at the engine's
     live lengths, and beside the CUDA-core decode kernel in bf16;
 10. grouped matmul == its plain version on the card: the reference's
     sweep, ragged and unaligned edges and strided views (f32 1e-4; bf16
     5e-2 rtol / 5e-1 atol), and every shape of the Grok-1 and Kimi-K2
     MoE paths, and two prefill chunks off them (bf16 within two ulps,
     2**-6 rtol / 1e-3 atol; f32 1e-4);
 11. the MoE serving path at full width: Grok-1 (4 of its 64 layers, bf16,
     seeded random weights), prompts fetched over the simulated WAN, a
     2 x 2048 prefill and continuous-batching decode of 16 prompts, with
     the kernels' launches counted (the Qwen3-4B phases' tensors are freed
     first);
 12. the same path in f32 at 2 layers and d_ff 2048 on the card and on the
     CPU: prefill and decode logits within 1e-3;
 13. Kimi-K2 serving at full width (1 of its 61 layers, head dim 112, 384
     experts, bf16, seeded random weights; Grok-1's tensors freed first):
     a 2 x 2048 prefill and continuous-batching decode of 8 prompts, with
     the kernels' launches counted, then the same path in f32 at d_ff 256
     on the card and on the CPU (logits within 1e-3);
 14. the training path at full width and depth: Qwen3-4B (36 layers,
     bf16, remat, seeded random weights; Kimi-K2's tensors freed first),
     token records fetched over the simulated WAN by ``build_stack``'s
     DeviceFeed, 8 steps of ``run_training`` (AdamW) at 2 x 4096 tokens,
     with ms per step, tokens/s, peak memory, each step's loss and grad
     norm, stall and goodput, and a derived share of the bf16 peak; it
     raises on a loss or norm that is not finite, unchanged parameters,
     missing steps or any kernel launch (training runs none);
 15. the train step in f32 at 2 layers, full width, 1 x 256 tokens, on
     the card and on the CPU from one state: the first step's gradients
     and 3 steps' losses within 1e-3; then a restart from a checkpoint on
     the card (the quickstart config) against the run without a stop;
 16. the grouped matmul's times at the Grok-1 and Kimi-K2 decode and
     prefill shapes, and at the two chunks off the path, against its
     bound, plain version and ``torch.bmm``;
  B. the multi-host path on the card's host: ``bench_torch_multihost``'s
     ``--scale --quick`` cell (1,000 hosts over three federated clusters on
     routes local, med and high, through the port's ``MultiHostRun``), its
     virtual-clock metrics, ``events_total`` included, equal to
     ``benchmarks/baselines/multihost_scale.json``; its wall-clock checks
     (the CI budget, the events/sec floor) are printed and not judged,
     since they time the host;
 17. one JSON line of kernels, then the result line.

Needs a CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from benchmarks import bench_torch_multihost  # noqa: E402
from benchmarks import bench_torch_wirefmt, torch_gate  # noqa: E402
from repro_torch.configs.base import ArchConfig, get_arch  # noqa: E402
from repro_torch.core import KVStore, LoaderConfig, build_stack  # noqa: E402
from repro_torch.data.datasets import (SyntheticPixelDataset,  # noqa: E402
                                       SyntheticTokenDataset, ingest)
from repro_torch.kernels import build as _build  # noqa: E402
from repro_torch.kernels import (crop_norm, decode_attention,  # noqa: E402
                                 flash_attention, grouped_matmul, ops, ref)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.moe import n_chunks  # noqa: E402
from repro_torch.models.params import (count_params, tree_leaves,  # noqa: E402
                                      tree_map)
from repro_torch.serve import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_state, make_prefill_step, make_train_step)

# The main path: LoaderConfig's default batch, 256x256x3 uint8 frames,
# 224x224 crops.
B, H, W, C, OH, OW = 512, 256, 256, 3, 224, 224
N_SAMPLES = 4096
N_BATCHES = 6
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
# Device-memory rate, non-tensor-core f32 rate and dense bf16 tensor-core
# rate from NVIDIA's H100 SXM data sheet; any other card's bound is
# reported as unknown.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_flops": 67e12,
                                   "bf16_flops": 989.4e12}}
SOURCE = "src/repro_torch/kernels/csrc/crop_norm.cu"
REPLACES = "src/repro/kernels/crop_norm.py:38"
# name -> (module, source of the kernel the main path runs (bf16 where a
# kernel has an f32 and a bf16 variant), the TPU kernel it replaces)
KERNELS = {
    "crop_mirror_normalize": (crop_norm, SOURCE, REPLACES),
    "flash_attention": (flash_attention,
                        "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                        "src/repro/kernels/flash_attention.py:79"),
    "flash_decode": (decode_attention,
                     "src/repro_torch/kernels/csrc/flash_decode_tc.cu",
                     "src/repro/kernels/decode_attention.py:60"),
    "grouped_matmul": (grouped_matmul,
                       "src/repro_torch/kernels/csrc/grouped_matmul_tc.cu",
                       "src/repro/kernels/moe_gmm.py:36"),
}

# The serving path: Qwen3-4B at full width, prompts of 128 tokens, a
# 4 x 2048 prefill, 8 slots over a 4096-token cache, 32 new tokens each.
ARCH = "qwen3_4b"
N_PROMPTS, PROMPT_LEN = 16, 128
PREFILL_B, PREFILL_S = 4, 2048
SLOTS, MAX_SEQ, NEW_TOKENS = 8, 4096, 32
N_PREFILL = 3
# The f32 check against the CPU: 2 layers, a 1 x 256 prefill, 8 steps.
CHECK_LAYERS, CHECK_PREFILL, CHECK_STEPS, CHECK_MAX_SEQ = 2, 256, 8, 256
CHECK_TOL = 1e-3
# Kimi-K2's serving path (phase 13): 1 of 61 layers at full width, 8
# prompts of 64 tokens, a 2 x 2048 prefill, 8 slots over a 1024-token
# cache, 16 new tokens each; its f32 check cuts d_ff to 256.
KIMI_ARCH, KIMI_LAYERS = "kimi_k2_1t_a32b", 1
KIMI_SERVE = dict(n_prompts=8, prompt_len=64, prefill_b=2, prefill_s=2048,
                  slots=8, max_seq=1024, new_tokens=16, n_prefill=2)
KIMI_CHECK_D_FF = 256
# Kernel sweeps: the reference's (tests/test_kernels.py:17-62) with head
# dim 112 added, and the serving paths' own shapes: Qwen3-4B's, Grok-1's
# (48 query heads over 8 kv heads) and Kimi-K2's (64 over 8 at head dim
# 112).  Attention (B,H,K,S,D); decode (B,K,G,T,D).
FLASH_CASES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 2, 96, 32),
               (1, 2, 1, 128, 128), (2, 4, 2, 100, 16), (1, 8, 2, 200, 112)]
FLASH_WINDOWS = (0, 16, 100)
FLASH_PATH_CASES = [((PREFILL_B, 32, 8, PREFILL_S, 128), torch.bfloat16),
                    ((1, 32, 8, CHECK_PREFILL, 128), torch.float32),
                    ((2, 48, 8, 2048, 128), torch.bfloat16),
                    ((2, 64, 8, 2048, 112), torch.bfloat16),
                    ((1, 64, 8, CHECK_PREFILL, 112), torch.float32)]
DECODE_CASES = [(2, 2, 2, 256, 64), (1, 4, 1, 100, 32), (3, 1, 8, 512, 128),
                (2, 2, 2, 40, 16), (2, 8, 8, 300, 112)]
DECODE_PATH_CASES = [((SLOTS, 8, 4, MAX_SEQ, 128), torch.bfloat16),
                     ((SLOTS, 8, 4, CHECK_MAX_SEQ, 128), torch.float32),
                     ((8, 8, 6, 1024, 128), torch.bfloat16),
                     ((8, 8, 8, 1024, 112), torch.bfloat16),
                     ((8, 8, 8, CHECK_MAX_SEQ, 112), torch.float32)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 at the path shapes, for both attention kernels: |diff| <= rtol *
# |want| + share * (RMS of want's row over D), as (rtol, share).  TOL's
# 2e-2 is the reference's limit for its sweeps, but at S = 2048 a late
# row's outputs spread only about sqrt(e / i) for row i, some 0.03 to 0.05,
# so 2e-2 would pass a kernel that left one mma's 8 keys out of a late
# row (tests/test_torch_chip_smoke.py emulates both).  The tensor-core
# kernel rounds each softmax weight to bf16, an error of at most 2**-8 of
# each term with random signs, so its error follows the row's spread, not
# each element's size: 2**-5 of the row's RMS is about 1.1e-3 to 1.6e-3
# at a late row and about 0.03 at the first rows, which average few keys.
FLASH_PATH_TOL = (2 ** -6, 2 ** -5)
# Timed shapes (phase 9): every bf16 path shape, (name, shape).
# Attention (B,H,K,S,D); decode (B,K,G,T,D), at decode_32k's context and
# at each serving path's cache.
TIME_PREFILL = (PREFILL_B, 32, 8, PREFILL_S, 128)
TIME_DECODE = (16, 8, 4, 32768, 128)
TIME_ATTENTION = [("flash_attention", TIME_PREFILL),
                  ("flash_attention grok", (2, 48, 8, 2048, 128)),
                  ("flash_attention kimi", (2, 64, 8, 2048, 112))]
TIME_DECODES = [("flash_decode", TIME_DECODE),
                ("flash_decode serving", (SLOTS, 8, 4, MAX_SEQ, 128)),
                ("flash_decode grok", (8, 8, 6, 1024, 128)),
                ("flash_decode kimi", (8, 8, 8, 1024, 112))]
# The live length of each serving path's cache half way through its engine
# run (models/attention.py passes min(pos + 1, T) to every slot, pos one
# shared count of the steps: 318 steps for Qwen3-4B, 158 for Grok-1, 79
# for Kimi-K2): checked in phase 6 and timed in phase 9 beside the full
# cache.
DECODE_LIVE = {(SLOTS, 8, 4, MAX_SEQ, 128): 160, (8, 8, 6, 1024, 128): 80,
               (8, 8, 8, 1024, 112): 40}

# The MoE serving path: Grok-1 at full width (d_model 6144, 48 query heads
# over 8 KV heads, d_ff 32768, 8 experts, top-2, vocab 131072), 4 of its 64
# layers (41 GB of bf16 parameters; 64 would not fit the card); prompts of
# 64 tokens, a 2 x 2048 prefill, 8 slots over a 1024-token cache, 16 new
# tokens each.  The f32 check cuts d_ff to 2048 as well, so that the CPU
# side holds about 7 GB.
MOE_ARCH, MOE_LAYERS = "grok_1_314b", 4
MOE_SERVE = dict(n_prompts=16, prompt_len=64, prefill_b=2, prefill_s=2048,
                 slots=8, max_seq=1024, new_tokens=16, n_prefill=2)
MOE_CHECK_D_FF = 2048
# Grouped-matmul cases (E, C, d, f): the reference's sweep
# (tests/test_kernels.py:131-135), edges (C = 1, d and f off the tiles, rows
# not 16-byte aligned), and every shape the path gives the kernel: decode
# (8 slots x C=1 rows per expert), a 512-token prefill chunk of the 2 x 2048
# batch (C = 160 per row), and the down projection of each; decode and the
# prefill chunk in f32 as well.
GMM_CASES = [(4, 64, 96, 64), (2, 100, 64, 48), (8, 32, 128, 128)]
GMM_EDGE_CASES = [(3, 1, 200, 72), (2, 1, 99, 37), (3, 13, 1000, 300),
                  (1, 77, 24, 129)]
GMM_DECODE = (8, 8, 6144, 32768)
GMM_DECODE_DOWN = (8, 8, 32768, 6144)
GMM_PREFILL = (8, 320, 6144, 32768)
GMM_PREFILL_DOWN = (8, 320, 32768, 6144)
# Kimi-K2's: 384 experts, d 7168, d_ff 2048, top-8; decode gives
# C = ceil(8 * 1.25 / 384) = 1 per slot, a prefill chunk
# ceil(512 * 8 * 1.25 / 384) = 14 per row, times 2 rows.
KIMI_GMM_DECODE = (384, 8, 7168, 2048)
KIMI_GMM_DECODE_DOWN = (384, 8, 2048, 7168)
KIMI_GMM_PREFILL = (384, 28, 7168, 2048)
KIMI_GMM_PREFILL_DOWN = (384, 28, 2048, 7168)
GMM_PATH_CASES = [(GMM_DECODE, torch.bfloat16),
                  (GMM_DECODE_DOWN, torch.bfloat16),
                  (GMM_PREFILL, torch.bfloat16),
                  (GMM_PREFILL_DOWN, torch.bfloat16),
                  (KIMI_GMM_DECODE, torch.bfloat16),
                  (KIMI_GMM_DECODE_DOWN, torch.bfloat16),
                  (KIMI_GMM_PREFILL, torch.bfloat16),
                  (KIMI_GMM_PREFILL_DOWN, torch.bfloat16),
                  (GMM_DECODE, torch.float32), (GMM_PREFILL, torch.float32)]
# Timed: gate/up and down projections at decode and in a prefill chunk,
# with (back-to-back launches, repeats) sized to keep the phase in seconds.
TIME_GMM = [("decode", GMM_DECODE, 5, 5),
            ("decode down", GMM_DECODE_DOWN, 5, 5),
            ("prefill", GMM_PREFILL, 5, 5),
            ("prefill down", GMM_PREFILL_DOWN, 5, 5),
            ("kimi decode", KIMI_GMM_DECODE, 3, 3),
            ("kimi decode down", KIMI_GMM_DECODE_DOWN, 3, 3),
            ("kimi prefill", KIMI_GMM_PREFILL, 3, 3),
            ("kimi prefill down", KIMI_GMM_PREFILL_DOWN, 3, 3)]
# Prefill chunks of batch sizes the paths do not run, where the bf16
# kernel takes tiles of its own (grouped_matmul.plan): Grok-1 at one row
# of 2048 tokens (C = 160, one wgmma CTA of 160 rows) and Kimi-K2 at four
# rows (C = 4 x 14 = 56, the 64-row mma.sync tile).  Checked in bf16
# within GMM_PATH_TOL (phase 10) and timed (phase 16), as TIME_GMM.
GMM_OFF_PATH = [("grok prefill b1", (8, 160, 6144, 32768), 5, 5),
                ("kimi prefill b4", (384, 56, 7168, 2048), 3, 3)]
# (rtol, atol): the reference's tolerances for the sweep and the edges.
# At the path's shapes (w at the model's scale, outputs of order 1) both
# sides sum exact bf16 products in f32 and differ only in the order of the
# sums, some 1e-5; rounded to bf16 that is at most one ulp, 2**-7 of the
# value.  The bf16 limit there is two ulps: a kernel that skipped one
# 16-deep slice of d would be off by some 0.05 and fail it.
GMM_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 5e-1)}
GMM_PATH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2 ** -6, 1e-3)}

# The training path (phase 14): Qwen3-4B at full width and depth, bf16,
# remat, seeded random weights, train_4k's sequence of 4096 tokens at a
# global batch of 2 (train_4k's 256, cut by one card's memory), 8 steps of
# run_training over route high (the first is warm-up).  The f32 check
# (phase 15) runs 2 layers at full width on 1 x 256 tokens for 3 steps on
# the card and on the CPU: losses within CHECK_TOL, and the first step's
# gradients within CHECK_TOL of each leaf's max |g|; then a restart from a
# checkpoint on the card at the quickstart config.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 8
TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=2)
TRAIN_CHECK_B, TRAIN_CHECK_S, TRAIN_CHECK_STEPS = 1, 256, 3
RESTART_CFG = dict(name="quickstart-lm", family="dense", n_layers=2,
                   d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                   vocab=2048, head_dim=32, dtype="float32", remat=False)


def make_inputs(seed: int, b: int, h: int, w: int, c: int, oh: int, ow: int,
                device, *, oy=None, ox=None):
    """Seeded kernel inputs holding the pixel values 0 and 255 and both
    mirror settings."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(b, h, w, c)).astype(np.uint8)
    img[0, 0, :, :] = 0
    img[-1, -1, :, :] = 255
    img[b // 2] = 255
    if oy is None:
        oy = rng.integers(0, h - oh + 1, size=b)
    if ox is None:
        ox = rng.integers(0, w - ow + 1, size=b)
    mirror = np.arange(b) % 2
    mean = rng.uniform(90.0, 140.0, size=c)
    std = rng.uniform(40.0, 70.0, size=c)
    arrays = (img, np.asarray(oy, np.int32), np.asarray(ox, np.int32),
              mirror.astype(np.int32), mean.astype(np.float32),
              std.astype(np.float32))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def cases(device):
    """(name, inputs, out_h, out_w) for every edge case and the main path."""
    yield "edges 24x24x3->16x12", make_inputs(0, 4, 24, 24, 3, 16, 12,
                                              device), 16, 12
    yield "clamped offsets", make_inputs(
        1, 4, 16, 16, 3, 8, 8, device, oy=[100, -5, -1, 9],
        ox=[-3, 99, 8, -100]), 8, 8
    yield "ragged 61x57x3->48x40", make_inputs(2, 5, 61, 57, 3, 48, 40,
                                               device), 48, 40
    yield "ragged 61x57x1->48x40", make_inputs(3, 5, 61, 57, 1, 48, 40,
                                               device), 48, 40
    yield "full frame 32x40x3", make_inputs(
        4, 3, 32, 40, 3, 32, 40, device, oy=[0, 7, -7],
        ox=[0, 3, -3]), 32, 40
    yield f"main path {B}x{H}x{W}x{C}->{OH}x{OW}", make_inputs(
        5, B, H, W, C, OH, OW, device), OH, OW


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 units in the last place between a and b."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i + 32768), i)
    return int((ordered(a) - ordered(b)).abs().max())


def check_kernel(device) -> dict:
    """Phase 3: the kernel against its plain version on the same inputs."""
    worst = {"f32_max_abs_err": 0.0, "bf16_max_ulps": 0,
             "main_f32_max_abs_err": None}
    for name, args, oh, ow in cases(device):
        got = ops.crop_mirror_normalize(*args, out_h=oh, out_w=ow)
        want = ref.crop_mirror_normalize_reference(*args, oh, ow)
        got16 = ops.crop_mirror_normalize(*args, out_h=oh, out_w=ow,
                                          dtype=torch.bfloat16)
        want16 = ref.crop_mirror_normalize_reference(*args, oh, ow,
                                                     torch.bfloat16)
        if device.type == "cuda":
            torch.cuda.synchronize()
        b, _, _, c = args[0].shape
        if got.shape != (b, c, oh, ow) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
        err = float((got - want).abs().max())
        ulps = bf16_ulps(got16, want16)
        print(f"check {name}: f32 max|diff| {err!r}, bf16 max ulps {ulps}")
        if err != 0.0 or ulps > 1:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (f32 {err!r}, bf16 {ulps} ulps)")
        worst["f32_max_abs_err"] = max(worst["f32_max_abs_err"], err)
        worst["bf16_max_ulps"] = max(worst["bf16_max_ulps"], ulps)
        worst["main_f32_max_abs_err"] = err
    return worst


def drive_main_path(device, *, n_samples: int = N_SAMPLES, b: int = B,
                    h: int = H, w: int = W, c: int = C, oh: int = OH,
                    ow: int = OW, n_batches: int = N_BATCHES) -> dict:
    """Phase 4: the arena path (uint8 upload + kernel) next to the same run
    on the materialize path (NumPy transform + float upload), through
    ``bench_torch_wirefmt.compare_paths`` on the high route, every batch
    held against the other path's.  The kernel is warmed up first; the
    launch counts are set to 0 just before the two paths run and read just
    after.  Returns the launches, what the arena path formed, both paths'
    host prep and the bench's checks."""
    if h != w or oh != ow:
        raise ValueError("the arena bench's frames and crops are square")
    store = KVStore()
    t0 = time.perf_counter()
    ds = SyntheticPixelDataset(n_samples=n_samples, h=h, w=w, c=c, seed=0)
    uuids = ingest(store, ds)
    print(f"ingested {n_samples} frames of {h}x{w}x{c} in "
          f"{time.perf_counter() - t0:.1f} s")
    bench_torch_wirefmt.warm_up(device, b, h, oh)
    reset_launches()
    res = bench_torch_wirefmt.compare_paths(
        store, uuids, ds, device=device, batch_size=b, n_batches=n_batches,
        out_hw=oh, route="high", mean=MEAN, std=STD)
    sync(device)
    launches = launch_counts()
    m = res["modes"]
    out = {"launches": launches.pop("crop_mirror_normalize"),
           "other_launches": launches,
           "batches_formed": m["arena"]["batches_formed"],
           "arena_vs_materialize_max_abs_diff": res["max_abs_diff"],
           "images": m["arena"]["images"]}
    for name in ("arena", "materialize"):
        out[f"{name}_loader_MBps_virtual"] = m[name]["loader_MBps"]
        out[f"{name}_host_prep_ms_per_batch"] = \
            m[name]["host_prep_ms_per_batch"]
    out["host_cpu_ratio"] = res["host_cpu_ratio"]
    out["arena_stats"] = m["arena"]["arena"]
    out["checks"] = res["checks"]
    print("main path:", json.dumps(out))
    return out


def check_main_path(run: dict) -> None:
    """Phase 4's checks on the card: one kernel launch per batch formed and
    no other kernel, the arena path equal to the materialize path on every
    batch, images of the main path's shape, and the bench's checks (host
    prep <= 0.5x the materialize path, slab reuse)."""
    if run["launches"] < 1 or run["launches"] != run["batches_formed"] \
            or any(run["other_launches"].values()):
        raise AssertionError(f"kernel launched {run['launches']} times "
                             f"(others {run['other_launches']}) for "
                             f"{run['batches_formed']} batches formed")
    if run["arena_vs_materialize_max_abs_diff"] != 0.0:
        raise AssertionError("arena and materialize paths disagree: "
                             f"{run['arena_vs_materialize_max_abs_diff']!r}")
    if run["images"] != {"shape": [B, C, OH, OW], "dtype": "torch.float32"}:
        raise AssertionError(f"bad images {run['images']}")
    failed = [k for k, ok in run["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"main path checks failed: {failed}")


def drive_arena_bench(device) -> int:
    """Phase A: ``bench_torch_wirefmt``'s arena section at its full sizes
    on the card, with its checks; returns the crop kernel's launches on
    the arena path, which the bench counts itself and holds to the
    batches formed."""
    reset_launches()
    arena = bench_torch_wirefmt.run_arena_section(quick=False, device=device)
    launches = launch_counts()
    m = arena["modes"]
    print("arena bench:", json.dumps({
        "batch_size": arena["batch_size"],
        "arena_host_prep_ms_per_batch": m["arena"]["host_prep_ms_per_batch"],
        "materialize_host_prep_ms_per_batch":
            m["materialize"]["host_prep_ms_per_batch"],
        "host_cpu_ratio": arena["host_cpu_ratio"],
        "max_abs_diff": arena["max_abs_diff"],
        "crop_launches": m["arena"]["crop_launches"],
        "batches_formed": m["arena"]["batches_formed"],
        "arena_stats": m["arena"]["arena"], "checks": arena["checks"]}))
    failed = [k for k, ok in arena["checks"].items() if not ok]
    if failed:
        raise AssertionError(f"arena bench checks failed: {failed}")
    # The section's own count, plus the one launch of its warm-up.
    if launches["crop_mirror_normalize"] != m["arena"]["crop_launches"] + 1 \
            or any(n for k, n in launches.items()
                   if k != "crop_mirror_normalize"):
        raise AssertionError(f"arena bench launched {launches} for "
                             f"{m['arena']['batches_formed']} batches")
    return m["arena"]["crop_launches"]


def drive_multihost_scale() -> None:
    """Phase B: ``bench_torch_multihost``'s ``--scale --quick`` cell through
    the port's ``MultiHostRun``; its virtual-clock metrics must equal the
    committed baseline.  The wall-clock checks are printed, not judged."""
    results = bench_torch_multihost.run_scale(quick=True)
    bench_torch_multihost.print_scale(results)
    if torch_gate.finish(
            "multihost_scale.json", results, quick=True,
            reported_only=bench_torch_multihost.SCALE_WALL_CLOCK_CHECKS):
        raise AssertionError("the multi-host scale cell differs from "
                             "benchmarks/baselines/multihost_scale.json")


def median_event_ms(fn, n: int = 20, repeats: int = 20) -> float:
    """Median over ``repeats`` of the device time of ``n`` back-to-back
    calls between one pair of CUDA events, per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def median_graph_ms(fn, n: int = 20, repeats: int = 20) -> float:
    """Median over ``repeats`` of the device time per call of ``n`` calls
    captured in one CUDA graph and replayed between a pair of CUDA events:
    the device's own time, without the host's launch gaps that set
    ``median_event_ms`` for a call shorter than its host side."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def median_host_ms(fn, n: int = 20, repeats: int = 20) -> float:
    """Median host time per call to enqueue ``n`` calls (no sync inside)."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / n)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(kind: str, out_bytes_per_elem: int):
    """Least time for the main-path call on this card, from its data-sheet
    peaks: bytes (each needed input byte read once, each output written
    once) and f32 operations (a subtract and a divide per output)."""
    elems = B * C * OH * OW
    nbytes = elems * (1 + out_bytes_per_elem) + 3 * B * 4 + 2 * C * 4
    peak = PEAKS.get(kind)
    if peak is None:
        return nbytes, None, "bytes"
    bytes_ms = nbytes / peak["bytes_per_s"] * 1e3
    ops_ms = 2 * elems / peak["f32_flops"] * 1e3
    return nbytes, max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def time_kernel(device, kind: str) -> dict:
    """Phase 5, at the main-path shape."""
    args = make_inputs(11, B, H, W, C, OH, OW, device)
    out = {}
    for dtype, tag, size in ((torch.float32, "f32", 4),
                             (torch.bfloat16, "bf16", 2)):
        def kernel(dtype=dtype):
            return ops.crop_mirror_normalize(*args, out_h=OH, out_w=OW,
                                             dtype=dtype)
        nbytes, bound_ms, bound_by = bound(kind, size)
        out[tag] = {"ms": median_event_ms(kernel),
                    "host_ms_per_call": median_host_ms(kernel),
                    "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_by": bound_by}
    out["plain_ms"] = median_event_ms(
        lambda: ref.crop_mirror_normalize_reference(*args, OH, OW))
    for tag in ("f32", "bf16"):
        t = out[tag]
        frac = (f"{t['bound_ms'] / t['ms']:.3f} of the bound"
                if t["bound_ms"] else "bound unknown for this card")
        bound_txt = (f"{t['bound_ms']!r} ms" if t["bound_ms"]
                     else "unknown")
        print(f"time {tag}: kernel {t['ms']!r} ms/launch (device, "
              f"back-to-back), host {t['host_ms_per_call']!r} ms/call, "
              f"bound {bound_txt} ({t['bytes'] / 1e6:.1f} MB), {frac}")
    print(f"time plain f32: {out['plain_ms']!r} ms; library_ms: n/a (no one "
          "PyTorch call computes this function)")
    return out


def build_kernels() -> dict:
    """Phase 2: one ``nvcc`` per kernel source (a kernel with an f32 and a
    bf16 variant has two), all started together; returns the seconds each
    build took, by source."""
    sources = [src for module, _, _ in KERNELS.values()
               for src in module.SOURCES]

    def one(src):
        t0 = time.perf_counter()
        _build.build(src)
        return src.name, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources))


def reset_launches() -> None:
    for module, _, _ in KERNELS.values():
        module.launches = 0


def launch_counts() -> dict:
    return {name: module.launches for name, (module, _, _) in KERNELS.items()}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            dtype, tol=None) -> float:
    """max|got - want|; raises unless |got - want| <= atol + rtol*|want|
    everywhere (the reference tests' allclose; ``tol`` is (rtol, atol),
    by default both ``TOL[dtype]``; atol may be a tensor that broadcasts
    against ``want``).  Prints the largest share of the limit used."""
    sync(got.device)
    if got.shape != want.shape or got.dtype != dtype \
            or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output {tuple(got.shape)} "
                             f"{got.dtype}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    rtol, atol = tol or (TOL[dtype], TOL[dtype])
    limit = atol + rtol * want.float().abs()
    ok = bool((diff <= limit).all())
    share = float((diff / limit.clamp_min(1e-30)).max())
    if isinstance(atol, torch.Tensor):
        atol = f"{float(atol.min())!r} to {float(atol.max())!r}"
    print(f"check {name}: max|diff| {err!r} (rtol {rtol}, atol {atol}), "
          f"{share!r} of the limit")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max|diff| {err!r}")
    return err


def path_tol(want: torch.Tensor, dtype):
    """(rtol, atol) of an attention check at a path shape: bf16 within
    ``FLASH_PATH_TOL`` of each row's RMS, f32 within ``TOL``."""
    if dtype != torch.bfloat16:
        return TOL[dtype], TOL[dtype]
    rtol, share = FLASH_PATH_TOL
    return rtol, share * want.float().pow(2).mean(-1, keepdim=True).sqrt()


def ragged_lengths(B: int, K: int, G: int, T: int, D: int) -> list:
    """B lengths of one batch that hit the bf16 decode kernel's tile and
    split boundaries (``decode_attention.plan``): 1, tile - 1, tile,
    tile + 1, split * tile, split * tile + 1, T - 1 and T, in turn."""
    p = decode_attention.plan(B, K, G, T, D, torch.bfloat16)
    edges = [1, p.tile - 1, p.tile, p.tile + 1, p.split * p.tile,
             p.split * p.tile + 1, T - 1, T]
    return [min(max(edges[i % len(edges)], 1), T) for i in range(B)]


def check_attention(device) -> dict:
    """Phase 6: flash attention and flash decode against their plain
    versions on the same inputs.  The sweeps use contiguous tensors and
    ``TOL``; the serving path's shapes use the model's layouts ((B,S,H,D)
    activations and the (B,T,K,D) cache), which the kernels read through
    strides, and ``path_tol``.  Returns the largest max|diff| of each
    kernel at the path's shapes."""
    gen = torch.Generator(device).manual_seed(6)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    path = {"flash_attention": 0.0, "flash_decode": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, K, S, D in FLASH_CASES:
            q, k, v = (randn(s, dtype) for s in ((B, H, S, D), (B, K, S, D),
                                                  (B, K, S, D)))
            for window in FLASH_WINDOWS:
                compare(f"flash {dtype} {(B, H, K, S, D)} window {window}",
                        ops.flash_attention(q, k, v, window=window),
                        ref.mha_reference(q, k, v, window=window), dtype)
            compare(f"flash {dtype} {(B, H, K, S, D)} not causal",
                    ops.flash_attention(q, k, v, causal=False),
                    ref.mha_reference(q, k, v, causal=False), dtype)
        for B, K, G, T, D in DECODE_CASES:
            q, k, v = (randn(s, dtype) for s in ((B, K, G, D), (B, K, T, D),
                                                  (B, K, T, D)))
            lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                    device=device)
            compare(f"decode {dtype} {(B, K, G, T, D)}",
                    ops.flash_decode(q, k, v, lengths),
                    ref.decode_reference(q.reshape(B, K * G, D), k, v,
                                         lengths).reshape(B, K, G, D), dtype)
    for (B, H, K, S, D), dtype in FLASH_PATH_CASES:
        q = randn((B, S, H, D), dtype).transpose(1, 2)
        k, v = (randn((B, S, K, D), dtype).transpose(1, 2) for _ in "kv")
        want = ref.mha_reference(q, k, v)
        err = compare(f"flash path {dtype} {(B, H, K, S, D)}",
                      ops.flash_attention(q, k, v), want, dtype,
                      path_tol(want, dtype))
        if dtype == torch.bfloat16:
            path["flash_attention"] = max(path["flash_attention"], err)
    for (B, K, G, T, D), dtype in DECODE_PATH_CASES:
        q = randn((B, K, G, D), dtype)
        k, v = (randn((B, T, K, D), dtype).transpose(1, 2) for _ in "kv")
        runs = [(f"length {n}", [n] * B) for n in (1, T // 3, T)]
        if dtype == torch.bfloat16:
            live = DECODE_LIVE[B, K, G, T, D]
            runs += [(f"live length {live}", [live] * B),
                     ("ragged lengths", ragged_lengths(B, K, G, T, D))]
        for label, n in runs:
            lengths = torch.tensor(n, dtype=torch.int32, device=device)
            want = ref.decode_reference(q.reshape(B, K * G, D), k, v,
                                        lengths).reshape(B, K, G, D)
            err = compare(f"decode path {dtype} {(B, K, G, T, D)} {label}",
                          ops.flash_decode(q, k, v, lengths), want, dtype,
                          path_tol(want, dtype))
            if dtype == torch.bfloat16:
                path["flash_decode"] = max(path["flash_decode"], err)
    return path


def fetch_tokens(n_records: int, seq_len: int, vocab: int, batch: int,
                 device, seed: int):
    """Token records over the simulated WAN: ingest ``n_records`` records
    of ``seq_len`` tokens and pull one batch through ``build_stack``'s
    DeviceFeed on route ``high``.  Returns the (batch, seq_len) int32
    tokens on ``device`` and the loader's MB/s on the virtual clock."""
    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(
        n_samples=n_records, seq_len=seq_len, vocab=vocab, seed=seed))
    stack = build_stack(store=store, uuids=uuids, config=LoaderConfig(
        batch_size=batch, route="high", materialize=True, seed=seed),
        feed="device", seq_len=seq_len, device=device)
    try:
        tokens = next(stack.feed)[0]["tokens"]
        mbps = stack.loader.stats.throughput() / 1e6
    finally:
        stack.close()
    return tokens, mbps


def drive_serving(device, cfg, *, n_prompts: int = N_PROMPTS,
                  prompt_len: int = PROMPT_LEN, prefill_b: int = PREFILL_B,
                  prefill_s: int = PREFILL_S, slots: int = SLOTS,
                  max_seq: int = MAX_SEQ, new_tokens: int = NEW_TOKENS,
                  n_prefill: int = N_PREFILL) -> dict:
    """Phase 7: the serving path through the entry points a user calls:
    prompts fetched by the loader, ``make_prefill_step`` on a
    (prefill_b, prefill_s) batch, then ``ServingEngine.run`` on the
    prompts.  Returns the kernels' launches in this run, what it formed,
    and its times.  The prompts are returned for phase 8."""
    model = build_model(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device).manual_seed(0))
    sync(device)
    out = {"init_s": time.perf_counter() - t0}
    prompt_tokens, out["prompt_loader_MBps_virtual"] = fetch_tokens(
        4 * n_prompts, prompt_len, cfg.vocab, n_prompts, device, seed=0)
    prompts = list(prompt_tokens.cpu().numpy())
    prefill_tokens, out["prefill_loader_MBps_virtual"] = fetch_tokens(
        4 * prefill_b, prefill_s, cfg.vocab, prefill_b, device, seed=1)
    prefill = make_prefill_step(model)
    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=slots, max_seq=max_seq, max_new_tokens=new_tokens))

    reset_launches()
    times = []
    batch = {"tokens": prefill_tokens}
    for i in range(n_prefill):
        sync(device)
        t0 = time.perf_counter()
        if i < n_prefill - 1:
            logits = prefill(params, batch)
        else:              # what the prefill step wraps, keeping the aux
            with torch.no_grad():
                logits, aux = model.forward(params, prefill_tokens, batch)
        sync(device)
        times.append(time.perf_counter() - t0)
    after_prefill = launch_counts()
    if logits.shape != (prefill_b, prefill_s, cfg.vocab) \
            or logits.dtype != torch.float32 \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill: bad logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    del logits
    sync(device)
    t0 = time.perf_counter()
    reqs = engine.run(prompts)
    sync(device)
    serve_s = time.perf_counter() - t0
    counts = launch_counts()
    if model.is_moe:
        out["prefill_aux"] = {k: float(v) for k, v in aux.items()}

    n_tok = sum(len(r.out_tokens) for r in reqs)
    waves = -(-n_prompts // slots)
    want_steps = waves * (prompt_len + new_tokens - 1)
    if engine.steps != want_steps or n_tok != n_prompts * new_tokens or \
            not all(r.done and all(0 <= t < cfg.vocab for t in r.out_tokens)
                    for r in reqs):
        raise AssertionError(f"engine: {engine.steps} steps (want "
                             f"{want_steps}), {n_tok} tokens")
    out.update({
        "is_moe": model.is_moe, "after_prefill": after_prefill,
        "launches": counts,
        "prefill_calls": n_prefill, "prefill_s": prefill_s,
        "engine_steps": engine.steps,
        "tokens": n_tok, "prefill_ms_per_call": statistics.median(times) * 1e3,
        "serve_s": serve_s, "tokens_per_s": n_tok / serve_s,
        "ms_per_engine_step": serve_s / engine.steps * 1e3,
        "prefill_tokens_per_s": prefill_b * prefill_s / statistics.median(
            times),
        "first_tokens": reqs[0].out_tokens[:8]})
    if device.type == "cuda":
        out["peak_GB"] = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"serving path {cfg.name}:", json.dumps(out))
    return out, prompts


def check_serving_launches(run: dict, n_layers: int,
                           on_card: bool) -> None:
    """The kernels of the path ran: ``n_layers`` flash-attention launches
    per prefill call and ``n_layers`` flash-decode launches per engine
    step (none on the CPU), and no crop launch; for an MoE model also 3
    grouped-matmul launches per layer and MoE chunk of a prefill call and
    per layer of an engine step."""
    per = n_layers if on_card else 0
    gmm = 3 * per if run["is_moe"] else 0
    calls, steps = run["prefill_calls"], run["engine_steps"]
    want_prefill = {"crop_mirror_normalize": 0,
                    "flash_attention": per * calls, "flash_decode": 0,
                    "grouped_matmul": gmm * n_chunks(run["prefill_s"])
                    * calls}
    want = dict(want_prefill, flash_decode=per * steps,
                grouped_matmul=want_prefill["grouped_matmul"] + gmm * steps)
    if run["after_prefill"] != want_prefill or run["launches"] != want:
        raise AssertionError(f"launches {run['after_prefill']} after the "
                             f"prefill and {run['launches']} after the "
                             f"engine; want {want_prefill} and {want}")


def check_f32_path(device, cfg, prompts, *, prefill_len: int = CHECK_PREFILL,
                   n_steps: int = CHECK_STEPS, slots: int = SLOTS,
                   max_seq: int = CHECK_MAX_SEQ) -> dict:
    """Phase 8: the serving path in f32 on the same weights, once on
    ``device`` and once through the port on the CPU (the kernels' plain
    versions): logits of a 1 x prefill_len prefill and of the first
    ``n_steps`` engine steps.  TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = build_model(cfg, device=device).init(
        torch.Generator(device).manual_seed(0))
    tokens = torch.from_numpy(np.concatenate(prompts)[:prefill_len][None])
    cpu = torch.device("cpu")
    runs = []
    for dev, p in ((device, params),
                   (cpu, tree_map(lambda t: t.to(cpu), params))):
        model = build_model(cfg, device=dev)
        logits = make_prefill_step(model)(p, {"tokens": tokens.to(dev)})
        engine = ServingEngine(model, p, ServeConfig(
            batch_slots=slots, max_seq=max_seq, max_new_tokens=NEW_TOKENS))
        for prompt in prompts:
            engine.submit(prompt)
        steps = []
        for _ in range(n_steps):
            engine.step()
            steps.append(engine.last_logits.to(cpu))
        runs.append((logits.to(cpu), torch.stack(steps)))
    (card_prefill, card_steps), (cpu_prefill, cpu_steps) = runs
    out = {"prefill_max_abs_diff":
           float((card_prefill - cpu_prefill).abs().max()),
           "decode_max_abs_diff": float((card_steps - cpu_steps).abs().max())}
    print("f32 path, card vs CPU:", json.dumps(out))
    if not max(out.values()) <= CHECK_TOL:
        raise AssertionError(f"the card's f32 logits differ from the CPU "
                             f"port's by more than {CHECK_TOL}: {out}")
    return out


def causal_pairs(S: int, T: int, window: int = 0) -> int:
    """(query, key) pairs a causal (and windowed) attention keeps."""
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    return int(np.maximum(0, np.minimum(T, i + 1) - lo).sum())


def attention_bound(kind: str, B: int, H: int, K: int, S: int, T: int,
                    D: int, elsize: int):
    """Least time for a causal flash-attention call: q, k, v read once and
    o written once, against 4*D flops per kept (query, key) pair per head
    at the inputs' type's peak."""
    nbytes = elsize * D * (2 * B * H * S + 2 * B * K * T)
    flops = 4 * B * H * D * causal_pairs(S, T)
    return _bound(kind, nbytes, flops, elsize)


def decode_bound(kind: str, lengths, K: int, G: int, D: int, elsize: int):
    """Least time for a flash-decode call: the valid K and V rows, q and o
    and the lengths moved once, against 4*G*D flops per valid key and kv
    head."""
    B, L = len(lengths), int(sum(lengths))
    nbytes = elsize * (2 * K * D * L + 2 * B * K * G * D) + 4 * B
    flops = 4 * K * G * D * L
    return _bound(kind, nbytes, flops, elsize)


def _bound(kind: str, nbytes: int, flops: int, elsize: int):
    peak = PEAKS.get(kind)
    if peak is None:
        return nbytes, flops, None, "bytes"
    bytes_ms = nbytes / peak["bytes_per_s"] * 1e3
    ops_ms = flops / peak["bf16_flops" if elsize == 2 else "f32_flops"] * 1e3
    return nbytes, flops, max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def time_attention(device, kind: str) -> dict:
    """Phase 9: each attention kernel's device ms per launch, the host's ms
    per call, its plain version's ms and one PyTorch call's ms
    (``scaled_dot_product_attention``, timed only) at the timed shapes:
    ``TIME_ATTENTION`` in bf16 (and Qwen3-4B's in f32 as well) and
    ``TIME_DECODES`` in bf16, at the full cache and at ``DECODE_LIVE``'s
    live lengths.  Each decode row also times the CUDA-core decode kernel
    on the same bf16 inputs (``cuda_core_ms``), gives the tensor-core
    kernel's split and how many of its clusters the card holds at once, and
    times the kernel, the CUDA-core kernel and SDPA replayed from a CUDA
    graph as well (``*graph_ms``: device time without the host's gaps)."""
    gen = torch.Generator(device).manual_seed(9)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    out = {}
    for label, (B, H, K, S, D) in TIME_ATTENTION:
        dtypes = (torch.bfloat16, torch.float32) \
            if (B, H, K, S, D) == TIME_PREFILL else (torch.bfloat16,)
        for dtype in dtypes:
            q = randn((B, S, H, D), dtype).transpose(1, 2)
            k, v = (randn((B, S, K, D), dtype).transpose(1, 2) for _ in "kv")

            def kernel(q=q, k=k, v=v):
                return ops.flash_attention(q, k, v)

            nbytes, flops, bound_ms, bound_by = attention_bound(
                kind, B, H, K, S, S, D, q.element_size())
            out[f"{label} {dtype}"] = {
                "shape": [B, H, K, S, D],
                "ms": median_event_ms(kernel, n=5, repeats=10),
                "host_ms_per_call": median_host_ms(kernel, n=5, repeats=10),
                "plain_ms": median_event_ms(
                    lambda: ref.mha_reference(q, k, v), n=2, repeats=3),
                "library_ms": median_event_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True),
                    n=5, repeats=10),
                "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
                "bound_by": bound_by}
            del q, k, v
    dtype = torch.bfloat16
    decode_rows = [(name, shape, shape[3]) for name, shape in TIME_DECODES]
    decode_rows += [(f"{name} live {DECODE_LIVE[shape]}", shape,
                     DECODE_LIVE[shape]) for name, shape in TIME_DECODES
                    if shape in DECODE_LIVE]
    for name, (b, K, G, t, D), n in decode_rows:
        q = randn((b, K, G, D), dtype)
        k, v = (randn((b, t, K, D), dtype).transpose(1, 2) for _ in "kv")
        lengths = torch.full((b,), n, dtype=torch.int32, device=device)
        mask = (torch.arange(t, device=device)[None, :]
                < lengths[:, None])[:, None, None, :]
        q_h = q.reshape(b, K * G, 1, D)

        def kernel(q=q, k=k, v=v, lengths=lengths):
            return ops.flash_decode(q, k, v, lengths)

        def cuda_core(q=q, k=k, v=v, lengths=lengths):
            return decode_attention.flash_decode(q, k, v, lengths,
                                                 kernel="cuda_core")

        def sdpa(q_h=q_h, k=k, v=v, mask=mask):
            return F.scaled_dot_product_attention(q_h, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        nbytes, flops, bound_ms, bound_by = decode_bound(
            kind, [n] * b, K, G, D, q.element_size())
        split = decode_attention.plan(b, K, G, t, D, dtype).split
        out[name] = {
            "shape": [b, K, G, t, D], "length": n,
            "ms": median_event_ms(kernel),
            "graph_ms": median_graph_ms(kernel),
            "host_ms_per_call": median_host_ms(kernel),
            "cuda_core_ms": median_event_ms(cuda_core),
            "cuda_core_graph_ms": median_graph_ms(cuda_core),
            "plain_ms": median_event_ms(
                lambda: ref.decode_reference(q.reshape(b, K * G, D), k, v,
                                             lengths), n=3, repeats=5),
            "library_ms": median_event_ms(sdpa),
            "library_graph_ms": median_graph_ms(sdpa),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by, "split": split,
            "clusters_held": decode_attention.max_active_clusters(D, split),
            "clusters_launched": b * K}
        del q, k, v
    for name, t in out.items():
        frac = (f"{t['bound_ms'] / t['ms']:.3f} of the bound"
                if t["bound_ms"] else "bound unknown for this card")
        print(f"time {name} {t['shape']}: kernel {t['ms']!r} ms/launch, host "
              f"{t['host_ms_per_call']!r} ms/call, plain {t['plain_ms']!r} "
              f"ms, sdpa {t['library_ms']!r} ms, bound {t['bound_ms']!r} ms "
              f"({t['bound_by']}; {t['bytes'] / 1e6:.1f} MB, "
              f"{t['flops'] / 1e9:.1f} GFLOP), {frac}")
        if "cuda_core_ms" in t:
            print(f"  decode at length {t['length']}: CUDA-core kernel "
                  f"{t['cuda_core_ms']!r} ms; from a CUDA graph: kernel "
                  f"{t['graph_ms']!r} ms, CUDA-core kernel "
                  f"{t['cuda_core_graph_ms']!r} ms, sdpa "
                  f"{t['library_graph_ms']!r} ms; split {t['split']}, "
                  f"{t['clusters_launched']} clusters launched, "
                  f"{t['clusters_held']} held at once")
    return out


def check_gmm(device) -> dict:
    """Phase 10: the grouped matmul against its plain version on the same
    inputs.  The sweep and the edges draw x and w from N(0,1), as the
    reference's test does, and meet its tolerances (``GMM_TOL``); the
    path's shapes draw w at the model's scale, N(0,1)/sqrt(d), so that the
    sums are of order 1 as in the model, and meet ``GMM_PATH_TOL``.
    Returns the max|diff| at each of the path's shapes and at
    ``GMM_OFF_PATH``'s, keyed by (shape, dtype)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device).manual_seed(10)

    def randn(shape, dtype, scale=1.0):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device).mul_(scale)

    def one(name, x, w, dtype, tol=GMM_TOL):
        return compare(f"gmm {name} {dtype}", ops.grouped_matmul(x, w),
                       ref.gmm_reference(x, w), dtype, tol[dtype])

    for dtype in (torch.float32, torch.bfloat16):
        for E, C, d, f in GMM_CASES + GMM_EDGE_CASES:
            one((E, C, d, f), randn((E, C, d), dtype), randn((E, d, f), dtype),
                dtype)
        # Views the wrapper reads in place: x transposed from (C,E,d), w one
        # layer of a stacked tensor with its columns cut at 300 of 304, so
        # that 16-byte loads meet a ragged edge.
        x = randn((40, 3, 64), dtype).transpose(0, 1)
        w = randn((2, 3, 64, 304), dtype)[1, :, :, :300]
        one("strided (3, 40, 64, 300)", x, w, dtype)
    path = {}
    for (E, C, d, f), dtype in GMM_PATH_CASES + [
            (shape, torch.bfloat16) for _, shape, _, _ in GMM_OFF_PATH]:
        x = randn((E, C, d), dtype)
        w = randn((E, d, f), dtype, d ** -0.5)
        path[(E, C, d, f), dtype] = one(f"path {(E, C, d, f)}", x, w, dtype,
                                        GMM_PATH_TOL)
        del x, w
    return path


def gmm_bound(kind: str, E: int, C: int, d: int, f: int, elsize: int):
    """Least time for a grouped-matmul call: x and w read once and the
    output written once, against 2*d flops per output element at the
    inputs' type's peak."""
    nbytes = elsize * (E * C * d + E * d * f + E * C * f)
    return _bound(kind, nbytes, 2 * E * C * d * f, elsize)


def time_gmm(device, kind: str) -> dict:
    """Phase 16: the grouped matmul's device ms per launch, the host's ms
    per call, its plain version's ms and ``torch.bmm``'s ms (timed only)
    at the MoE path's shapes (``TIME_GMM``) and off it (``GMM_OFF_PATH``),
    in bf16, with w at the model's scale."""
    gen = torch.Generator(device).manual_seed(13)
    out = {}
    for name, (E, C, d, f), n, repeats in TIME_GMM + GMM_OFF_PATH:
        x = torch.randn((E, C, d), generator=gen, dtype=torch.bfloat16,
                        device=device)
        w = torch.randn((E, d, f), generator=gen, dtype=torch.bfloat16,
                        device=device).mul_(d ** -0.5)

        def kernel(x=x, w=w):
            return ops.grouped_matmul(x, w)

        nbytes, flops, bound_ms, bound_by = gmm_bound(kind, E, C, d, f, 2)
        out[name] = {
            "shape": [E, C, d, f],
            "ms": median_event_ms(kernel, n=n, repeats=repeats),
            "host_ms_per_call": median_host_ms(kernel, n=n, repeats=repeats),
            "plain_ms": median_event_ms(lambda: ref.gmm_reference(x, w),
                                        n=2, repeats=3),
            "library_ms": median_event_ms(lambda: torch.bmm(x, w), n=n,
                                          repeats=repeats),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by}
        del x, w
    for name, t in out.items():
        frac = (f"{t['bound_ms'] / t['ms']:.3f} of the bound"
                if t["bound_ms"] else "bound unknown for this card")
        print(f"time grouped_matmul {name} {t['shape']}: kernel "
              f"{t['ms']!r} ms/launch, host {t['host_ms_per_call']!r} "
              f"ms/call, plain {t['plain_ms']!r} ms, bmm "
              f"{t['library_ms']!r} ms, bound {t['bound_ms']!r} ms "
              f"({t['bound_by']}; {t['bytes'] / 1e9:.3f} GB, "
              f"{t['flops'] / 1e12:.3f} TFLOP), {frac}")
    return out


def train_flops(cfg, n_params: int, B: int, S: int) -> int:
    """Operations of one train step, derived: 6 per parameter and token
    (forward, and a backward of twice the forward) plus the causal
    attention's 4*D per kept (query, key) pair and head, three times over.
    Remat's second forward is not counted."""
    attn = 4 * B * cfg.n_heads * cfg.resolved_head_dim * causal_pairs(S, S)
    return 6 * n_params * B * S + 3 * cfg.n_layers * attn


def drive_training(device, kind: str, cfg, *, batch: int = TRAIN_B,
                   seq: int = TRAIN_S, steps: int = TRAIN_STEPS) -> dict:
    """Phase 14: the training path through the entry points a user calls:
    ``init_state``, then ``run_training`` over the simulated WAN (token
    records fetched by ``build_stack``'s DeviceFeed on route high), with
    the kernels' launches counted (training runs none: it uses the plain
    attention, as the reference trains with XLA ops).  Raises on a loss or
    gradient norm that is not finite, parameters that did not change, or
    fewer steps than asked."""
    model = build_model(cfg, device=device)
    opt_cfg = OptimizerConfig(total_steps=steps, **TRAIN_OPT)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = init_state(model, opt_cfg, torch.Generator(device).manual_seed(0))
    sync(device)
    out = {"init_s": time.perf_counter() - t0, "batch": batch, "seq": seq}
    params = state["params"]
    n_params = count_params(params)
    # Views of three weight matrices, updated in place.  (A norm scale of
    # 1.0 may not move: a bf16 parameter keeps no f32 master copy, in the
    # reference as here, and an update under half its ulp rounds away.)
    probes = {"embedding": params["embed"]["embedding"][:8].detach(),
              "wq layer 0": params["blocks"]["attn"]["wq"][0, :8].detach(),
              "w_down last layer":
                  params["blocks"]["mlp"]["w_down"][-1, :8].detach()}
    before = {k: v.clone() for k, v in probes.items()}
    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(
        n_samples=16 * batch, seq_len=seq, vocab=cfg.vocab, seed=2))
    loader_cfg = LoaderConfig(batch_size=batch, route="high",
                              materialize=True, seed=2)
    reset_launches()
    t0 = time.perf_counter()
    res = run_training(model, store, uuids, loader_cfg,
                       TrainLoopConfig(total_steps=steps, seq_len=seq,
                                       log_every=1), opt_cfg, state=state)
    sync(device)
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    ss, hist = res["step_stats"], res["history"]
    step_s = statistics.median(ss.compute_s[1:])
    flops = train_flops(cfg, n_params, batch, seq)
    peak = PEAKS.get(kind)
    out.update({
        "params": n_params, "steps": ss.steps,
        "ms_per_step": step_s * 1e3,
        "ms_per_step_all": [c * 1e3 for c in ss.compute_s],
        "tokens_per_s": batch * seq / step_s,
        "peak_GB": (torch.cuda.max_memory_allocated(device) / 1e9
                    if device.type == "cuda" else None),
        "losses": [r["loss"] for r in hist],
        "grad_norms": [r["grad_norm"] for r in hist],
        "stall_frac": res["stats"]["stall_frac"],
        "goodput_sps": res["stats"]["goodput_sps"],
        "loader_MBps_virtual": res["loader_stats"].throughput(skip=1) / 1e6,
        "flops_per_step_derived": flops,
        "bf16_peak_share_derived":
            flops / step_s / peak["bf16_flops"] if peak else None,
        "changed": {k: float((probes[k].float() - before[k].float()).abs()
                             .max()) for k in probes}})
    print("training path:", json.dumps(out))
    bad = [r for r in hist if not (np.isfinite(r["loss"])
                                   and np.isfinite(r["grad_norm"]))]
    if bad or len(hist) != steps or ss.steps != steps:
        raise AssertionError(f"training: {len(hist)} of {steps} steps "
                             f"logged, {ss.steps} run, not finite: {bad}")
    if not all(v > 0 for v in out["changed"].values()):
        raise AssertionError(f"training left parameters unchanged: "
                             f"{out['changed']}")
    if any(out["launches"].values()):
        raise AssertionError(f"training launched kernels: {out['launches']}")
    return out


def check_f32_training(device, cfg, *, batch: int = TRAIN_CHECK_B,
                       seq: int = TRAIN_CHECK_S,
                       steps: int = TRAIN_CHECK_STEPS) -> dict:
    """Phase 15: the train step in f32 on one state, once on ``device`` and
    once through the port on the CPU: the first step's gradients (each
    leaf within ``CHECK_TOL`` of its max |g|) and the loss of each of
    ``steps`` steps (within ``CHECK_TOL``).  Then a restart on the card:
    ``run_training`` to a checkpoint and on from it gives the loss curve
    of the run without a stop.  TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                              total_steps=steps)
    state = init_state(build_model(cfg, device=device), opt_cfg,
                       torch.Generator(device).manual_seed(0))
    tokens, _ = fetch_tokens(4 * batch, seq, cfg.vocab, batch, device,
                             seed=3)
    cpu = torch.device("cpu")
    runs = []
    for dev, st in ((device, state),
                    (cpu, tree_map(lambda t: t.to(cpu, copy=True), state))):
        model = build_model(cfg, device=dev)
        b = {"tokens": tokens.to(dev),
             "loss_mask": torch.ones(tokens.shape, device=dev)}
        leaves = tree_leaves(st["params"])
        for leaf in leaves:
            leaf.requires_grad_(True)
        grads = [g.to(cpu) for g in torch.autograd.grad(
            model.train_loss(st["params"], b)[0], leaves)]
        step = make_train_step(model, opt_cfg)
        losses = []
        for _ in range(steps):
            st, metrics = step(st, b)
            losses.append(float(metrics["loss"]))
        runs.append((losses, grads))
        del st, leaves
    (card_losses, card_grads), (cpu_losses, cpu_grads) = runs
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(card_grads, cpu_grads))
    out = {"card_losses": card_losses, "cpu_losses": cpu_losses,
           "loss_max_abs_diff": max(abs(a - b) for a, b in
                                    zip(card_losses, cpu_losses)),
           "grad_max_rel_diff": grad_err}
    with tempfile.TemporaryDirectory() as tmp:
        out["restart"] = check_restart(device, tmp)
    print("f32 training, card vs CPU:", json.dumps(out))
    if not (out["loss_max_abs_diff"] <= CHECK_TOL
            and grad_err <= CHECK_TOL):
        raise AssertionError(f"the card's f32 train step differs from the "
                             f"CPU port's by more than {CHECK_TOL}: {out}")
    if out["restart"]["max_abs_diff"] > CHECK_TOL:
        raise AssertionError(f"restart from a checkpoint changed the loss "
                             f"curve: {out['restart']}")
    return out


def check_restart(device, directory: str, steps: int = 8) -> dict:
    """``run_training`` for ``steps`` steps, against half of them to a
    checkpoint and the rest from it (the loader position and the state
    restored), on the quickstart config: the two loss curves."""
    store = KVStore()
    uuids = ingest(store, SyntheticTokenDataset(n_samples=512, seq_len=64,
                                                vocab=2048, seed=5))
    loader_cfg = LoaderConfig(batch_size=8, route="high", out_of_order=False,
                              materialize=True, seed=5)
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                              total_steps=steps)
    model = build_model(ArchConfig(**RESTART_CFG), device=device)

    def run(total, ckpt=None):
        res = run_training(model, store, uuids, loader_cfg,
                           TrainLoopConfig(total_steps=total, seq_len=64,
                                           log_every=1,
                                           checkpoint_every=steps // 2,
                                           checkpoint_dir=ckpt), opt_cfg)
        return [r["loss"] for r in res["history"]]

    whole = run(steps)
    resumed = run(steps // 2, directory) + run(steps, directory)
    return {"losses": whole, "resumed": resumed,
            "max_abs_diff": max(abs(a - b) for a, b in zip(whole, resumed)),
            "bit_exact": whole == resumed}


def free_card() -> None:
    """Drop what an earlier phase left cached, so that the next phase
    starts from an empty card."""
    gc.collect()
    torch.cuda.empty_cache()


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(nvidia_smi())                                       # phase 1
    for name, secs in build_kernels().items():                # phase 2
        print(f"built {name} in {secs:.1f} s")
    checks = check_kernel(device)                             # phase 3
    run = drive_main_path(device)                             # phase 4
    check_main_path(run)
    timing = time_kernel(device, kind)                        # phase 5
    drive_arena_bench(device)                                 # phase A
    attn_err = check_attention(device)                        # phase 6
    cfg = get_arch(ARCH)
    serve, prompts = drive_serving(device, cfg)               # phase 7
    check_serving_launches(serve, cfg.n_layers, on_card=True)
    torch.cuda.empty_cache()
    check_f32_path(device, cfg.scaled(n_layers=CHECK_LAYERS,  # phase 8
                                      dtype="float32"), prompts)
    attn_time = time_attention(device, kind)                  # phase 9
    free_card()
    gmm_err = check_gmm(device)                               # phase 10
    free_card()
    moe_cfg = get_arch(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    moe, moe_prompts = drive_serving(device, moe_cfg,         # phase 11
                                     **MOE_SERVE)
    check_serving_launches(moe, MOE_LAYERS, on_card=True)
    free_card()
    check_f32_path(device, moe_cfg.scaled(                    # phase 12
        n_layers=CHECK_LAYERS, d_ff=MOE_CHECK_D_FF, dtype="float32"),
        moe_prompts)
    free_card()
    kimi_cfg = get_arch(KIMI_ARCH).scaled(n_layers=KIMI_LAYERS)
    kimi, kimi_prompts = drive_serving(device, kimi_cfg,      # phase 13
                                       **KIMI_SERVE)
    check_serving_launches(kimi, KIMI_LAYERS, on_card=True)
    free_card()
    check_f32_path(device, kimi_cfg.scaled(
        d_ff=KIMI_CHECK_D_FF, dtype="float32"), kimi_prompts)
    free_card()
    drive_training(device, kind, cfg.scaled(remat=True))      # phase 14
    free_card()
    check_f32_training(device, cfg.scaled(                    # phase 15
        n_layers=CHECK_LAYERS, dtype="float32"))
    free_card()
    gmm_time = time_gmm(device, kind)                         # phase 16
    drive_multihost_scale()                                   # phase B
    f32 = timing["f32"]
    rows = {"crop_mirror_normalize": {
        "launches": run["launches"],
        "max_abs_err": checks["main_f32_max_abs_err"], "ms": f32["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": None}}
    for name, key in (("flash_attention", "flash_attention torch.bfloat16"),
                      ("flash_decode", "flash_decode")):
        t = attn_time[key]
        rows[name] = {"launches": serve["launches"][name],
                      "max_abs_err": attn_err[name], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                      "bound_by": t["bound_by"],
                      "library_ms": t["library_ms"]}
    t = gmm_time["decode"]
    rows["grouped_matmul"] = {
        "launches": moe["launches"]["grouped_matmul"],
        "max_abs_err": gmm_err[GMM_DECODE, torch.bfloat16], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
    print(json.dumps({"kernels": [                            # phase 17
        {"name": name, "route": "cuda", "source": KERNELS[name][1],
         "replaces": KERNELS[name][2], **row} for name, row in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
